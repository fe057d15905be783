#!/usr/bin/env python3
"""Which instructions the port's kernels compiled to, on the GPU host.

    python3 scripts/torch_sass_counts.py

from the root of a checkout, on a host with the CUDA toolkit.  It builds
(or loads) the kernel library as the wrappers do (``ops/cuda/build.py``),
disassembles it with ``cuobjdump -sass`` and prints one JSON line per
kernel instance: its name and the count of each instruction class that
says which units it uses -- HMMA (mma.sync on the tensor cores), HGMMA
(wgmma), LDSM (ldmatrix), LDGSTS (cp.async), UTMALDG / UTMASTG (TMA loads
/ stores), FFMA (f32 FMA), MUFU (special-function unit: ex2 and others),
STL / LDL (local memory: register spills).  Two closing lines check the
bf16 attention kernel (``flash_attention_wgmma``: every instance has HGMMA
and UTMALDG and no HMMA) and the probes' TMA kernels
(``strided_gather_tma``, ``halo_add_tma``: every instance has UTMALDG and
UTMASTG and no STL or LDL).  Exits non-zero without cuobjdump or when a
check fails.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OPS = ("HMMA", "HGMMA", "LDSM", "LDGSTS", "UTMALDG", "UTMASTG", "FFMA", "MUFU",
       "STL", "LDL")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    for root in filter(None, (os.environ.get("CUDA_HOME"), "/usr/local/cuda")):
        cand = Path(root) / "bin" / "cuobjdump"
        if cand.exists():
            return str(cand)
    raise SystemExit("torch_sass_counts: cuobjdump not found")


def main() -> int:
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild
    tool = cuobjdump()
    lib = kbuild.build()
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    name, counts, found = None, Counter(), []

    def flush():
        if name is not None:
            found.append((name, {op: counts[op] for op in OPS}))

    for line in sass.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            flush()
            name, counts = head.group(1), Counter()
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                       line)
        if op and name is not None:
            counts[op.group(1)] += 1
    flush()
    names = demangle([n for n, _ in found])
    for readable, (_, ops) in zip(names, found):
        print(json.dumps({"kernel": readable[:160], **ops}), flush=True)
    attn = [ops for (name, ops) in found if "flash_attention_wgmma" in name]
    ok = bool(attn) and all(o["HGMMA"] > 0 and o["UTMALDG"] > 0
                            and o["HMMA"] == 0 for o in attn)
    print(json.dumps({"check": "flash_attention_wgmma", "instances": len(attn),
                      "hgmma_and_utmaldg_no_hmma": ok}), flush=True)
    tma = [ops for (name, ops) in found
           if "strided_gather_tma" in name or "halo_add_tma" in name]
    tma_ok = len(tma) == 3 and all(
        o["UTMALDG"] > 0 and o["UTMASTG"] > 0 and o["STL"] == 0
        and o["LDL"] == 0 for o in tma)
    print(json.dumps({"check": "probe_tma", "instances": len(tma),
                      "utmaldg_and_utmastg_no_stl_ldl": tma_ok}), flush=True)
    return 0 if ok and tma_ok else 1


def demangle(names):
    """C++ names through cu++filt or c++filt where either is installed."""
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    cand = Path(cuobjdump()).with_name("cu++filt")
    if cand.exists():
        tool = str(cand)
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else names


if __name__ == "__main__":
    sys.exit(main())
