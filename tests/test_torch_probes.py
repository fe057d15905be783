"""The Mosaic probes' kernels (``ops/cuda/probes.py``): their plain
versions against the ``jax.numpy`` expressions that
``scripts/probe_mosaic.py`` takes as its references (the script has no
tests; its ``want`` values are the reference), on the script's own input,
and the port's probe script end to end on the CPU.  The kernels run only
on the card (``tests/test_torch_cuda.py``)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
from bugcar_image_segmentation_tpu_torch.ops.cuda import probes

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_probe_strided as script  # noqa: E402

R, W, C = 16, 64, 128

# (probe, the JAX script's reference, the port's plain version, dtype)
CASES = [
    ("Q1", lambda x: x[0:R:2], (2, 1), jnp.float32),
    ("Q1b", lambda x: x[:, 0:W:2], (1, 2), jnp.float32),
    ("Q2", lambda x: x.reshape(R, W // 2, 2, C)[:, :, 0, :], (1, 2),
     jnp.float32),
    ("Q3", lambda x: x.reshape(R // 2, 2, W, C)[:, 0], (2, 1), jnp.float32),
    ("Q5", lambda x: x[0:R:2], (2, 1), jnp.bfloat16),
    ("Q5b", lambda x: x[:, 0:W:2], (1, 2), jnp.bfloat16),
    ("Q5c", lambda x: x[0:R:2, 0:W:2], (2, 2), jnp.bfloat16),
    ("Q5d", lambda x: jnp.asarray(x).reshape(R, W // 2, 2, C)[:, :, 0, :],
     (1, 2), jnp.bfloat16),
]


def _jax_input():
    # scripts/probe_mosaic.py:26-27
    return jnp.asarray(np.random.default_rng(0).normal(size=(R, W, C)),
                       jnp.float32)


def _np(a):
    return np.array(jnp.asarray(a, jnp.float32))


def test_script_input_is_the_jax_scripts():
    np.testing.assert_array_equal(script.probe_input("cpu").numpy(),
                                  np.asarray(_jax_input()))


@pytest.mark.parametrize("probe,want,strides,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_gather_plain_equals_jax_reference(probe, want, strides, dtype):
    x = _jax_input().astype(dtype)
    xt = torch.as_tensor(_np(x)).to(torch.float32 if dtype == jnp.float32
                                    else torch.bfloat16)
    before = dict(kcuda.LAUNCHES)
    for fn in (probes.strided_gather, probes.strided_gather_reference):
        got = fn(xt, *strides)
        assert got.is_contiguous() and got.dtype == xt.dtype
        np.testing.assert_array_equal(got.float().numpy(), _np(want(x)))
    assert kcuda.LAUNCHES == before      # CPU tensors: the plain version


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_halo_plain_equals_jax_reference(dtype):
    x = _jax_input().astype(dtype)
    # scripts/probe_mosaic.py:118-119
    padded = jnp.pad(x, ((1, 1), (1, 1), (0, 0)))
    want = padded[0:R, 0:W] + padded[2:R + 2, 2:W + 2]
    xt = torch.as_tensor(_np(x)).to(torch.float32 if dtype == jnp.float32
                                    else torch.bfloat16)
    for fn in (probes.halo_add, probes.halo_add_reference):
        got = fn(xt)
        assert got.shape == (R, W, C) and got.dtype == xt.dtype
        np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 1, 2), (17, 33, 20)])
def test_ragged_shapes_follow_slice_semantics(shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    for sr, sw in probes.STRIDES:
        got = probes.strided_gather(x, sr, sw)
        assert got.shape == probes.gathered_shape(x, sr, sw)
        np.testing.assert_array_equal(got.numpy(), x.numpy()[::sr, ::sw])
    xp = np.pad(x.numpy(), ((1, 1), (1, 1), (0, 0)))
    np.testing.assert_array_equal(
        probes.halo_add(x).numpy(),
        xp[:shape[0], :shape[1]] + xp[2:, 2:])


def test_wrappers_reject():
    with pytest.raises(ValueError, match=r"\(R, W, C\)"):
        probes.strided_gather(torch.zeros(2, 3), 2, 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        probes.halo_add(torch.zeros(2, 3, 4, dtype=torch.float16))
    assert probes.launch_key(torch.zeros(1, dtype=torch.bfloat16)) == \
        "strided_gather_bf16"


def test_probe_script_on_cpu_exits_0():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_probe_strided.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 9 and all(ln.endswith(": OK") for ln in lines)
    assert [ln.split(":")[0].split()[0] for ln in lines] == [
        "Q1", "Q1b", "Q2", "Q3", "Q5", "Q5b", "Q5c", "Q5d", "Q4"]


def test_probe_script_fails_on_a_wrong_result(monkeypatch, capsys):
    """A kernel that returns its input unchanged fails Q4, and the script
    exits 1."""
    monkeypatch.setattr(script, "PROBES", [
        (p[0], (lambda x: x) if p[0].startswith("Q4") else p[1], *p[2:])
        for p in script.PROBES])
    assert script.main(["--device", "cpu"]) == 1
    assert "Q4 shifted halo scratch: WRONG RESULT" in capsys.readouterr().out
