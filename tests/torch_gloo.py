"""Run a test file's ``worker`` in gloo processes on the CPU.

The port's parallel paths (``bugcar_image_segmentation_tpu_torch/
parallel/``) run one process per rank.  A test file that holds them
defines ``worker(mesh_args, folder, case)`` and ends with
``if __name__ == "__main__": torch_gloo.main(worker)``; its module fixture
calls :func:`run_ranks`, which starts the ranks of one or more process
groups as subprocesses of that file, waits for them, and fails with their
error output if any rank fails.  A worker computes with one intra-op
thread and writes its results under ``folder`` (e.g. ``rank{r}.npz``),
which the test then reads; importing :func:`one_thread` into the test
file gives its own process one thread too.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for the test file's own computations (a
    host whose cores six test workers share), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(test_file: str, folder: str, *groups) -> None:
    """Start the ranks of every ``(world, case)`` of ``groups`` at once
    (each its own process group of ``test_file``'s worker) and wait for
    every one; each writes under ``folder``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.dirname(os.path.abspath(test_file))] + sys.path))
    procs = []
    for world, case in groups:
        port = free_port()
        procs += [(f"{case} rank {rank}", subprocess.Popen(
            [sys.executable, os.path.abspath(test_file), str(rank),
             str(world), str(port), folder, case], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for rank in range(world)]
    errors = []
    for what, p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            _, err = p.communicate()
            errors.append(f"{what} timed out: {err[-2000:]}")
            continue
        if p.returncode:
            errors.append(f"{what} exited {p.returncode}: {err[-3000:]}")
    assert not errors, "\n".join(errors)


def main(worker) -> None:
    """A rank's entry: ``argv`` = rank, world, port, folder, case."""
    rank, world, port, folder, case = sys.argv[1:6]
    torch.set_num_threads(1)
    mesh_args = dict(n_devices=int(world), rank=int(rank), device="cpu",
                     init_method=f"tcp://localhost:{port}",
                     timeout_s=TIMEOUT_S / 2)
    worker(mesh_args, folder, case)
