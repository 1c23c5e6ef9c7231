"""Multi-process distributed execution (SURVEY.md §2.4 comm backend).

Spawns 2 OS processes that initialize the JAX distributed runtime over a
local coordinator (``parallel.bootstrap.initialize`` — the multi-process
entry point), build the same saddle-point system, and run the generic
``dist_solve`` across the 2-process CPU mesh.  Asserts convergence and
exact iteration parity with the serial kernel in each process — the psum-
fused dots and the distributed preconditioner must be mathematically
identical across process boundaries, not just across virtual devices.
"""
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow  # spawns 2 OS-level jax.distributed processes

_WORKER = textwrap.dedent("""
    import sys
    pid, nproc, port, repo = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, repo)
    from cpkrylov_tpu.parallel import bootstrap
    bootstrap.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc

    import numpy as np
    from cpkrylov_tpu import SolverOptions, solve
    from cpkrylov_tpu.parallel.solve import dist_solve

    from cpkrylov_tpu.utils.fixtures import banded_saddle_system
    sys_ = banded_saddle_system(1024, 256, bandwidth=3, with_oracle=False)
    opts = SolverOptions(atol=0.0, rtol=1e-6, itmax=400)
    mesh = bootstrap.make_mesh()
    res, x1, x2 = dist_solve(mesh, "cpminres", sys_.b, sys_.A, sys_.B,
                             sys_.C, sys_.G, opts=opts, dtype=np.float64)
    serial = solve("cpminres", sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                   opts=opts, dtype=np.float64)
    assert bool(res.solved), int(res.istatus)
    assert abs(int(res.niters) - serial.niters) <= 1, (
        int(res.niters), serial.niters)
    # x1 spans both processes; gather the remote shards before comparing.
    from jax.experimental import multihost_utils as mhu
    x1_full = np.asarray(mhu.process_allgather(x1, tiled=True))[:1024]
    rel = (np.linalg.norm(x1_full - np.asarray(serial.x1))
           / max(np.linalg.norm(np.asarray(serial.x1)), 1e-300))
    assert rel < 1e-8, rel
    print(f"[{pid}] OK iters={int(res.niters)}")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dist_solve(tmp_path):
    import pathlib

    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port), repo],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process solve timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
        assert f"[{pid}] OK" in out
