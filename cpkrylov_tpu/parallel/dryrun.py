"""Multi-chip dry run: distributed CP solves over an n-device mesh, checked
for CONVERGENCE and serial iteration parity (not just finiteness).

Used by the graft driver (with ``xla_force_host_platform_device_count``) to
validate that the row-partitioned sharding compiles, executes, and produces
the same numerics as the serial kernels without N real chips.  Covers both
distributed paths:

* ``dist_cpminres`` — the hand-fused flagship Lanczos path,
* ``dist_solve``   — the generic six-kernel shard_map driver (exercised
  here with CPMINRES and the Arnoldi-side CPGMRES).

Each run asserts ``solved`` and that the iteration count matches the serial
kernel exactly (the distributed preconditioner and psum-fused dots are
mathematically identical, so any drift indicates a sharding bug).
"""
from __future__ import annotations

import os

import numpy as np


def _configure_backend(n_devices: int) -> None:
    """Force the CPU backend with >= n_devices virtual devices and x64.

    The dryrun is *defined* as a virtual-CPU validation of the multi-chip
    sharding (module docstring), and its convergence/parity contract assumes
    f64 numerics; with x64 off the whole run would silently happen in f32 and
    the serial convergence leg trips the indefiniteness guard.
    Self-configuring here — env vars before jax backend init, config updates
    after — makes the gate independent of the caller's environment.  The env
    writes only help when the backend is not yet initialized (the driver
    invokes this in a fresh process); the config updates work either way.
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_ENABLE_X64"] = "true"

    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:  # already pinned by the environment — fine
        pass
    jax.config.update("jax_enable_x64", True)


def run_dryrun(n_devices: int) -> None:
    _configure_backend(n_devices)

    import jax
    from jax.sharding import Mesh

    devices = [d for d in jax.devices() if d.platform == "cpu"][:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(
            f"need {n_devices} CPU devices, found {len(devices)} "
            "(backend initialized before run_dryrun could configure it?)")

    from ..config import SolverOptions
    from ..driver import solve
    from ..precond.cp import make_preconditioner
    from ..utils.fixtures import banded_saddle_system
    from .cpminres import dist_cpminres
    from .partition import partition_blocks, shard_vector, unshard_vector
    from .solve import dist_solve

    dtype = np.dtype(jax.dtypes.canonicalize_dtype(np.float64))
    assert dtype == np.float64, (
        "dryrun requires f64 numerics (its convergence tolerances assume "
        f"them) but the canonical dtype resolved to {dtype}")
    rtol = 1e-6
    drift_tol = 1e-6   # serial-vs-distributed solution drift at f64

    # A few-thousand-row banded system: large enough that the row shards,
    # halo exchange, and the distributed Schur preconditioner all engage,
    # small enough to keep the virtual-device run under a minute.
    n, m = 2048, 512
    sys_ = banded_saddle_system(n, m, bandwidth=3, with_oracle=False)
    mesh = Mesh(np.array(devices), ("rows",))
    opts = SolverOptions(atol=0.0, rtol=rtol, itmax=400)

    # --- flagship hand-fused path: dist_cpminres on the b2=0 system -------
    b1 = sys_.b[:n].astype(dtype)
    b0 = np.concatenate([b1, np.zeros(m)])
    serial = solve("cpminres", b0, sys_.A, sys_.B, sys_.C, sys_.G,
                   opts=opts, dtype=dtype)
    assert serial.solved, (
        f"serial cpminres failed on the dryrun system (istatus="
        f"{serial.istatus})")

    M = make_preconditioner(sys_.G, sys_.B, sys_.C, dtype=dtype)
    blocks = partition_blocks(sys_.A, sys_.B, sys_.C, n_devices, dtype=dtype)
    b_sh = shard_vector(b1, n_devices, blocks.n_loc)
    x_sh, y_sh, k, resid, hist = jax.jit(
        lambda b: dist_cpminres(mesh, blocks, M, b, opts)
    )(b_sh)
    x = np.asarray(unshard_vector(x_sh, n))
    assert np.isfinite(x).all(), "distributed solve produced non-finite x"
    k = int(k)
    assert abs(k - serial.niters) <= 1, (
        f"dist_cpminres iteration drift: {k} vs serial {serial.niters}")
    rel_err = (np.linalg.norm(x - np.asarray(serial.x1))
               / max(np.linalg.norm(np.asarray(serial.x1)), 1e-300))
    assert rel_err < drift_tol, \
        f"dist_cpminres solution drift: rel_err={rel_err}"

    # --- distributed mixed precision: f32 sharded inner + f64 outer ------
    # (BASELINE.json configs[4] semantics; exercises dist_solve in f32 on
    # the mesh and the host true-residual refinement around it.)
    from .mixed import dist_solve_mixed

    mopts_mixed = SolverOptions(atol=0.0, rtol=1e-6, itmax=400)
    mixed_out = dist_solve_mixed(mesh, "cpminres", sys_.b, sys_.A, sys_.B,
                                 sys_.C, sys_.G, opts=mopts_mixed)
    assert mixed_out.solved, (
        f"dist mixed solve did not reach rtol=1e-6 "
        f"(nouter={mixed_out.nouter}, hist={mixed_out.resid_history})")
    assert mixed_out.resid_history[-1] <= 1e-6 * mixed_out.resid_history[0]

    # --- fully-sharded reference-parity preconditioner (round 5) ---------
    # The examples' canonical configuration (residual_update + nitref=1 +
    # force_itref, cpk_exprog1.m:87-92) through the Schur-sharded factor
    # with row-partitioned K_P blocks: GHN caches live sharded and no O(N)
    # all-gather runs inside the loop (benchmarks/sharded_precond_evidence.py).
    from ..config import PrecondOptions
    from .schur import plan_schur_precond

    popts_ref = PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    sysb = banded_saddle_system(n, m, bandwidth=3, with_oracle=False,
                                b_mode="slope", g_mode="banded")
    Ms = plan_schur_precond(sysb.G, sysb.B, sysb.C, n_devices,
                            options=popts_ref, panel=16, dtype=dtype)
    assert Ms.factor.has_shard_plan, "schur shard plan missing"
    sref_ghn = solve("cpminres", sysb.b, sysb.A, sysb.B, sysb.C, sysb.G,
                     opts=opts, precond_opts=popts_ref, panel=16,
                     dtype=dtype)
    res_g, x1_g, _ = dist_solve(mesh, "cpminres", sysb.b, sysb.A, sysb.B,
                                sysb.C, sysb.G, opts=opts, M=Ms,
                                dtype=dtype)
    assert bool(res_g.solved), "sharded GHN+itref dist_solve not converged"
    assert abs(int(res_g.niters) - sref_ghn.niters) <= 1, (
        f"sharded GHN+itref iteration drift: {int(res_g.niters)} vs "
        f"serial {sref_ghn.niters}")
    rel_g = (np.linalg.norm(np.asarray(x1_g) - np.asarray(sref_ghn.x1))
             / max(np.linalg.norm(np.asarray(sref_ghn.x1)), 1e-300))
    assert rel_g < 1e-4, f"sharded GHN+itref solution drift: {rel_g}"

    # --- generic family path (shifted RHS): CPMINRES + CPGMRES -----------
    for method, extra in (("cpminres", {}), ("cpgmres", {"restart": 50})):
        mopts = SolverOptions(atol=0.0, rtol=rtol, itmax=500, **extra)
        sref = solve(method, sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                     opts=mopts, dtype=dtype)
        assert sref.solved, f"serial {method} failed (istatus={sref.istatus})"
        res, x1, x2 = dist_solve(mesh, method, sys_.b, sys_.A, sys_.B,
                                 sys_.C, sys_.G, opts=mopts, dtype=dtype)
        assert bool(res.solved), f"dist_solve({method}) did not converge"
        assert abs(int(res.niters) - sref.niters) <= 1, (
            f"dist_solve({method}) iteration drift: {int(res.niters)} vs "
            f"serial {sref.niters}")
        rel = (np.linalg.norm(np.asarray(x1) - np.asarray(sref.x1))
               / max(np.linalg.norm(np.asarray(sref.x1)), 1e-300))
        assert rel < drift_tol, f"dist_solve({method}) solution drift: {rel}"
