"""Distributed mixed precision: f32 sharded inner solves + f64 outer
refinement.

The serial mixed path (mixed.solve_mixed) recovers f64 accuracy from f32
device solves by Krylov-accelerated iterative refinement.  This module
lifts the same scheme over the row-partitioned mesh (BASELINE.json
configs[4]: the 10M-row f32 configuration must reach the reference
stopping contract on a sharded mesh): each inner solve is a full
``dist_solve`` (halo-exchange SpMVs, psum-fused dots, distributed Schur
preconditioner) in f32, and the outer loop accumulates the f64 solution
and true residual on the host.  The f32 preconditioner and the compiled
distributed program are reused across passes (identical shapes/options ->
jit cache hit after pass 1).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp

from ..config import PrecondOptions, SolverOptions
from ..mixed import MixedSolveOutput, _as_host_matrix, _lean_inner_options


def build_dist_precond(G, B, C, ndev: int, *,
                       precond_opts: PrecondOptions | None = None,
                       panel: int = 256, dtype=np.float32):
    """Distributed-preferred preconditioner build (shared with dist_solve):
    the per-device Schur factor when the system's profile permits chunked
    partitioning, else the replicated serial factor."""
    from ..precond.cp import make_preconditioner
    from .schur import plan_schur_precond

    if ndev > 1:
        try:
            return plan_schur_precond(G, B, C, ndev, options=precond_opts,
                                      panel=min(panel, 128), dtype=dtype)
        except ValueError:
            pass
    return make_preconditioner(G, B, C, options=precond_opts, panel=panel,
                               dtype=dtype)


def dist_solve_mixed(mesh, method, b, A, B, C, G, *,
                     opts: SolverOptions | None = None,
                     precond_opts: PrecondOptions | None = None,
                     inner_rtol: float = 1.0e-4,
                     inner_stagwin: int = 30,
                     max_outer: int = 40,
                     lean_inner: bool = True,
                     panel: int = 256, halo: bool = True,
                     M=None) -> MixedSolveOutput:
    """Sharded solve of [A B'; B -C][x1;x2] = b to f64 accuracy.

    Outer contract: ``||b - K x||_2 <= atol + rtol * ||b||_2`` with the f64
    TRUE residual (strictly stronger than the kernels' preconditioned
    recurrence criterion, cpminres.m:234-236).
    """
    from .solve import dist_solve

    opts = opts or SolverOptions()
    t_all = time.perf_counter()

    # Content-fingerprinted like the serial path (mixed.solve_mixed): an
    # id()-only key serves a stale A_h/B_h/C_h after an in-place .data
    # update, making the f64 true-residual check validate the OLD system
    # (advisor r4, medium).
    from ..operators.linop import cache_device_form as _cdf
    from ..operators.linop import host_fingerprint as _fp
    A_h = _cdf(A, ("host_f64",), lambda: _as_host_matrix(A, "A"),
               fingerprint=_fp(A))
    B_h = _cdf(B, ("host_f64",), lambda: _as_host_matrix(B, "B"),
               fingerprint=_fp(B))
    C_h = _cdf(C, ("host_f64",), lambda: _as_host_matrix(C, "C"),
               fingerprint=_fp(C))
    n, m = A_h.shape[0], C_h.shape[0]
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    if b.shape[0] != n + m:
        raise ValueError(f"rhs has length {b.shape[0]}, expected {n + m}")
    ndev = int(np.prod(mesh.devices.shape))

    def kmatvec(x):
        x1, x2 = x[:n], x[n:]
        return np.concatenate([A_h @ x1 + B_h.T @ x2, B_h @ x1 - C_h @ x2])

    t0 = time.perf_counter()
    M32 = M if M is not None else build_dist_precond(
        G, B, C, ndev, precond_opts=precond_opts, panel=panel,
        dtype=np.float32)
    ptime = time.perf_counter() - t0
    if hasattr(M32, "factor_nitref"):
        M32 = _lean_inner_options(M32, lean_inner)

    inner_opts = dataclasses.replace(opts, atol=0.0, rtol=inner_rtol,
                                     stagwin=inner_stagwin, reorth=True)
    bnorm = float(np.linalg.norm(b))
    stop = opts.atol + opts.rtol * bnorm

    x = np.zeros(n + m)
    r = b.copy()
    rnorm = bnorm
    history = [rnorm]
    inner_iters = []
    solved = rnorm <= stop
    stagnant = 0
    stagwin_cur = inner_stagwin
    for _ in range(max_outer):
        if solved:
            break
        # Adaptive per-pass target, quantized to a power of ten (bounded
        # jit-cache growth), floored at ~3x the measured apply quality —
        # see mixed.solve_mixed (VERDICT r4 item 6).
        if getattr(M32, "factor_exact", False) and stop > 0:
            t_pass = min(inner_rtol, max(0.3 * stop / rnorm, 1e-7))
            t_pass = 10.0 ** np.floor(np.log10(max(t_pass, 1e-7)))
            inner_opts = dataclasses.replace(inner_opts, rtol=float(t_pass))
        res, x1c, x2c = dist_solve(
            mesh, method, (r / rnorm).astype(np.float32), A, B, C, G,
            opts=inner_opts, M=M32, panel=panel, halo=halo,
            dtype=np.float32)
        inner_iters.append(int(res.niters))
        d = np.concatenate([np.asarray(x1c, np.float64),
                            np.asarray(x2c, np.float64)])
        x = x + rnorm * d
        r = b - kmatvec(x)
        new_norm = float(np.linalg.norm(r))
        history.append(new_norm)
        solved = new_norm <= stop
        stagnant = stagnant + 1 if new_norm > 0.5 * rnorm else 0
        rnorm = max(new_norm, np.finfo(np.float64).tiny)
        if stagnant >= 2:
            # escalate the inner stagnation window before giving up (see
            # mixed.solve_mixed — coarsely-factorable K_P converges slowly)
            if stagwin_cur and stagwin_cur < 512:
                stagwin_cur *= 4
                inner_opts = dataclasses.replace(inner_opts,
                                                 stagwin=stagwin_cur)
                stagnant = 0
                continue
            break

    return MixedSolveOutput(
        x=x, x1=x[:n], x2=x[n:],
        niters=int(sum(inner_iters)), nouter=len(inner_iters),
        resid_history=np.asarray(history), inner_niters=tuple(inner_iters),
        solved=bool(solved), ptime=ptime,
        stime=time.perf_counter() - t_all,
        inner_outputs=(),
    )
