"""Top-level driver: build the constraint preconditioner, shift the RHS,
dispatch to a kernel, un-shift — the reg_cpkrylov equivalent.

Mirrors /root/reference/reg_cpkrylov.m:
  * build + time the preconditioner (l.128-132),
  * forward precond options (l.135-148),
  * shift the system so the RHS becomes [b1'; 0] when b2 != 0 (l.152-160),
  * run the kernel (l.163), un-shift (l.166-173), attach ptime/stime
    (l.175-178).

The shift/solve/un-shift pipeline is one jitted function per (method, opts,
shift) combination; the host only decides `shift` (a concrete check on b2)
and performs the one-time factorization.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import PrecondOptions, SolverOptions
from .operators.linop import aslinearoperator
from .precond.cp import CPPrecond, make_preconditioner
from .solvers.common import KrylovResult


def _solver_registry():
    from .solvers.cpcg import cpcg
    from .solvers.cpcglanczos import cpcglanczos
    from .solvers.cpdqgmres import cpdqgmres
    from .solvers.cpgmres import cpgmres
    from .solvers.cpminres import cpminres
    from .solvers.cpsymmlq import cpsymmlq

    return {"cpminres": cpminres, "cpcg": cpcg, "cpcglanczos": cpcglanczos,
            "cpsymmlq": cpsymmlq, "cpgmres": cpgmres, "cpdqgmres": cpdqgmres}


def _maybe_pack_pgell(A, spmv_format: str, tile_rows: int, dtype):
    """Pack an explicit square A in the requested device layout.

    Already-packed operands (DIA / PGELL / SymPermuted) pass through
    untouched, so callers can pre-pack once and reuse across solves.
    Format choice lives in ``precond.cp.pack_device_format``.  Returns None
    when A should stay in its given form: operator-A, a non-square/implicit
    operand, a layout the gate rejects, or a format selection that resolves
    to CSR.  Pack results are cached per host matrix, so repeated solves do
    not pack and upload A again.
    """
    import scipy.sparse as sp

    from .operators.linop import cache_device_form
    from .ops.dia import DIA, DIASpill
    from .ops.pgell import PGELL, SymPermuted
    from .precond.cp import pack_device_format

    if isinstance(A, (DIA, DIASpill, PGELL, SymPermuted)):
        return A
    if not (sp.issparse(A) or isinstance(A, np.ndarray)):
        return None
    if A.shape[0] != A.shape[1]:
        return None
    from .operators.linop import host_fingerprint

    return cache_device_form(
        A, ("packed", spmv_format, tile_rows, np.dtype(dtype).str),
        lambda: pack_device_format(A, spmv_format, tile_rows, dtype),
        fingerprint=host_fingerprint(A))


def _maybe_pack_rect(B, spmv_format: str, dtype):
    """Rectangular-DIA pack for the B block (shift path / manifold check,
    reg_cpkrylov.m:157) when a packed format is requested; None keeps the
    given form."""
    import scipy.sparse as sp

    from .operators.linop import cache_device_form
    from .ops.dia import pack_dia
    from .precond.cp import _select_spmv_format

    if not (sp.issparse(B) and _select_spmv_format(spmv_format)):
        return None
    from .operators.linop import host_fingerprint

    return cache_device_form(
        B, ("dia_rect", np.dtype(dtype).str),
        lambda: pack_dia(B.tocsr(), dtype=dtype),
        fingerprint=host_fingerprint(B))


@dataclasses.dataclass(frozen=True)
class SolveOutput:
    """Driver output: combined solution + stats (reg_cpkrylov.m:107-117)."""

    x: jax.Array               # (n+m,) combined solution
    x1: jax.Array              # (n,)
    x2: jax.Array              # (m,)
    niters: int
    resid_history: np.ndarray  # NaN-trimmed
    solved: bool
    istatus: int
    ptime: float               # preconditioner build seconds
    stime: float               # solve seconds
    result: KrylovResult       # full kernel result (extra histories etc.)


def _solve_core_impl(method: str, b, A_op, C_op, B_op, M: CPPrecond,
                     opts: SolverOptions, shift: bool):
    """Traceable shift -> kernel -> un-shift pipeline (reg_cpkrylov.m:152-173).

    Exposed un-jitted so callers can embed the whole pipeline inside a
    larger jitted program (mixed.solve_mixed's device-resident outer loop);
    ``_solve_core`` is the stand-alone jitted form.
    """
    n, m = M.n, M.m
    mstate = M.init_state(b.dtype)
    if shift:
        # xy0 = M * [0; b2]; b1' = b1 - A*xy0_1 - B'*xy0_2
        # (reg_cpkrylov.m:154-158)
        mstate, xy0, _ = M.apply(
            mstate, jnp.concatenate([jnp.zeros(n, b.dtype), b[n:]])
        )
        b1 = b[:n] - A_op.matvec(xy0[:n]) - B_op.rmatvec(xy0[n:])
    else:
        xy0 = jnp.zeros(n + m, b.dtype)
        b1 = b[:n]

    kernel = _solver_registry()[method]
    res = kernel(b1, A_op, C_op, M, opts, mstate, B=B_op)

    x1 = xy0[:n] + res.x if shift else res.x     # reg_cpkrylov.m:166-172
    x2 = xy0[n:] + res.y if shift else res.y
    return res, x1, x2


_solve_core = partial(jax.jit, static_argnames=("method", "opts", "shift"))(
    _solve_core_impl)


def solve(method, b, A, B, C, G, *,
          opts: SolverOptions | None = None,
          precond_opts: PrecondOptions | None = None,
          backend: str = "auto", ordering="auto", panel: int = 256,
          spmv_format: str = "auto", tile_rows: int = 2048,
          dtype=None, M: CPPrecond | None = None,
          refine: bool = False,
          debug: bool = False) -> SolveOutput:
    """Solve the regularized saddle-point system [A B'; B -C] [x1;x2] = b.

    ``method`` is a kernel name ("cpminres", "cpcg", "cpcglanczos",
    "cpsymmlq", "cpgmres", "cpdqgmres") or the kernel function itself.
    ``A`` may be any matrix-like or a LinearOperator; B, C, G must be
    explicit (host) matrices since they form the preconditioner
    (reg_cpkrylov.m:40-41).  Pass ``M`` to reuse a built preconditioner.

    ``spmv_format`` selects the device layout for the hot-loop SpMVs
    (every ``A*v`` / K_P multiply, cpminres.m:187 / opLDL2.m:170-175):
    "auto" and "csr" keep CSR; "dia" / "pgell" pack that layout.

    ``refine=True`` routes through mixed-precision outer refinement: an f32
    Krylov solve stagnates near the f32 accuracy floor (~5e-3 relative
    residual on ill-conditioned KKT systems), short of the reference
    stopping contract ``residNorm <= atol + rtol*residNorm0``
    (cpminres.m:164,176).  With refinement on, f32 device solves become the
    inner loop of f64 true-residual iterative refinement (mixed.solve_mixed)
    and do reach tolerance.  It needs explicit host blocks.
    """
    opts = opts or SolverOptions()
    if callable(method):
        method = method.__name__
    if method not in _solver_registry():
        raise ValueError(f"unknown solver {method!r}")

    b = np.asarray(b).reshape(-1)
    if debug:
        from .utils.debug import validate_system
        validate_system(A, B, C, G, b)
    explicit_dtype = dtype is not None
    dtype = np.dtype(dtype or b.dtype)
    canonical = jax.dtypes.canonicalize_dtype(dtype)
    if canonical != dtype and not explicit_dtype:
        # f64 inputs with jax_enable_x64 off would silently run in f32 and
        # break the Krylov recurrences' 100*eps indefiniteness guards.
        raise RuntimeError(
            f"rhs dtype {dtype} would be silently truncated to {canonical} "
            "(jax_enable_x64 is disabled). Enable x64 "
            "(jax.config.update('jax_enable_x64', True)) for reference-"
            "matching f64 solves, or pass dtype=np.float32 explicitly to "
            "opt into single precision."
        )
    dtype = canonical
    n = A.shape[0]
    m = C.shape[0]
    if b.shape[0] != n + m:
        raise ValueError(f"rhs has length {b.shape[0]}, expected {n + m}")

    if refine:
        from .mixed import solve_mixed
        from .solvers.common import STATUS_SOLVED, STATUS_STAGNATED

        mout = solve_mixed(method, b, A, B, C, G, opts=opts,
                           precond_opts=precond_opts, backend=backend,
                           ordering=ordering, panel=panel,
                           spmv_format=spmv_format, tile_rows=tile_rows,
                           M=M)
        last = mout.inner_outputs[-1] if mout.inner_outputs else None
        return SolveOutput(
            x=mout.x, x1=mout.x1, x2=mout.x2, niters=mout.niters,
            resid_history=np.asarray(mout.resid_history),
            solved=bool(mout.solved),
            istatus=(STATUS_SOLVED if mout.solved else
                     (last.istatus if last is not None else STATUS_STAGNATED)),
            ptime=mout.ptime, stime=mout.stime,
            result=last.result if last is not None else None,
        )

    t0 = time.perf_counter()
    if M is None:
        M = make_preconditioner(G, B, C, options=precond_opts,
                                backend=backend, ordering=ordering,
                                panel=panel, dtype=dtype,
                                spmv_format=spmv_format, tile_rows=tile_rows)
    ptime = time.perf_counter() - t0

    A_dev = _maybe_pack_pgell(A, spmv_format, tile_rows, dtype)
    A_op = aslinearoperator(A_dev if A_dev is not None else A, dtype=dtype)
    C_op = aslinearoperator(C, dtype=dtype)
    B_dev = _maybe_pack_rect(B, spmv_format, dtype)
    B_op = aslinearoperator(B_dev if B_dev is not None else B, dtype=dtype)
    shift = bool(np.any(b[n:]))                     # reg_cpkrylov.m:154
    # The RHS upload finishes before the timed region starts.
    b_dev = jax.block_until_ready(jnp.asarray(b, dtype=dtype))

    t1 = time.perf_counter()
    res, x1, x2 = jax.block_until_ready(
        _solve_core(method, b_dev, A_op, C_op, B_op, M, opts, shift))
    stime = time.perf_counter() - t1

    if debug:
        from .utils.debug import check_finite
        check_finite((x1, x2), "solution")
    # One batched fetch for the scalar stats + history.
    niters, hist, solved, istatus = jax.device_get(
        (res.niters, res.resid_history, res.solved, res.istatus))
    hist = np.asarray(hist)
    return SolveOutput(
        x=jnp.concatenate([x1, x2]), x1=x1, x2=x2,
        niters=int(niters),
        resid_history=hist[~np.isnan(hist)],
        solved=bool(solved), istatus=int(istatus),
        ptime=ptime, stime=stime, result=res,
    )
