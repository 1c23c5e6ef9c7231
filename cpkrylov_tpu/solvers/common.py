"""Shared machinery for the constraint-preconditioned Krylov kernels.

All six kernels are pure functions structured as ``lax.while_loop`` over an
explicit carry, so they jit/pjit cleanly and their state can be checkpointed
as a pytree.  Numerical semantics (tolerances, guards, recurrences) follow
the MATLAB reference kernel-by-kernel; citations sit next to each use.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SolverOptions
from ..operators.linop import aslinearoperator

# Status codes (JAX-traceable replacement for the reference's thrown
# MExceptions / status strings, cpcglanczos.m:312-325; SURVEY.md §5).
STATUS_SOLVED = 0          # residual small compared to initial residual
STATUS_ITMAX = 1           # maximum number of iterations attained
STATUS_INDEFINITE = 2      # beta^2 < -100*eps: preconditioner not SPD-like
STATUS_BACKWARD = 3        # backward error small (cpcglanczos btol)
STATUS_BREAKDOWN = 4       # coupled inner product lost positivity
STATUS_STAGNATED = 5       # no meaningful progress for opts.stagwin iters

STATUS_STRINGS = {
    STATUS_SOLVED: "residual small compared to initial residual",
    STATUS_ITMAX: "maximum number of iterations attained",
    STATUS_INDEFINITE: "preconditioner not second-order sufficient",
    STATUS_BACKWARD: "backward error small",
    STATUS_BREAKDOWN: "basis breakdown (coupled inner product nonpositive)",
    STATUS_STAGNATED: "residual stagnated (opts.stagwin exceeded)",
}


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@partial(_register,
         data_fields=("x", "y", "niters", "resid_history", "solved",
                      "istatus", "cg_resid_history", "lq_resid_history",
                      "qr_resid_history"),
         meta_fields=())
@dataclasses.dataclass(frozen=True)
class KrylovResult:
    """Solver output: solution pair + stats (the reference's x/y/stats/flag).

    ``resid_history`` is a fixed-length device buffer (itmax+1 slots) padded
    with NaN past ``niters`` — the functional version of the reference's
    growing ``residHistory`` arrays (e.g. cpminres.m:236).
    """

    x: jax.Array
    y: jax.Array
    niters: jax.Array          # int32 scalar
    resid_history: jax.Array   # (itmax + 1,), NaN-padded
    solved: jax.Array          # bool scalar
    istatus: jax.Array         # int32 scalar, see STATUS_* codes
    # CPSYMMLQ extras (cpsymmlq.m:363-366); None elsewhere.
    cg_resid_history: jax.Array | None = None
    lq_resid_history: jax.Array | None = None
    qr_resid_history: jax.Array | None = None

    @property
    def status(self) -> str:
        return STATUS_STRINGS.get(int(self.istatus), "unknown")

    def trimmed_history(self) -> np.ndarray:
        """Residual history with NaN padding stripped (host-side)."""
        h = np.asarray(self.resid_history)
        return h[~np.isnan(h)]


def sym_givens(a, b):
    """Symmetric (reflector-form) Givens rotation, branch-for-branch port of
    /root/reference/util/SymGivens.m (Saunders & Choi), as jnp.where lattices.

    Returns (c, s, d) with [c s; s -c] [a; b] = [d; 0].
    Note MATLAB's sign(0) = 0 convention — jnp.sign matches it.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    abs_a, abs_b = jnp.abs(a), jnp.abs(b)
    b_zero = b == 0
    a_zero = a == 0
    b_dominant = abs_b > abs_a

    one = jnp.ones((), dtype=a.dtype)
    a_safe = jnp.where(a_zero, one, a)
    b_safe = jnp.where(b_zero, one, b)

    # branch: |b| > |a|
    t3 = a / b_safe
    s3 = jnp.sign(b) / jnp.sqrt(1 + t3 * t3)
    c3 = s3 * t3
    d3 = b / jnp.where(s3 == 0, one, s3)
    # branch: |a| >= |b| (both nonzero)
    t4 = b / a_safe
    c4 = jnp.sign(a) / jnp.sqrt(1 + t4 * t4)
    s4 = c4 * t4
    d4 = a / jnp.where(c4 == 0, one, c4)

    c = jnp.where(b_zero, jnp.where(a_zero, one, jnp.sign(a)),
                  jnp.where(a_zero, 0.0, jnp.where(b_dominant, c3, c4)))
    s = jnp.where(b_zero, 0.0,
                  jnp.where(a_zero, jnp.sign(b), jnp.where(b_dominant, s3, s4)))
    d = jnp.where(b_zero, abs_a,
                  jnp.where(a_zero, abs_b, jnp.where(b_dominant, d3, d4)))
    return c, s, d


# ---------------------------------------------------------------------------
# Vector reductions — pluggable for distributed execution.
#
# Every kernel reduction goes through ``vdot``/``vnorm``.  On a single
# device they are plain jnp ops; inside a ``shard_map`` region the
# ``reduce_axis`` context makes every kernel reduction a psum-fused local
# dot (SURVEY.md §2.4 "fused allreduce dot products"), which is what lets
# ALL six kernels run with row-sharded vectors unchanged.
# ---------------------------------------------------------------------------

_REDUCE_AXIS: "contextvars.ContextVar[str | None]" = None


def _axis():
    global _REDUCE_AXIS
    if _REDUCE_AXIS is None:
        import contextvars

        _REDUCE_AXIS = contextvars.ContextVar("cpk_reduce_axis", default=None)
    return _REDUCE_AXIS


class reduce_axis:
    """Context manager: reductions inside become psum(local, axis_name).

    Activate around kernel *tracing* inside a shard_map body; the traced
    computation then carries the collectives permanently.
    """

    def __init__(self, axis_name: str | None):
        self.axis_name = axis_name
        self._token = None

    def __enter__(self):
        self._token = _axis().set(self.axis_name)
        return self

    def __exit__(self, *exc):
        _axis().reset(self._token)
        return False


def vdot(a, b):
    """dot(a, b), psum-reduced over the active shard axis (if any)."""
    d = jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)
    axis_name = _axis().get()
    if axis_name is not None:
        d = jax.lax.psum(d, axis_name)
    return d


def vnorm(a):
    """2-norm via vdot (sharding-aware)."""
    return jnp.sqrt(vdot(a, a))


def coupled_dot(u, v, t, q):
    """The coupled inner product dot(u,v) + dot(t,q) used by every kernel
    (e.g. cpminres.m:189, cpgmres.m:215)."""
    return vdot(u, v) + vdot(t, q)


def eps100(dtype, size: int = 0) -> float:
    """The reference's ``100*eps`` indefiniteness threshold
    (cpminres.m:135).  ``size`` is accepted for call-site symmetry but
    unused: near the f32 floor the guard doubles as a cheap breakdown
    detector (a small-negative beta^2 from roundoff ends the pass ~20
    iterations earlier than the stagnation window would), so loosening it
    with a reduction-error model costs more than it saves."""
    return 100.0 * float(np.finfo(np.dtype(dtype)).eps)


def safe_normalize_pair(v, q, beta):
    """Divide (v, q) by beta when beta > 0, as cpminres.m:202-205."""
    pos = beta > 0
    denom = jnp.where(pos, beta, 1.0)
    return jnp.where(pos, v / denom, v), jnp.where(pos, q / denom, q)


def resolve_operators(A, C):
    return aslinearoperator(A), aslinearoperator(C)


def resolve_itmax(opts: SolverOptions, default: int) -> int:
    return int(opts.itmax) if opts.itmax is not None else int(default)


def history_init(itmax: int, first, dtype) -> jax.Array:
    h = jnp.full(itmax + 1, jnp.nan, dtype=dtype)
    return h.at[0].set(first)


def lanczos_step(A, C, M, mstate, vk, qk, vkm1, qkm1, beta, e100):
    """One coupled Lanczos step shared by the symmetric-family kernels.

    Computes u = A v_k, t = C q_k, the coupled alpha, one preconditioner
    application, and the three-term recurrences for (v_{k+1}, q_{k+1}) with
    the q-coupling ``q_{k+1} = q_k - w2 - alpha q_k - beta q_{k-1}``
    (cpminres.m:187-206 / cpcglanczos.m:232-262 / cpsymmlq.m:266-285 share
    this block verbatim in the reference).

    Returns (mstate, u, t, alpha, v_{k+1}, q_{k+1}, beta_{k+1}, indefinite).
    """
    u = A.matvec(vk)
    t = C.matvec(qk)
    alpha = coupled_dot(u, vk, t, qk)
    mstate, w1, w2, _ = M.apply_nm(mstate, u, -t)
    vkp1 = w1 - alpha * vk - beta * vkm1
    qkp1 = (qk - w2) - alpha * qk - beta * qkm1
    beta2 = coupled_dot(u, vkp1, t, qkp1)
    # Relative threshold: the reference compares against an absolute -100*eps
    # (cpminres.m:195), which spuriously fires on post-convergence roundoff
    # noise; scaling by the same-unit |alpha| only changes behavior where
    # the reference would crash.
    indefinite = beta2 < -e100 * (1 + jnp.abs(alpha))
    beta_new = jnp.sqrt(jnp.abs(beta2))
    vkp1, qkp1 = safe_normalize_pair(vkp1, qkp1, beta_new)
    return mstate, u, t, alpha, vkp1, qkp1, beta_new, indefinite


def initial_lanczos_pair(b, m, M, mstate, e100):
    """Initial Lanczos pair (v1, q1) and beta1 (cpminres.m:130-147 et al.)."""
    t0 = jnp.zeros(m, b.dtype)
    mstate, w1, w2, _ = M.apply_nm(mstate, b, t0)
    vkp1 = w1
    qkp1 = -w2
    beta0 = vdot(b, vkp1)
    indefinite = beta0 < -e100 * (1 + jnp.abs(beta0))
    beta = jnp.sqrt(jnp.abs(beta0))
    vkp1, qkp1 = safe_normalize_pair(vkp1, qkp1, beta)
    return mstate, vkp1, qkp1, beta, indefinite


def stag_init(resid0, dtype):
    """State for the opt-in stagnation window (opts.stagwin): (best residual
    seen, iterations since the last >=10% improvement on it).

    Finite-precision Krylov residual *estimates* (e.g. MINRES' taubar,
    cpminres.m:235) keep creeping down long after the attainable accuracy is
    reached — in f32 the true residual floors near ~1e-4 relative while the
    estimate still shrinks.  The window bounds the wasted iterations; it is
    OFF by default (stagwin=0) so reference-parity f64 runs are untouched.
    """
    return jnp.asarray(resid0, dtype), jnp.zeros((), jnp.int32)


def stag_update(best, since, resid):
    """Advance the (best, since) stagnation pair with this iteration's
    residual; >=10% improvement over the best resets the counter."""
    better = resid < 0.9 * best
    best = jnp.minimum(resid, best)
    since = jnp.where(better, 0, since + 1).astype(jnp.int32)
    return best, since


def stag_stop(since, stagwin: int):
    """True when the window is enabled and exhausted (traceable; stagwin is
    a static option)."""
    if stagwin <= 0:
        return jnp.asarray(False)
    return since >= stagwin


def manifold_ok(B_op, C_op, x, y, stop_tol=0.0):
    """Constraint-preservation check: healthy CP iterates keep ``B x - C y``
    near rounding level by construction (the defining property of the
    family), certainly well under the requested residual tolerance.  A gross
    violation marks the degenerate regime where residual estimates decouple
    from the truth; used to veto a bogus `solved` flag at kernel exit."""
    bx = B_op.matvec(x)
    cy = C_op.matvec(y)
    viol = vnorm(bx - cy)
    scale = 1.0 + vnorm(bx) + vnorm(cy)
    feps = float(np.finfo(np.dtype(x.dtype)).eps)
    return viol <= jnp.maximum((feps ** 0.5) * scale, 10.0 * stop_tol)


def apply_manifold_veto(solved, istatus, B, C_op, x, y, stop_tol=0.0):
    """AND the manifold check into `solved`; flag a veto as breakdown."""
    if B is None:
        return solved, istatus
    ok = manifold_ok(aslinearoperator(B), C_op, x, y, stop_tol)
    vetoed = solved & ~ok
    solved = solved & ok
    istatus = jnp.where(vetoed, STATUS_BREAKDOWN, istatus).astype(jnp.int32)
    return solved, istatus


def debug_iter_print(enabled: bool, k, resid):
    """Per-iteration printing (the reference's ``opts.print`` tables)."""
    if enabled:
        jax.debug.print("{k:5d}  {r:9.2e}", k=k, r=resid)


def breakdown_resid_recheck(solved, istatus, resid_est, stop_tol,
                            b, A, C_op, M, mstate, x, y):
    """Re-judge ``solved`` with a freshly computed residual on
    breakdown-class exits.

    Near Krylov-space exhaustion ``beta^2 ~ 0`` flips sign in roundoff one
    step short of the tolerance: the iterate is already (nearly) exact but
    the in-recurrence residual ESTIMATE lags, the indefiniteness guard
    fires, and the reference simply crashes there (cpminres.m:195-199).
    This recomputes the true preconditioned residual exactly the way the
    GMRES restart reseeds its basis (cpgmres.m:167-171: one A matvec, one
    C matvec, one preconditioner application, one coupled norm) and
    re-evaluates the SAME stopping contract ``resid <= stop_tol``.
    ``istatus`` keeps reporting the guard; genuinely indefinite systems
    carry a large true residual and stay unsolved.
    """
    breakdownish = ((istatus == STATUS_INDEFINITE)
                    | (istatus == STATUS_BREAKDOWN))

    def recheck(_):
        u = b - A.matvec(x)
        t = C_op.matvec(y)
        _, w1, w2, _ = M.apply_nm(mstate, u, -t)
        q1 = y - w2
        dot = coupled_dot(u, w1, t, q1)
        return jnp.sqrt(jnp.maximum(dot, 0.0))

    resid_true = jax.lax.cond(breakdownish, recheck,
                              lambda _: jnp.asarray(resid_est), None)
    solved = jnp.where(breakdownish, resid_true <= stop_tol, solved)
    return solved, resid_true
