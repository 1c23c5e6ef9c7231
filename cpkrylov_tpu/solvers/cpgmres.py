"""Constraint-preconditioned restarted GMRES(l).

Functional re-implementation of /root/reference/kernels/cpgmres.m for
nonsymmetric A: dense Krylov bases V (n x (l+1)) / Q (m x (l+1)) with
modified Gram-Schmidt under the coupled inner product
``H(j,k) = dot(Vj,u) + dot(Qj,t)`` (cpgmres.m:214-218), SymGivens rotations,
and the restart recomputing the true residual (cpgmres.m:167-171).

Device notes: bases are stored row-major ((l+1, n)) with static shapes; the
dynamic-k triangular solve at restart is a masked full-size
``solve_triangular``.  The reference's complex-value guards
(cpgmres.m:174-176, 220-222, 244-246) become clamps to zero of the coupled
norms, which is where a real-arithmetic run can only go complex.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SolverOptions
from ..precond.cp import CPPrecond, CPState
from .common import (KrylovResult, STATUS_BREAKDOWN, STATUS_ITMAX,
                     STATUS_SOLVED, apply_manifold_veto, resolve_itmax,
                     resolve_operators, sym_givens, vdot)


class _Inner(NamedTuple):
    k: jax.Array
    breakdown: jax.Array
    V: jax.Array        # (restart+1, n)
    Q: jax.Array        # (restart+1, m)
    R: jax.Array        # (restart+1, restart) rotated Hessenberg columns
    g: jax.Array        # (restart+1,)
    c: jax.Array        # (restart,)
    s: jax.Array        # (restart,)
    resid: jax.Array
    hist: jax.Array
    hidx: jax.Array
    mstate: CPState


class _Outer(NamedTuple):
    outer: jax.Array
    degraded: jax.Array   # last sweep failed to reduce the true residual
    x: jax.Array
    y: jax.Array
    V: jax.Array
    Q: jax.Array
    g: jax.Array
    resid_inner: jax.Array   # residual the `finished` flag tests
    resid_seed: jax.Array    # residual of the (re)seeded basis
    niters: jax.Array
    hist: jax.Array
    hidx: jax.Array
    mstate: CPState


def cpgmres(b, A, C, M: CPPrecond, opts: SolverOptions | None = None,
            mstate: CPState | None = None, B=None) -> KrylovResult:
    """Solve [A B'; B -C][x; y] = [b; 0] via CP-GMRES(restart).

    ``B`` is optional: when provided (the driver always does), the final
    iterate is verified against the defining CP invariant — the constraint
    block residual ``B x - C y`` stays at roundoff level throughout a
    healthy solve — which catches the degenerate regime where the
    reference's estimate-only design returns a corrupted "solved" iterate.
    """
    opts = opts or SolverOptions()
    A, C = resolve_operators(A, C)
    b = jnp.asarray(b)
    dtype = b.dtype
    n = A.shape[0]
    m = C.shape[0]
    restart = int(opts.restart)                     # cpgmres.m:103
    itmax = resolve_itmax(opts, n + m)              # cpgmres.m:105
    outermax = -(-itmax // restart)                 # cpgmres.m:148
    mstate = mstate if mstate is not None else M.init_state(dtype)

    zerom = jnp.zeros(m, dtype)

    def coupled_norm(u, v, t, q):
        # sqrt of the coupled inner product; clamped at 0 where the MATLAB
        # code strips an imaginary part (cpgmres.m:174-176, 220-222).
        d = vdot(u, v) + vdot(t, q)
        return jnp.sqrt(jnp.maximum(d, 0.0))

    def normalized(v, q, nrm):
        nz = nrm != 0
        denom = jnp.where(nz, nrm, 1.0)
        return jnp.where(nz, v / denom, v), jnp.where(nz, q / denom, q)

    # Initial seed (outer == 1 branch, cpgmres.m:160-180).
    u0 = b
    t0 = zerom
    mstate, w1, w2, _ = M.apply_nm(mstate, u0, -t0)
    v1, q1 = w1, -w2
    resid0 = coupled_norm(u0, v1, t0, q1)
    v1, q1 = normalized(v1, q1, resid0)
    stop_tol = opts.atol + opts.rtol * resid0       # cpgmres.m:182

    hsize = outermax * restart + 1
    hist = jnp.full(hsize, jnp.nan, dtype).at[0].set(resid0)

    V0 = jnp.zeros((restart + 1, n), dtype).at[0].set(v1)
    Q0 = jnp.zeros((restart + 1, m), dtype).at[0].set(q1)
    g0 = jnp.zeros(restart + 1, dtype).at[0].set(resid0)

    def inner_body(ic: _Inner) -> _Inner:
        k = ic.k                                    # 0-based column index
        vk = ic.V[k]
        qk = ic.Q[k]
        u = A.matvec(vk)
        t = C.matvec(qk)
        mstate, w1, w2, _ = M.apply_nm(ic.mstate, u, -t)
        vnew = w1
        qnew = qk - w2

        # Modified Gram-Schmidt against all previous pairs (cpgmres.m:214-218).
        def mgs(j, acc):
            hcol, vnew, qnew = acc
            hj = vdot(ic.V[j], u) + vdot(ic.Q[j], t)
            return (hcol.at[j].set(hj), vnew - hj * ic.V[j],
                    qnew - hj * ic.Q[j])

        hcol0 = jnp.zeros(restart + 1, dtype)
        hcol, vnew, qnew = jax.lax.fori_loop(0, k + 1, mgs,
                                             (hcol0, vnew, qnew))
        if opts.reorth:
            # Second pass ("twice is enough").  The process pairs basis
            # pairs with the K_P-image of the candidate's RAW preconditioned
            # coordinates: H(j,k) = V_j'u + Q_j't with [u; -t] =
            # K_P [w1; w2] (cpgmres.m:209-215).  The q-channel deflation
            # acts on q_k - w2, so the deflated candidate's raw pair is
            # (vnew, q_k - qnew); one K_P SpMV gives its exact duals (the
            # undeflated case reproduces the first-pass formula verbatim).
            # No A/C/preconditioner application needed.  The reference
            # documents `reorth` but never implements it (cpgmres.m:81-82).
            kp_im = M.mul_kp(jnp.concatenate([vnew, qk - qnew]))
            u = kp_im[:n]
            t = -kp_im[n:]

            def mgs2(j, acc):
                hcol, vnew, qnew = acc
                hj = vdot(ic.V[j], u) + vdot(ic.Q[j], t)
                return (hcol.at[j].add(hj), vnew - hj * ic.V[j],
                        qnew - hj * ic.Q[j])

            hcol, vnew, qnew = jax.lax.fori_loop(0, k + 1, mgs2,
                                                 (hcol, vnew, qnew))
        # A nonpositive coupled inner product is a breakdown: lucky (exact
        # convergence) or loss of M-positivity past convergence — where the
        # reference goes complex (cpgmres.m:219-222).  The iteration still
        # completes (hsub = 0 keeps the rotation and solve valid, as in the
        # reference), the inner loop then exits, and the restart recomputes
        # the TRUE residual to decide whether the solve is actually done.
        dsub = vdot(u, vnew) + vdot(t, qnew)
        breakdown = dsub <= 0
        hsub = jnp.sqrt(jnp.maximum(dsub, 0.0))
        vnew, qnew = normalized(vnew, qnew, hsub)
        V = ic.V.at[k + 1].set(vnew)
        Q = ic.Q.at[k + 1].set(qnew)

        # Previous rotations (cpgmres.m:229-234).
        def rot(j, hcol):
            hj = ic.c[j] * hcol[j] + ic.s[j] * hcol[j + 1]
            hj1 = ic.s[j] * hcol[j] - ic.c[j] * hcol[j + 1]
            return hcol.at[j].set(hj).at[j + 1].set(hj1)

        hcol = hcol.at[k + 1].set(hsub)
        hcol = jax.lax.fori_loop(0, k, rot, hcol)

        # Current rotation (cpgmres.m:236-247).
        ck, sk, dk = sym_givens(hcol[k], hcol[k + 1])
        c = ic.c.at[k].set(ck)
        s = ic.s.at[k].set(sk)
        hcol = hcol.at[k].set(dk).at[k + 1].set(0.0)
        gk = ic.g[k]
        g = ic.g.at[k + 1].set(sk * gk).at[k].set(ck * gk)
        resid = jnp.abs(g[k + 1])

        R = ic.R.at[:, k].set(hcol)
        hidx = ic.hidx + 1
        hist = ic.hist.at[hidx].set(resid)
        if opts.verbose:
            jax.debug.print("{k:5d}  {r:14.7e}", k=hidx, r=resid)
        return _Inner(k=k + 1, breakdown=breakdown, V=V, Q=Q, R=R, g=g,
                      c=c, s=s, resid=resid, hist=hist, hidx=hidx,
                      mstate=mstate)

    def outer_body(oc: _Outer) -> _Outer:
        inner0 = _Inner(
            k=jnp.zeros((), jnp.int32),
            breakdown=jnp.zeros((), jnp.bool_), V=oc.V, Q=oc.Q,
            R=jnp.zeros((restart + 1, restart), dtype), g=oc.g,
            c=jnp.zeros(restart, dtype), s=jnp.zeros(restart, dtype),
            resid=oc.resid_seed, hist=oc.hist, hidx=oc.hidx,
            mstate=oc.mstate,
        )
        ic = jax.lax.while_loop(
            lambda ic: ((ic.resid > stop_tol) & (ic.k < restart)
                        & (~ic.breakdown)),
            inner_body, inner0,
        )
        k = ic.k

        # Triangular solve + basis combination (cpgmres.m:257-260), with
        # columns >= k masked to the identity so z is zero there.  Columns
        # whose rotated diagonal is numerically rank-deficient (breakdown
        # columns; the reference's plain backslash would blow up there and
        # poison the whole back substitution) are masked out the same way —
        # such directions carry no residual reduction.
        idx = jnp.arange(restart)
        Rsq = ic.R[:restart]
        diag = jnp.abs(jnp.diagonal(Rsq))
        rank_tol = jnp.sqrt(jnp.asarray(
            jnp.finfo(dtype).eps, dtype)) * jnp.max(diag)
        # |c_j| ~ 0 marks a column that produced no residual reduction (the
        # rotation put everything into the subdiagonal): a symptom of the
        # degenerate post-floor regime whose tiny diagonals poison the back
        # substitution.  Healthy iterations always have |c| well above eps.
        dead = (idx >= k) | (diag < rank_tol) | (jnp.abs(ic.c) < 1e-8)
        Rsq = jnp.where(dead[:, None], 0.0, Rsq) + jnp.diag(
            jnp.where(dead, 1.0, 0.0).astype(dtype))
        gmask = jnp.where(dead, 0.0, ic.g[:restart])
        z = jax.scipy.linalg.solve_triangular(Rsq, gmask, lower=False)
        x = oc.x + jnp.matmul(z, ic.V[:restart],
                              precision=jax.lax.Precision.HIGHEST)
        q_acc = jnp.matmul(z, ic.Q[:restart],
                           precision=jax.lax.Precision.HIGHEST)
        y = oc.y - q_acc

        # Reseed for the next outer sweep (cpgmres.m:167-180).  The reseed
        # computes the TRUE residual of the just-updated iterate, which
        # doubles as a verification: a sweep whose basis degenerated (tiny
        # rotated diagonals amplifying noise through the back substitution —
        # the reference's backslash has the same failure mode) can only make
        # things worse, so such an update is rolled back and the solver
        # exits honestly instead of returning a corrupted "solved" iterate.
        u = b - A.matvec(x)
        t = C.matvec(y)
        mstate, w1, w2, _ = M.apply_nm(ic.mstate, u, -t)
        v1 = w1
        q1 = y - w2
        resid_seed = coupled_norm(u, v1, t, q1)
        v1, q1 = normalized(v1, q1, resid_seed)

        improved = resid_seed < oc.resid_seed
        x = jnp.where(improved, x, oc.x)
        y = jnp.where(improved, y, oc.y)
        resid_true = jnp.where(improved, resid_seed, oc.resid_seed)

        V = ic.V.at[0].set(v1)
        Q = ic.Q.at[0].set(q1)
        g = jnp.zeros(restart + 1, dtype).at[0].set(resid_seed)

        # After a breakdown the inner estimate is not trustworthy; the
        # freshly-computed true residual governs continuation instead.
        resid_eff = jnp.where(ic.breakdown, resid_true, ic.resid)
        return _Outer(outer=oc.outer + 1, degraded=~improved, x=x, y=y, V=V,
                      Q=Q, g=g, resid_inner=resid_eff, resid_seed=resid_true,
                      niters=oc.niters + k, hist=ic.hist, hidx=ic.hidx,
                      mstate=mstate)

    outer0 = _Outer(outer=jnp.zeros((), jnp.int32),
                    degraded=jnp.zeros((), jnp.bool_),
                    x=jnp.zeros(n, dtype), y=zerom, V=V0, Q=Q0, g=g0,
                    resid_inner=resid0, resid_seed=resid0,
                    niters=jnp.zeros((), jnp.int32), hist=hist,
                    hidx=jnp.zeros((), jnp.int32), mstate=mstate)

    out = jax.lax.while_loop(
        lambda oc: ((oc.resid_inner > stop_tol) & (oc.outer < outermax)
                    & (~oc.degraded)),
        outer_body, outer0,
    )

    # `solved` requires the in-sweep estimate AND consistency with the true
    # residual recomputed at the last restart: in healthy runs they agree to
    # rounding, while in the degenerate post-floor regime the estimate can
    # read arbitrarily small with a corrupted iterate.
    est_ok = out.resid_inner <= stop_tol
    truth_ok = out.resid_seed <= jnp.maximum(stop_tol,
                                             10.0 * out.resid_inner)
    solved = est_ok & truth_ok
    istatus = jnp.where(
        out.degraded & ~solved, STATUS_BREAKDOWN,
        jnp.where(solved, STATUS_SOLVED, STATUS_ITMAX)).astype(jnp.int32)
    solved, istatus = apply_manifold_veto(solved, istatus, B, C, out.x,
                                          out.y, stop_tol)
    return KrylovResult(x=out.x, y=out.y, niters=out.niters,
                        resid_history=out.hist, solved=solved,
                        istatus=istatus)
