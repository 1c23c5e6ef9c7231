"""df64-applied preconditioner factor for coarsely-factorable K_P.

The reference compensates inexact MA57 factors with iterative refinement
inside every preconditioner application (opLDL2.m:173-187).  On the f32
path the factor lives in f32, and at interior-point conditioning the group-etree
LDL^T can carry enormous element growth — measured on cvxqp2_1000 at
mu=1e-4: cond(K_P) = 5.5e7 but cond(L) ~ 9e16 and cond(D) ~ 4e16 (the
growth cancels in the product).  STORING such a factor in f32 destroys it:
the plain f32 apply's probe residual is O(1), f32 refinement against K_P
is non-contractive (iteration matrix norm ~ cond(K_P)*eps_f32 >= O(1)),
and every f32 Krylov solve stagnates (the f32 rows of
benchmarks/bench_mm_sweep.py).

The fix implemented here keeps the factor ENTRIES in df64 — unevaluated
(hi, lo) f32 pairs, ~2^-48 relative (ops/df64.py) — and applies each
triangular factor by f32 substitution + df64-residual refinement:

    x_0 = trisolve_f32(T_hi, b_hi)
    x_{k+1} = x_k + trisolve_f32(T_hi, hi(b - T x_k))   # residual in df64

Forward substitution is componentwise backward-stable, so each step
contracts by ~cond_skeel(T, x) * eps_f32 — measured on the cvxqp2 factor
above: probe residual 8.1e-1 (plain f32) -> 2.1e-8 after ONE step,
8.2e-9 after two.  The block-diagonal D^-1 and the permutations apply in
df64 exactly (elementwise products and 0/1 linear maps).  The result: a
preconditioner application accurate to ~1e-8 relative even when
cond(K_P) * eps_f32 >> 1, restoring f64-like inner iteration counts for
the f32 path.

Built automatically by ``make_preconditioner`` when the build-time probe
detects a coarse f32 factor (see cp.py); costs (1 + nref) trisolves plus
nref df64 SpMVs of the factor per triangular solve — a robustness mode,
engaged only when the plain apply is unusable.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import df64
from .trisolve import tri_solve


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields))


@partial(_register, data_fields=("hi", "lo", "cols"), meta_fields=("n",))
@dataclasses.dataclass(frozen=True)
class DFTriMat:
    """Triangular matrix in (K, n) transposed-ELL form with df64 values.

    Stored column-step major so the df64 matvec runs as a ``lax.scan``
    over the K ELL slots with a compensated (two_sum-chained) accumulator
    — the error in each row's sum stays O(eps^2) regardless of K."""

    hi: jax.Array     # (K, n) f32
    lo: jax.Array     # (K, n) f32
    cols: jax.Array   # (K, n) int32 (column index into x; 0 where empty)
    n: int

    def matvec_df(self, x: df64.DF) -> df64.DF:
        xh, xl = x

        def step(carry, slot):
            acc_h, acc_l = carry
            dh, dl, c = slot
            vh = jnp.take(xh, c, mode="clip")
            vl = jnp.take(xl, c, mode="clip")
            p, e = df64.two_prod(dh, vh)
            e = e + dh * vl + dl * vh
            acc_h, e2 = df64.two_sum(acc_h, p)
            return (acc_h, acc_l + (e + e2)), None

        z = jnp.zeros(self.n, xh.dtype)
        (acc_h, acc_l), _ = jax.lax.scan(
            step, (z, z), (self.hi, self.lo, self.cols))
        return df64.quick_two_sum(acc_h, acc_l)


def _pack_df_tri(T) -> DFTriMat:
    """Host-side transposed-ELL pack of a scipy triangular matrix with
    df64-split values."""
    import scipy.sparse as sp

    T = sp.csr_matrix(T).astype(np.float64)
    T.sum_duplicates()
    n = T.shape[0]
    counts = np.diff(T.indptr)
    K = max(1, int(counts.max()) if counts.size and T.nnz else 1)
    data = np.zeros((n, K), np.float64)
    cols = np.zeros((n, K), np.int32)
    if T.nnz:
        offs = np.arange(T.nnz) - np.repeat(T.indptr[:-1], counts)
        rr = np.repeat(np.arange(n), counts)
        data[rr, offs] = T.data
        cols[rr, offs] = T.indices
    hi, lo = df64.df_from_f64(data.T)
    return DFTriMat(hi=jnp.asarray(hi), lo=jnp.asarray(lo),
                    cols=jnp.asarray(np.ascontiguousarray(cols.T)), n=int(n))


@partial(_register,
         data_fields=("pin", "tf1", "dinv", "tf2", "pout", "dinv_sub",
                      "t1", "t2", "dinv_lo", "dinv_sub_lo"),
         meta_fields=("nref",))
@dataclasses.dataclass(frozen=True)
class DFFactorApply:
    """Drop-in for ``FactorApply`` with df64-accurate application.

    Field names mirror FactorApply (pin/tf1/dinv/tf2/pout/dinv_sub) so
    work models and benchmarks introspect it unchanged; ``t1``/``t2`` hold
    the df64 triangular matrices (t2 in the index-reversed form tf2
    solves), ``dinv``/``dinv_lo`` the df64 block-diagonal inverse."""

    pin: object
    tf1: object            # f32 prepared lower factor (any trisolve form)
    dinv: jax.Array        # (N,) hi part of the inverse-pivot diagonal
    tf2: object            # f32 prepared reversed-upper factor
    pout: object
    dinv_sub: jax.Array | None
    t1: DFTriMat           # L + I (factor order)
    t2: DFTriMat           # J (L+I)' J — the matrix tf2 solves
    dinv_lo: jax.Array
    dinv_sub_lo: jax.Array | None
    nref: int = 2

    def _tri_df(self, tf, tmat: DFTriMat, b: df64.DF) -> df64.DF:
        x0 = tri_solve(tf, b[0])
        x = (x0, jnp.zeros_like(x0))
        for _ in range(self.nref):
            r = df64.df_add(b, df64.df_neg(tmat.matvec_df(x)))
            d = tri_solve(tf, r[0])
            x = df64.df_add(x, (d, jnp.zeros_like(d)))
        return x

    def _apply_dinv_df(self, w: df64.DF) -> df64.DF:
        wh, wl = w
        p, e = df64.two_prod(self.dinv, wh)
        e = e + self.dinv * wl + self.dinv_lo * wh
        if self.dinv_sub is not None:
            # tridiagonal 2x2-block coupling: y[p] += s[p] w[p+1],
            # y[p+1] += s[p] w[p] (cp.py _apply_dinv)
            sh = self.dinv_sub
            sl = self.dinv_sub_lo
            up_h = jnp.concatenate([wh[1:], jnp.zeros(1, wh.dtype)])
            up_l = jnp.concatenate([wl[1:], jnp.zeros(1, wh.dtype)])
            dn_h = jnp.concatenate([jnp.zeros(1, wh.dtype), wh[:-1]])
            dn_l = jnp.concatenate([jnp.zeros(1, wh.dtype), wl[:-1]])
            sh_dn = jnp.concatenate([jnp.zeros(1, wh.dtype), sh[:-1]])
            sl_dn = jnp.concatenate([jnp.zeros(1, wh.dtype), sl[:-1]])
            p1, e1 = df64.two_prod(sh, up_h)
            e1 = e1 + sh * up_l + sl * up_h
            p2, e2 = df64.two_prod(sh_dn, dn_h)
            e2 = e2 + sh_dn * dn_l + sl_dn * dn_h
            s_, c_ = df64.two_sum(p, p1)
            p, c2_ = df64.two_sum(s_, p2)
            e = e + e1 + e2 + c_ + c2_
        return df64.quick_two_sum(p, e)

    def solve_df(self, z: df64.DF) -> df64.DF:
        w = (self.pin.apply(z[0]), self.pin.apply(z[1]))
        w = self._tri_df(self.tf1, self.t1, w)
        w = self._apply_dinv_df(w)
        w = (jnp.flip(w[0]), jnp.flip(w[1]))
        w = self._tri_df(self.tf2, self.t2, w)
        w = (jnp.flip(w[0]), jnp.flip(w[1]))
        return (self.pout.apply_inv(w[0]), self.pout.apply_inv(w[1]))

    def solve(self, z: jax.Array) -> jax.Array:
        y = self.solve_df((z, jnp.zeros_like(z)))
        return y[0]


def build_df_factor_apply(factor, fac, N: int, nref: int = 2
                          ) -> DFFactorApply:
    """Wrap an existing f32 ``FactorApply`` with df64 factor data from the
    host LDL^T (``fac``: ldl_host.HostLDL — L, d, e in f64)."""
    import scipy.sparse as sp

    from .cp import _block_dinv

    L1 = (fac.L + sp.identity(N, format="csc")).tocsr()
    rev = np.arange(N - 1, -1, -1)
    U = L1.T.tocsr()
    T2 = U[rev][:, rev].tocsr()
    main, sub = _block_dinv(fac.d, fac.e)          # f64
    mh, ml = df64.df_from_f64(main)
    if sub is not None:
        sh, sl = df64.df_from_f64(sub)
        sub_hi, sub_lo = jnp.asarray(sh), jnp.asarray(sl)
    else:
        sub_hi = sub_lo = None
    return DFFactorApply(
        pin=factor.pin, tf1=factor.tf1, tf2=factor.tf2, pout=factor.pout,
        dinv=jnp.asarray(mh), dinv_lo=jnp.asarray(ml),
        dinv_sub=sub_hi, dinv_sub_lo=sub_lo,
        t1=_pack_df_tri(L1), t2=_pack_df_tri(T2),
        nref=int(nref))
