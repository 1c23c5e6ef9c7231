"""Double-f32 ("df64") arithmetic for device-resident f64-accurate residuals.

The mixed-precision outer refinement (mixed.solve_mixed) evaluates its true
residual r = b - K x in f64 on the host by default, paying two O(N)
host<->device transfers per outer pass.

This module keeps the refinement on device in f32 arithmetic: vectors (x, r, b) and the
operand diagonals of K are stored as UNEVALUATED PAIRS (hi, lo) of f32
arrays with |lo| <= ulp(hi)/2, giving ~2^-48 relative accuracy — 6 extra
digits beyond f32, ample for the reference stopping contract
``||r|| <= atol + rtol ||b||`` at rtol = 1e-6..1e-10 (reg_cpkrylov.m:163,
cpminres.m:164).  All building blocks are the classical error-free
transforms (Dekker 1971, Knuth TAOCP v2) — branch-free elementwise f32
code.  They are exact only if the compiler neither contracts a product and
a sum into one fused multiply-add nor reassociates; the tests check
``two_sum``/``two_prod`` bit-exactly against f64 on the backend they run on.

Used by mixed.solve_mixed's device-resident path: the f64-accurate DIA
matvec of the saddle operator K = [A B'; B -C], df64 axpy accumulation of
the solution, and the residual update — one f32-speed device pass each.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_SPLITTER = 4097.0   # 2^12 + 1 for binary32 (Dekker split)


def two_sum(a, b):
    """Error-free a + b: returns (s, e) with s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = a * jnp.float32(_SPLITTER)
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b: returns (p, e) with p + e == a * b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


DF = Tuple[jax.Array, jax.Array]   # (hi, lo) unevaluated pair


def df_from_f64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side split of an f64 array into an (hi, lo) f32 pair."""
    hi = np.asarray(x, np.float64).astype(np.float32)
    lo = (np.asarray(x, np.float64) - hi.astype(np.float64)).astype(
        np.float32)
    return hi, lo


def df_to_f64(hi, lo) -> np.ndarray:
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def df_add(x: DF, y: DF) -> DF:
    s, e = two_sum(x[0], y[0])
    return quick_two_sum(s, e + x[1] + y[1])


def df_neg(x: DF) -> DF:
    return (-x[0], -x[1])


def df_scale_f32(x: DF, a) -> DF:
    """df64 x * f32 scalar a."""
    p, e = two_prod(x[0], a)
    return quick_two_sum(p, e + x[1] * a)


def df_axpy(alpha, d, x: DF) -> DF:
    """x + alpha * d with f32 alpha (scalar) and f32 vector d."""
    p, e = two_prod(jnp.broadcast_to(alpha, d.shape), d)
    s, e2 = two_sum(x[0], p)
    return quick_two_sum(s, e2 + e + x[1])


def df_dot_hi(x: DF, y: DF):
    """Dot product accurate enough for norm-based stopping control: the hi
    parts carry the value to f32 relative accuracy, which is ~1e-7 —
    orders beyond what a tolerance comparison needs."""
    return jnp.dot(x[0], y[0], precision=jax.lax.Precision.HIGHEST)


def df_norm_hi(x: DF):
    return jnp.linalg.norm(x[0])


# ---------------------------------------------------------------------------
# df64 DIA operands
# ---------------------------------------------------------------------------

def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields))


@partial(_register, data_fields=("hi", "lo"),
         meta_fields=("offsets", "shape"))
@dataclasses.dataclass(frozen=True)
class DFDia:
    """DIA-format matrix stored as an (hi, lo) f32 pair of diagonal stacks.

    ``hi[k] + lo[k]`` reproduces the f64 diagonal to ~2^-48 relative;
    rectangular blocks follow ops.dia.DIA's offset convention."""

    hi: jax.Array        # (ndiag, nrows) f32
    lo: jax.Array        # (ndiag, nrows) f32
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]


def pack_df_dia(mat, max_bytes_ratio: float = 3.0) -> DFDia | None:
    """Pack a scipy matrix into df64 DIA form; None when the diagonal fill
    is too sparse for padded storage to pay (same gate spirit as
    ops.dia.pack_dia — the caller then keeps the host-resident loop)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat).astype(np.float64)
    csr.sum_duplicates()
    nrows, ncols = csr.shape
    coo = csr.tocoo()
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq = np.unique(off) if coo.nnz else np.array([0], np.int64)
    if csr.nnz and uniq.size * nrows * 8 > max_bytes_ratio * csr.nnz * 12.0:
        return None
    data = np.zeros((uniq.size, nrows), np.float64)
    if coo.nnz:
        k = np.searchsorted(uniq, off)
        data[k, coo.row] = coo.data
    hi, lo = df_from_f64(data)
    return DFDia(hi=jnp.asarray(hi), lo=jnp.asarray(lo),
                 offsets=tuple(int(o) for o in uniq),
                 shape=(int(nrows), int(ncols)))


def _pads(offsets, nrows, ncols):
    neg = max(0, -min(offsets))
    pos = max(0, max(offsets) + nrows - ncols)
    return neg, pos


def df_dia_matvec(mat: DFDia, x: DF) -> DF:
    """y = mat @ x in df64: error-free products of the hi terms plus the
    first-order cross terms (hi*lo + lo*hi); the lo*lo term (~2^-96) is
    dropped.  Accumulation via two_sum chains keeps the result a valid
    (hi, lo) pair."""
    nrows, ncols = mat.shape
    neg, pos = _pads(mat.offsets, nrows, ncols)
    xh = jnp.pad(x[0], (neg, pos))
    xl = jnp.pad(x[1], (neg, pos))
    acc_h = jnp.zeros(nrows, jnp.float32)
    acc_l = jnp.zeros(nrows, jnp.float32)
    for k, off in enumerate(mat.offsets):
        vh = jax.lax.dynamic_slice_in_dim(xh, neg + off, nrows)
        vl = jax.lax.dynamic_slice_in_dim(xl, neg + off, nrows)
        dh = mat.hi[k]
        dl = mat.lo[k]
        p, e = two_prod(dh, vh)
        e = e + dh * vl + dl * vh
        acc_h, e2 = two_sum(acc_h, p)
        acc_l = acc_l + e + e2
    return quick_two_sum(acc_h, acc_l)


@partial(_register, data_fields=("a", "bt", "b", "c_diag"),
         meta_fields=("n", "m"))
@dataclasses.dataclass(frozen=True)
class DFSaddle:
    """df64 saddle operator K = [A B'; B -C] as four DIA/diag blocks.

    ``bt`` stores B' as its own rectangular DFDia so both products are
    gather-free shifted FMA chains (no scatter-form rmatvec needed)."""

    a: DFDia             # (n, n)
    bt: DFDia            # (n, m)  — B transpose
    b: DFDia             # (m, n)
    c_diag: DF           # (m,) diagonal of C
    n: int
    m: int

    def matvec(self, x: DF) -> DF:
        n = self.n
        x1 = (x[0][:n], x[1][:n])
        x2 = (x[0][n:], x[1][n:])
        y1 = df_add(df_dia_matvec(self.a, x1),
                    df_dia_matvec(self.bt, x2))
        cy_h, cy_e = two_prod(self.c_diag[0], x2[0])
        cy = quick_two_sum(
            cy_h, cy_e + self.c_diag[0] * x2[1] + self.c_diag[1] * x2[0])
        y2 = df_add(df_dia_matvec(self.b, x1), df_neg(cy))
        return (jnp.concatenate([y1[0], y2[0]]),
                jnp.concatenate([y1[1], y2[1]]))


def pack_df_saddle(A, B, C) -> DFSaddle | None:
    """Pack explicit host blocks into a df64 saddle operator; None when C
    is not diagonal (the general case falls back to the host-resident
    refinement loop)."""
    import scipy.sparse as sp

    C = sp.csr_matrix(C)
    offd = C - sp.diags(C.diagonal())
    if offd.nnz:
        return None
    a = pack_df_dia(A)
    B = sp.csr_matrix(B)
    b = pack_df_dia(B)
    bt = pack_df_dia(B.T.tocsr())
    if a is None or b is None or bt is None:
        return None
    ch, cl = df_from_f64(C.diagonal())
    return DFSaddle(a=a, bt=bt, b=b,
                    c_diag=(jnp.asarray(ch), jnp.asarray(cl)),
                    n=int(A.shape[0]), m=int(C.shape[0]))
