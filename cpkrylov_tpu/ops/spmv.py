"""Sparse matrix-vector products, written in plain JAX for XLA.

They replace the implicit native SpMV of the MATLAB reference (every
``A*v`` / ``C*q`` / ``B'*y``, e.g. /root/reference/kernels/cpminres.m:187-188).
Dense contractions pass ``precision=HIGHEST`` so that float32 products do
not run in TF32 on GPUs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .dia import (DIA, DIASpill, dia_matmat, dia_matvec, dia_rmatvec,
                  dia_spill_matvec)
from .formats import BSR, CSR, ELL, Diagonal
from .pgell import PGELL, SymPermuted, pgell_matvec_reference

_HI = jax.lax.Precision.HIGHEST


def csr_matvec(mat: CSR, x: jax.Array) -> jax.Array:
    """y = mat @ x via gather + segment_sum (row-sorted COO)."""
    vals = mat.data * jnp.take(x, mat.indices, mode="clip")
    return jax.ops.segment_sum(
        vals, mat.row_ids, num_segments=mat.shape[0], indices_are_sorted=True
    )


def csr_rmatvec(mat: CSR, y: jax.Array) -> jax.Array:
    """x = mat.T @ y via scatter-add over column indices (unsorted)."""
    vals = mat.data * jnp.take(y, mat.row_ids, mode="clip")
    return jax.ops.segment_sum(vals, mat.indices, num_segments=mat.shape[1])


def ell_matvec(mat: ELL, x: jax.Array) -> jax.Array:
    """y = mat @ x; fully vectorised over the padded (rows, K) layout."""
    gathered = jnp.take(x, mat.cols, mode="clip")
    y = (mat.data * gathered).sum(axis=1)
    return y[: mat.shape[0]]


def diag_matvec(mat: Diagonal, x: jax.Array) -> jax.Array:
    return mat.diag * x


def bsr_matvec(mat: BSR, x: jax.Array) -> jax.Array:
    """y = mat @ x: batched dense (bs, bs) @ (bs,) per stored block,
    accumulated by block row.  ``x`` is zero-padded to the block grid."""
    bs = mat.blocksize
    ncb = mat.shape[1] // bs
    xb = jnp.pad(x, (0, mat.shape[1] - x.shape[0])).reshape(ncb, bs)
    gathered = jnp.take(xb, mat.block_cols, axis=0, mode="clip")
    prod = jnp.einsum("nij,nj->ni", mat.data, gathered, precision=_HI)
    yb = jax.ops.segment_sum(prod, mat.block_rows,
                             num_segments=mat.shape[0] // bs,
                             indices_are_sorted=True)
    return yb.reshape(-1)


def sym_permuted_matvec(mat: SymPermuted, x: jax.Array) -> jax.Array:
    yp = matvec(mat.inner, jnp.take(x, mat.perm))
    return jnp.take(yp, mat.iperm)


def matvec(mat, x: jax.Array) -> jax.Array:
    if isinstance(mat, CSR):
        return csr_matvec(mat, x)
    if isinstance(mat, ELL):
        return ell_matvec(mat, x)
    if isinstance(mat, BSR):
        return bsr_matvec(mat, x)
    if isinstance(mat, Diagonal):
        return diag_matvec(mat, x)
    if isinstance(mat, DIA):
        return dia_matvec(mat, x)
    if isinstance(mat, DIASpill):
        return dia_spill_matvec(mat, x)
    if isinstance(mat, SymPermuted):
        return sym_permuted_matvec(mat, x)
    if isinstance(mat, PGELL):
        return pgell_matvec_reference(mat, x)
    if isinstance(mat, jax.Array) or hasattr(mat, "ndim"):
        return jnp.matmul(jnp.asarray(mat), x, precision=_HI)
    raise TypeError(f"unsupported matrix type {type(mat)}")


# ---------------------------------------------------------------------------
# SpMM — sparse x dense-block (multi-RHS) products
# ---------------------------------------------------------------------------

def csr_matmat(mat: CSR, X: jax.Array) -> jax.Array:
    """Y = mat @ X for a dense (ncols, r) block of right-hand sides."""
    vals = mat.data[:, None] * jnp.take(X, mat.indices, axis=0, mode="clip")
    return jax.ops.segment_sum(vals, mat.row_ids, num_segments=mat.shape[0],
                               indices_are_sorted=True)


def ell_matmat(mat: ELL, X: jax.Array) -> jax.Array:
    """Y = mat @ X; gathers (rows, K, r) operand tiles, contracts over K."""
    gathered = jnp.take(X, mat.cols, axis=0, mode="clip")  # (rows, K, r)
    Y = jnp.einsum("rk,rkc->rc", mat.data, gathered, precision=_HI)
    return Y[: mat.shape[0]]


def bsr_matmat(mat: BSR, X: jax.Array) -> jax.Array:
    """Y = mat @ X: (bs, bs) @ (bs, r) dense block contractions."""
    bs = mat.blocksize
    r = X.shape[1]
    ncb = mat.shape[1] // bs
    Xb = jnp.pad(X, ((0, mat.shape[1] - X.shape[0]), (0, 0)))
    Xb = Xb.reshape(ncb, bs, r)
    gathered = jnp.take(Xb, mat.block_cols, axis=0, mode="clip")
    prod = jnp.einsum("nij,njr->nir", mat.data, gathered, precision=_HI)
    Yb = jax.ops.segment_sum(prod, mat.block_rows,
                             num_segments=mat.shape[0] // bs,
                             indices_are_sorted=True)
    return Yb.reshape(mat.shape[0], r)


def matmat(mat, X: jax.Array) -> jax.Array:
    """Sparse x dense SpMM dispatch (SURVEY.md §2.3 north-star table)."""
    if isinstance(mat, CSR):
        return csr_matmat(mat, X)
    if isinstance(mat, ELL):
        return ell_matmat(mat, X)
    if isinstance(mat, BSR):
        return bsr_matmat(mat, X)
    if isinstance(mat, Diagonal):
        return mat.diag[:, None] * X
    if isinstance(mat, DIA):
        return dia_matmat(mat, X)
    if isinstance(mat, DIASpill):
        return dia_matmat(mat.dia, X) + csr_matmat(mat.spill, X)
    if isinstance(mat, SymPermuted):
        return jnp.take(matmat(mat.inner, jnp.take(X, mat.perm, axis=0)),
                        mat.iperm, axis=0)
    if isinstance(mat, jax.Array) or hasattr(mat, "ndim"):
        return jnp.matmul(jnp.asarray(mat), X, precision=_HI)
    raise TypeError(f"unsupported matrix type {type(mat)}")
