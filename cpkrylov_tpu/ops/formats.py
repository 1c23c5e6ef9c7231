"""Sparse matrix containers as JAX pytrees.

Design notes
------------
All containers use *static* shapes (padded where necessary) so that every
consumer can be traced once by XLA.  Two device layouts are provided:

* ``CSR`` — coordinate-sorted CSR with an explicit ``row_ids`` array so a
  matvec is a gather + multiply + ``segment_sum`` (well supported by XLA on
  CPU and GPU).
* ``ELL`` — ELLPACK layout ``data[rows, K]`` / ``cols[rows, K]`` with rows
  padded to a common nnz-per-row ``K``.  SpMV vectorises as
  ``(data * x[cols]).sum(axis=1)``.

The reference framework (MATLAB cpkrylov, see /root/reference) relies on
MATLAB's built-in sparse matrices for all of ``A*v``, ``C*q``, ``B'*y``
(e.g. kernels/cpminres.m:187-188, reg_cpkrylov.m:157); these containers and
the matvecs in ``ops/spmv.py`` are the device replacement.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@partial(_register, data_fields=("data", "indices", "row_ids", "indptr"),
         meta_fields=("shape",))
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix (row-sorted COO + indptr), padded.

    Padding entries carry ``data == 0`` and point at row 0 / col 0, so they
    contribute nothing to matvec results.
    """

    data: jax.Array      # (nnz_pad,) values
    indices: jax.Array   # (nnz_pad,) int32 column indices
    row_ids: jax.Array   # (nnz_pad,) int32 row indices (sorted ascending)
    indptr: jax.Array    # (nrows + 1,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "CSR":
        return dataclasses.replace(self, data=self.data.astype(dtype))


@partial(_register, data_fields=("data", "cols"), meta_fields=("shape",))
@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK layout: each row padded to a common ``K`` nonzeros.

    Padding entries have ``data == 0`` and ``cols == 0``.
    """

    data: jax.Array   # (nrows, K)
    cols: jax.Array   # (nrows, K) int32
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def row_width(self) -> int:
        return self.data.shape[1]

    def astype(self, dtype) -> "ELL":
        return dataclasses.replace(self, data=self.data.astype(dtype))


@partial(_register, data_fields=("data", "block_cols", "block_rows"),
         meta_fields=("shape", "blocksize"))
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block sparse row: dense (bs, bs) blocks at sparse block positions.

    Each stored block is a small dense matrix, so SpMV/SpMM contract via a
    batched einsum instead of scalar gathers.  Zero-padding blocks (``data == 0`` pointing at block
    row/col 0) contribute nothing.
    """

    data: jax.Array         # (nblocks, bs, bs)
    block_cols: jax.Array   # (nblocks,) int32 block-column ids (sorted by row)
    block_rows: jax.Array   # (nblocks,) int32 block-row ids, ascending
    shape: Tuple[int, int]  # padded element shape (multiples of bs)
    blocksize: int

    @property
    def nnz(self) -> int:
        return int(np.prod(self.data.shape))

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "BSR":
        return dataclasses.replace(self, data=self.data.astype(dtype))


@partial(_register, data_fields=("diag",), meta_fields=())
@dataclasses.dataclass(frozen=True)
class Diagonal:
    """Diagonal matrix; matvec is a single elementwise multiply."""

    diag: jax.Array  # (n,)

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype


# ---------------------------------------------------------------------------
# Host-side converters (numpy / scipy -> device containers)
# ---------------------------------------------------------------------------

def _to_scipy_csr(mat):
    import scipy.sparse as sp

    if sp.issparse(mat):
        return mat.tocsr()
    arr = np.asarray(mat)
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got shape {arr.shape}")
    return sp.csr_matrix(arr)


def csr_from_scipy(mat, dtype=None, pad_to: int | None = None) -> CSR:
    """Build a device ``CSR`` from a scipy sparse / dense matrix."""
    sm = _to_scipy_csr(mat)
    sm.sum_duplicates()
    nrows, ncols = sm.shape
    data = np.asarray(sm.data)
    if dtype is not None:
        data = data.astype(dtype)
    indices = np.asarray(sm.indices, dtype=np.int32)
    indptr = np.asarray(sm.indptr, dtype=np.int32)
    row_ids = np.repeat(np.arange(nrows, dtype=np.int32), np.diff(indptr))
    nnz = data.shape[0]
    target = max(pad_to or 0, nnz, 1)
    if target > nnz:
        pad = target - nnz
        data = np.concatenate([data, np.zeros(pad, dtype=data.dtype)])
        indices = np.concatenate([indices, np.zeros(pad, dtype=np.int32)])
        # keep row_ids sorted: pad with the last row index
        last = np.int32(nrows - 1) if nrows else np.int32(0)
        row_ids = np.concatenate([row_ids, np.full(pad, last, dtype=np.int32)])
    return CSR(
        data=jnp.asarray(data),
        indices=jnp.asarray(indices),
        row_ids=jnp.asarray(row_ids),
        indptr=jnp.asarray(indptr),
        shape=(int(nrows), int(ncols)),
    )


def ell_from_scipy(mat, dtype=None, row_width: int | None = None,
                   lane_pad: int = 1) -> ELL:
    """Build a device ``ELL`` from a scipy sparse / dense matrix.

    ``row_width`` pads rows to at least that many entries; ``lane_pad`` rounds
    the row count up to a multiple (e.g. 8 for f32 sublane tiling).
    """
    sm = _to_scipy_csr(mat)
    sm.sum_duplicates()
    nrows, ncols = sm.shape
    counts = np.diff(sm.indptr)
    k = int(counts.max()) if counts.size else 0
    k = max(k, row_width or 0, 1)
    nrows_pad = -(-max(nrows, 1) // lane_pad) * lane_pad
    data = np.zeros((nrows_pad, k), dtype=dtype or sm.data.dtype)
    cols = np.zeros((nrows_pad, k), dtype=np.int32)
    # scatter each row's entries into its padded slot
    if sm.nnz:
        offs = np.concatenate([np.arange(c) for c in counts]) if counts.size else np.zeros(0, int)
        rows = np.repeat(np.arange(nrows), counts)
        data[rows, offs] = sm.data
        cols[rows, offs] = sm.indices
    return ELL(data=jnp.asarray(data), cols=jnp.asarray(cols),
               shape=(int(nrows), int(ncols)))


def bsr_from_scipy(mat, blocksize: int = 8, dtype=None) -> BSR:
    """Build a device ``BSR`` from a scipy sparse / dense matrix.

    The element shape is padded up to multiples of ``blocksize``; scipy's
    own BSR conversion finds the occupied blocks.
    """
    import scipy.sparse as sp

    sm = _to_scipy_csr(mat)
    nrows, ncols = sm.shape
    bs = int(blocksize)
    rpad = -(-nrows // bs) * bs
    cpad = -(-ncols // bs) * bs
    if rpad != nrows or cpad != ncols:
        sm = sp.csr_matrix((sm.data, sm.indices, sm.indptr),
                           shape=(nrows, ncols))
        sm.resize((rpad, cpad))
    sb = sm.tobsr(blocksize=(bs, bs))
    sb.sum_duplicates()
    data = np.asarray(sb.data)
    if dtype is not None:
        data = data.astype(dtype)
    nb = data.shape[0]
    block_rows = np.repeat(np.arange(rpad // bs, dtype=np.int32),
                           np.diff(sb.indptr))
    block_cols = np.asarray(sb.indices, dtype=np.int32)
    if nb == 0:  # keep static shapes: one explicit zero block
        data = np.zeros((1, bs, bs), dtype=dtype or sm.data.dtype)
        block_rows = np.zeros(1, dtype=np.int32)
        block_cols = np.zeros(1, dtype=np.int32)
    return BSR(data=jnp.asarray(data), block_cols=jnp.asarray(block_cols),
               block_rows=jnp.asarray(block_rows),
               shape=(int(rpad), int(cpad)), blocksize=bs)


def csr_to_scipy(mat: CSR):
    import scipy.sparse as sp

    data = np.asarray(mat.data)
    rows = np.asarray(mat.row_ids)
    cols = np.asarray(mat.indices)
    keep = data != 0
    return sp.csr_matrix(
        (data[keep], (rows[keep], cols[keep])), shape=mat.shape
    )
