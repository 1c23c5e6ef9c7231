"""Halo-exchange SpMV for row-partitioned blocks.

Instead of all-gathering the whole operand vector per matvec (O(N) bytes
over ICI), each device exchanges only the *edge regions* its neighbours'
rows actually reference — the ring/neighbor pattern of SURVEY.md §2.4.  The
plan is computed on the host:

  * operand x of length ``cols`` is partitioned into ``ndev`` chunks of
    ``c_loc``;
  * device d's row block may reference columns in
    ``[d*r... - H, (d+1)*c_loc + H)`` for a halo width H = the maximum
    off-chunk reach over all devices (checked by the planner; matrices with
    longer reach fall back to all-gather);
  * column indices are rewritten into extended-vector coordinates
    ``H + (c - d*c_loc)``;
  * at runtime, the left/right edges travel by a single
    ``lax.ppermute`` each, and the matvec reads
    ``x_ext = [left_halo | x_loc | right_halo]``.

The design lever is exchange SIZE, not latency hiding: for banded systems
the two edge permutes move tens of bytes per device per iteration against
megabytes of local SpMV traffic, so the exchange is negligible whether or
not the backend overlaps it with local work.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

AXIS = "rows"


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@partial(_register, data_fields=("data", "cols"),
         meta_fields=("halo", "rows_loc", "cols_loc", "shape"))
@dataclasses.dataclass(frozen=True)
class HaloBlock:
    """Row-partitioned ELL block with halo-relative column indices.

    ``data``/``cols`` are stacked (ndev, rows_loc, K); ``cols`` index into
    the extended operand ``[left halo | local chunk | right halo]`` of
    length ``halo + cols_loc + halo``.
    """

    data: jax.Array
    cols: jax.Array
    halo: int
    rows_loc: int
    cols_loc: int
    shape: Tuple[int, int]


def plan_halo_block(mat, ndev: int, rows_loc: int, cols_loc: int,
                    dtype=np.float64, max_halo: int | None = None
                    ) -> HaloBlock:
    """Build a HaloBlock; raises ValueError if the needed halo exceeds
    ``max_halo`` (default: the chunk size — beyond that all-gather wins)."""
    csr = sp.csr_matrix(mat)
    nrows, ncols = csr.shape
    if max_halo is None:
        max_halo = cols_loc

    # halo width: max off-chunk reach of any row
    halo = 0
    k = max(1, int(np.diff(csr.indptr).max()) if csr.nnz else 1)
    coo = csr.tocoo()
    dev = coo.row // rows_loc
    lo_reach = dev * cols_loc - coo.col
    hi_reach = coo.col - ((dev + 1) * cols_loc - 1)
    if coo.nnz:
        halo = int(max(0, lo_reach.max(), hi_reach.max()))
    if halo > max_halo:
        raise ValueError(
            f"halo width {halo} exceeds max {max_halo}; use all-gather")
    # pad halo to the chunk boundary never exceeded
    halo = min(halo, cols_loc)

    data = np.zeros((ndev, rows_loc, k), dtype)
    cols = np.zeros((ndev, rows_loc, k), np.int32)
    if csr.nnz:
        # vectorized O(nnz) scatter (no per-row Python work)
        counts = np.diff(csr.indptr)
        offs = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        rr = np.repeat(np.arange(nrows), counts)
        d = rr // rows_loc
        data[d, rr % rows_loc, offs] = csr.data
        cols[d, rr % rows_loc, offs] = halo + (csr.indices - d * cols_loc)
    return HaloBlock(data=jnp.asarray(data), cols=jnp.asarray(cols),
                     halo=int(halo), rows_loc=int(rows_loc),
                     cols_loc=int(cols_loc), shape=(int(nrows), int(ncols)))


def halo_extend(x_loc: jax.Array, halo: int, axis_name: str = AXIS):
    """Build [left halo | x_loc | right halo] via two ppermutes.

    Call inside shard_map; x_loc is this device's (cols_loc,) chunk.
    Edge devices receive zeros (their out-of-range halo entries are never
    referenced by a valid plan).
    """
    if halo == 0:
        return x_loc
    nd = jax.lax.axis_size(axis_name)
    # receive my LEFT halo = right edge of device d-1
    left = jax.lax.ppermute(
        x_loc[-halo:], axis_name,
        perm=[(i, (i + 1) % nd) for i in range(nd)])
    # receive my RIGHT halo = left edge of device d+1
    right = jax.lax.ppermute(
        x_loc[:halo], axis_name,
        perm=[(i, (i - 1) % nd) for i in range(nd)])
    d = jax.lax.axis_index(axis_name)
    left = jnp.where(d == 0, 0.0, left)
    right = jnp.where(d == nd - 1, 0.0, right)
    return jnp.concatenate([left, x_loc, right])


def halo_matvec(blk_data: jax.Array, blk_cols: jax.Array, x_ext: jax.Array):
    """Local ELL matvec against the extended operand (inside shard_map)."""
    return (blk_data * jnp.take(x_ext, blk_cols, mode="clip")).sum(-1)


def halo_fold(x_ext: jax.Array, halo: int, axis_name: str = AXIS):
    """Adjoint of ``halo_extend``: fold an extended vector's edge regions
    back onto the neighbours that own them (two ppermutes + two adds).

    Used by scatter-style operations whose local writes may land in the
    halo margins (e.g. the Schur factor's sharded y-scatter): device d's
    left margin belongs to device d-1's tail, its right margin to device
    d+1's head.  Edge devices contribute nothing across the boundary.
    """
    if halo == 0:
        return x_ext
    nd = jax.lax.axis_size(axis_name)
    d = jax.lax.axis_index(axis_name)
    left_edge = x_ext[:halo]
    right_edge = x_ext[-halo:]
    center = x_ext[halo:-halo]
    # my tail += right neighbour's LEFT margin
    from_right = jax.lax.ppermute(
        left_edge, axis_name, perm=[(i, (i - 1) % nd) for i in range(nd)])
    # my head += left neighbour's RIGHT margin
    from_left = jax.lax.ppermute(
        right_edge, axis_name, perm=[(i, (i + 1) % nd) for i in range(nd)])
    from_right = jnp.where(d == nd - 1, 0.0, from_right)
    from_left = jnp.where(d == 0, 0.0, from_left)
    return center.at[:halo].add(from_left).at[-halo:].add(from_right)
