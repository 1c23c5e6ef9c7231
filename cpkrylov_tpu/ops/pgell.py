"""PGELL — paged-gather ELL, a sparse layout for locally banded matrices.

PGELL organizes SpMV so that the only data-dependent access is a gather
within a page of 128 entries of x; every other data movement is dense:

  * x is viewed as pages of 128 lanes: ``x2d (P, 128)``; each row tile reads
    a contiguous window of Wp pages.
  * slot-rows are page-major with a *uniform* depth D (slot s serves page
    ``s // D``), so replicating each page's 128 lanes across its D slot-rows
    is a free broadcast + reshape — no page-selection matmul.
  * each nonzero (r, c, v) sits at slot lane ``r % 128`` (encoding its
    destination row within its 128-row bucket) and stores ``c % 128`` as its
    LUT index; the per-entry x element is picked with an in-page gather.
  * accumulation into output buckets: for banded matrices each bucket's
    entries live in a short *contiguous* range of page-major slots
    (host-precomputed), so ``y[bucket]`` is a masked sum over that range —
    a handful of vector passes, no matmul.

Metadata (lane LUT index, bucket id) is int8, keeping HBM traffic near
4 B + 2 B per slot entry.  The format is profitable for locally-banded
matrices (e.g. RCM-ordered KKT systems); density = nnz / slot capacity is
the main efficiency knob and is reported by ``nnz_density``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

LANE = 128


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@partial(_register,
         data_fields=("vals", "lane_idx", "bucket_map", "wstart", "lo"),
         meta_fields=("shape", "tile_rows", "wp", "depth", "rng_len", "nnz",
                      "xpages"))
@dataclasses.dataclass(frozen=True)
class PGELL:
    """Packed matrix; T row tiles, S = Wp * D slot-rows per tile."""

    vals: jax.Array        # (T, S, 128) f32 entry values (0 = padding)
    lane_idx: jax.Array    # (T, S, 128) i8 source lane (col % 128)
    bucket_map: jax.Array  # (T, S, 128) i8 destination bucket (-1 = padding)
    wstart: jax.Array      # (T,)  i32 first x page of the tile window
    lo: jax.Array          # (T, B) i32 start slot of each bucket's range
    shape: Tuple[int, int]
    tile_rows: int         # TR (multiple of 128); buckets B = TR // 128
    wp: int                # pages per window
    depth: int             # uniform slot depth D per page
    rng_len: int           # padded bucket-range length R (multiple of 8)
    nnz: int = 0           # true stored nonzeros (excludes slot padding)
    xpages: int = 0        # padded x pages (covers every 8-aligned window)

    @property
    def ntiles(self) -> int:
        return self.vals.shape[0]

    @property
    def s_rows(self) -> int:
        return self.vals.shape[1]

    @property
    def buckets(self) -> int:
        return self.tile_rows // LANE

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz_density(self) -> float:
        """Fraction of slot capacity holding real entries."""
        return float((np.asarray(self.bucket_map) >= 0).mean())

    @property
    def device_bytes(self) -> int:
        """HBM bytes one matvec must read (vals + int8 metadata + lo)."""
        itemsize = np.dtype(self.vals.dtype).itemsize
        return int(self.vals.size * (itemsize + 2) + self.lo.size * 4)


def pack_pgell(mat, tile_rows: int = 2048, min_wp: int = 1,
               dtype=np.float32) -> PGELL:
    """Pack a scipy sparse matrix into PGELL.

    ``tile_rows`` must be a multiple of 128 and at most 16128 (bucket ids
    are int8).  Window size Wp and depth D are the maxima over tiles, so the
    format suits locally banded matrices.
    """
    if tile_rows % LANE:
        raise ValueError("tile_rows must be a multiple of 128")
    if tile_rows // LANE > 126:
        raise ValueError("tile_rows > 16128 overflows int8 bucket ids")
    csr = sp.csr_matrix(mat)
    csr.sum_duplicates()
    nrows, ncols = csr.shape
    npages = -(-max(ncols, 1) // LANE)
    ntiles = max(1, -(-nrows // tile_rows))
    nb = tile_rows // LANE

    # Per-tile page spans -> global Wp and window starts (both 8-aligned).
    spans, p0_list = [], []
    for t in range(ntiles):
        r0, r1 = t * tile_rows, min((t + 1) * tile_rows, nrows)
        cols = csr.indices[csr.indptr[r0]:csr.indptr[r1]]
        if cols.size:
            pmin, pmax = int(cols.min()) // LANE, int(cols.max()) // LANE
        else:
            pmin = pmax = 0
        pmin = (pmin // 8) * 8
        spans.append(pmax - pmin + 1)
        p0_list.append(pmin)
    wp = max(min_wp, max(spans))
    wp = -(-wp // 8) * 8
    p0s = np.asarray(p0_list, np.int64)
    # Total padded x pages: every window must fit.
    xpages = int(max(-(-npages // 8) * 8, (p0s + wp).max() if ntiles else wp))

    coo = csr.tocoo()
    er = coo.row.astype(np.int64)
    ec = coo.col.astype(np.int64)
    ev = coo.data
    tile = er // tile_rows
    bucket = (er % tile_rows) // LANE
    lane = er % LANE
    page = ec // LANE - p0s[tile]
    lidx = (ec % LANE).astype(np.int8)

    # depth = occurrence rank within (tile, page, lane)
    gkey = (tile * wp + page) * LANE + lane
    order = np.argsort(gkey, kind="stable")
    gs = gkey[order]
    new = np.empty(gs.shape, bool)
    new[:1] = True
    new[1:] = gs[1:] != gs[:-1]
    start = np.maximum.accumulate(np.where(new, np.arange(gs.size), 0))
    depth = np.empty_like(gs)
    depth[order] = np.arange(gs.size) - start

    D = int(depth.max()) + 1 if depth.size else 1
    S = wp * D
    # int8 arrays tile as (32, 128): slot count and range starts/lengths
    # must be 32-aligned, which also covers f32's (8, 128) tiling.
    S_pad = -(-S // 32) * 32
    slot = page * D + depth

    T = ntiles
    vals = np.zeros((T, S_pad, LANE), dtype)
    lane_idx = np.zeros((T, S_pad, LANE), np.int8)
    bucket_map = np.full((T, S_pad, LANE), -1, np.int8)   # -1 = padding
    vals[tile, slot, lane] = ev
    lane_idx[tile, slot, lane] = lidx
    bucket_map[tile, slot, lane] = bucket.astype(np.int8)

    # Bucket slot ranges: bucket b touches pages [minp_b, maxp_b] ->
    # slots [minp_b * D, (maxp_b + 1) * D).
    tb = tile * nb + bucket
    minp = np.full(T * nb, S, np.int64)
    maxp = np.full(T * nb, -1, np.int64)
    if er.size:
        np.minimum.at(minp, tb, page)
        np.maximum.at(maxp, tb, page)
    minp = minp.reshape(T, nb)
    maxp = maxp.reshape(T, nb)
    empty = maxp < 0
    minp[empty] = 0
    maxp[empty] = -1
    lo = minp * D
    hi = (maxp + 1) * D
    lo = (lo // 32) * 32              # align first, then size the range
    rng = int((hi - lo).max()) if er.size else 32
    rng = max(32, -(-rng // 32) * 32)
    rng = min(rng, S_pad)
    lo = np.minimum(lo, S_pad - rng)
    lo = np.maximum(lo, 0)

    return PGELL(
        vals=jnp.asarray(vals), lane_idx=jnp.asarray(lane_idx),
        bucket_map=jnp.asarray(bucket_map),
        wstart=jnp.asarray(p0s.astype(np.int32)),
        lo=jnp.asarray(lo.astype(np.int32)),
        shape=(int(nrows), int(ncols)), tile_rows=int(tile_rows),
        wp=int(wp), depth=int(D), rng_len=int(rng), nnz=int(csr.nnz),
        xpages=xpages,
    )


def pad_x_pages(x: jax.Array, mat: "PGELL") -> jax.Array:
    """Reshape x to padded (P, 128) pages covering every tile window."""
    npages = -(-max(mat.shape[1], 1) // LANE)
    npages_pad = max(npages, mat.wp, mat.xpages)
    total = npages_pad * LANE
    xp = jnp.zeros(total, x.dtype).at[: x.shape[0]].set(x)
    return xp.reshape(npages_pad, LANE)


def pgell_matvec_reference(mat: PGELL, x: jax.Array) -> jax.Array:
    """jnp reference implementation (for tests; mirrors the kernel math)."""
    x2d = pad_x_pages(x, mat)
    S = mat.s_rows
    B = mat.buckets
    D = mat.depth
    R = mat.rng_len

    def tile(t):
        win = jax.lax.dynamic_slice_in_dim(x2d, mat.wstart[t], mat.wp, 0)
        g1 = jnp.broadcast_to(win[:, None, :].astype(x.dtype),
                              (mat.wp, D, LANE)).reshape(mat.wp * D, LANE)
        g1 = jnp.concatenate(
            [g1, jnp.zeros((S - mat.wp * D, LANE), x.dtype)], axis=0)
        g2 = jnp.take_along_axis(g1, mat.lane_idx[t].astype(jnp.int32),
                                 axis=1)
        prod = mat.vals[t].astype(x.dtype) * g2
        bmap = mat.bucket_map[t].astype(jnp.int32)

        def bucket_sum(b):
            sl = mat.lo[t, b]
            z = jnp.zeros((), sl.dtype)
            seg = jax.lax.dynamic_slice(prod, (sl, z), (R, LANE))
            mseg = jax.lax.dynamic_slice(bmap, (sl, z), (R, LANE))
            return jnp.where(mseg == b, seg, 0).sum(axis=0)

        return jax.vmap(bucket_sum)(jnp.arange(B)).reshape(-1)

    y = jax.vmap(tile)(jnp.arange(mat.ntiles)).reshape(-1)
    return y[: mat.shape[0]]


# ---------------------------------------------------------------------------
# Symmetric-permutation wrapper — makes PGELL usable on saddle-point KKT
# matrices, whose natural ordering has terrible locality (the B block couples
# row i with column n+i, so a raw PGELL window would span the whole matrix).
# ---------------------------------------------------------------------------

@partial(_register, data_fields=("inner", "perm", "iperm"), meta_fields=("shape",))
@dataclasses.dataclass(frozen=True)
class SymPermuted:
    """A square matrix stored as ``inner = M[perm][:, perm]`` (PGELL).

    ``M @ x == (inner @ x[perm])[iperm]`` for any square M under a symmetric
    permutation, so one RCM reordering makes the banded-friendly PGELL layout
    apply to general KKT systems (the reference's ``A*v`` / K_P SpMVs, e.g.
    /root/reference/kernels/cpminres.m:187, ops/opLDL2.m:170-175).
    """

    inner: PGELL
    perm: jax.Array    # (N,) int32
    iperm: jax.Array   # (N,) int32, argsort(perm)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.inner.nnz

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def nnz_density(self) -> float:
        return self.inner.nnz_density

    @property
    def device_bytes(self) -> int:
        # inner traffic + the two int32 index gathers and the gathered/
        # scattered operand vectors (4 + 4 bytes per row each side).
        return self.inner.device_bytes + 16 * self.perm.shape[0]


def rcm_permutation(pattern) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of a (symmetrized) sparsity pattern."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = sp.csr_matrix(pattern)
    sym = csr + csr.T
    ones = sp.csr_matrix(
        (np.ones_like(sym.tocsr().data), sym.tocsr().indices,
         sym.tocsr().indptr), shape=sym.shape)
    return np.asarray(reverse_cuthill_mckee(ones, symmetric_mode=True),
                      dtype=np.int32)


def pack_sym_pgell(mat, *, tile_rows: int = 2048, dtype=np.float32,
                   perm: np.ndarray | None = None,
                   max_bytes_ratio: float = 3.0) -> SymPermuted | None:
    """RCM-permute a square scipy matrix and pack it as PGELL.

    Returns None when the packed layout would be grossly inefficient:
    slot-padded HBM traffic more than ``max_bytes_ratio`` x the CSR bytes
    (12 B/nnz), i.e. when the matrix has no usable band structure even after
    RCM.  The caller then stays on the XLA CSR path.
    """
    csr = sp.csr_matrix(mat)
    if csr.shape[0] != csr.shape[1]:
        return None
    if perm is None:
        perm = rcm_permutation(csr)
    perm = np.asarray(perm, dtype=np.int32)
    permuted = csr[perm][:, perm].tocsr()
    tr = min(tile_rows, max(LANE, -(-csr.shape[0] // LANE) * LANE))
    tr = min(tr, 126 * LANE)
    packed = pack_pgell(permuted, tile_rows=tr, dtype=dtype)
    if max_bytes_ratio > 0 and csr.nnz:
        csr_bytes = csr.nnz * 12.0
        if packed.device_bytes > max_bytes_ratio * csr_bytes:
            return None
    return SymPermuted(inner=packed, perm=jnp.asarray(perm),
                       iperm=jnp.asarray(np.argsort(perm).astype(np.int32)),
                       shape=tuple(int(s) for s in csr.shape))
