"""Sparse triangular solves on the device via blocked forward substitution.

This replaces the sparse triangular solves hidden inside the reference's
``op.LDL`` operator composition (/root/reference/ops/opLDL2.m:86, applied at
opLDL2.m:165-167).  Triangular solves are inherently sequential; the
formulation here blocks the factor into ``panel``-row panels, inverts each
diagonal panel densely on the host once at setup, and then runs

    x[blk] = inv_diag[blk] @ (b[blk] - L_off[blk, :] @ x)

as a ``fori_loop`` of ``n/panel`` steps.  Each step is an ELL gather plus a
(panel, panel) dense matvec — compiler-friendly static shapes, sequential
depth n/panel instead of the nnz-chain depth of level scheduling.  Banded
factors take the log-depth parallel-prefix forms (``ScanTriFactor``,
``ReducedScanTriFactor``) instead.

Every contraction passes ``precision=HIGHEST``: a float32 product may
otherwise run in TF32 on GPUs (about three decimal digits), which would
make the preconditioner far less exact than its f32 storage.

An upper-triangular solve is the same kernel on the index-reversed matrix
(J U J is lower triangular for the reversal J), so only one device routine
exists; the reversal is folded into the host-side permutations.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@partial(_register,
         data_fields=("inv_diag", "off_data", "off_cols"),
         meta_fields=("n", "panel"))
@dataclasses.dataclass(frozen=True)
class BlockTriFactor:
    """Lower-triangular factor prepared for blocked substitution."""

    inv_diag: jax.Array  # (nblocks, panel, panel) dense inverses
    off_data: jax.Array  # (n_pad, K) entries strictly left of the block
    off_cols: jax.Array  # (n_pad, K) int32
    n: int
    panel: int

    @property
    def nblocks(self) -> int:
        return self.inv_diag.shape[0]

    @property
    def work_nnz(self) -> int:
        """Arithmetic volume of one solve (for the profiling work model)."""
        return (int(np.count_nonzero(np.asarray(self.off_data)))
                + self.nblocks * self.panel * self.panel)


def _invert_panels_f(diag_f: np.ndarray) -> np.ndarray:
    """Invert a stack of lower-triangular panels stored as an F-ordered
    (panel, panel, nblocks) array, in place slice by slice.

    The F layout matters: LAPACK ``trtri`` requires Fortran-contiguous
    input, and f2py silently *copies* every C-ordered (panel, panel) slice
    — measured 5x slower than zero-copy F slices at production sizes.
    Returns the same buffer; ``.transpose(2, 0, 1)`` gives the (nb, p, p)
    stack as a view.

    Small panels (the reach-hugging reduced-scan form) take numpy's batched
    ``inv`` instead: at p = 16-64 the per-slice Python/f2py overhead of the
    trtri loop dominates its O(p^3/6) arithmetic (measured ~10x slower than
    one batched LAPACK call over ~100k slices).
    """
    from scipy.linalg import get_lapack_funcs

    p, nb = diag_f.shape[0], diag_f.shape[2]
    if p <= 64 and nb > 256:
        stack = np.ascontiguousarray(diag_f.transpose(2, 0, 1))
        try:
            inv = np.linalg.inv(stack)
        except np.linalg.LinAlgError as exc:
            raise ZeroDivisionError(f"singular diagonal panel ({exc})")
        diag_f[:] = inv.transpose(1, 2, 0)
        return diag_f
    trtri, = get_lapack_funcs(("trtri",), (diag_f[:, :, 0],))
    for b in range(nb):
        out, info = trtri(diag_f[:, :, b], lower=1, overwrite_c=1)
        if info != 0:
            raise ZeroDivisionError(
                f"singular diagonal panel {b} (trtri info={info})")
        if not np.shares_memory(out, diag_f):
            diag_f[:, :, b] = out
    return diag_f


def _coo_canonical(T):
    """Canonical (row, col, data) triplets of a scipy matrix, int64 indices."""
    import scipy.sparse as sp

    T = sp.csr_matrix(T)
    T.sum_duplicates()
    coo = T.tocoo()
    return T, coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data


def build_block_tri(T, panel: int = 256, dtype=None) -> BlockTriFactor:
    """Prepare a scipy lower-triangular matrix (diagonal included).

    ``T`` must be lower triangular with an explicit (nonzero) diagonal; pass
    ``L + I`` for unit-diagonal factors stored strictly-lower.  All packing
    is vectorized numpy (O(nnz)), so setup stays linear at 10M+ rows.
    """
    T, er, ec, ev = _coo_canonical(T)
    n = T.shape[0]
    dtype = dtype or T.dtype
    nblocks = max(1, -(-n // panel))
    n_pad = nblocks * panel

    blk = er // panel
    r_loc = er - blk * panel
    in_blk = ec >= blk * panel

    # Dense diagonal panels (padding rows solve to identity); F-ordered
    # (p, p, nb) stack so LAPACK trtri inverts each slice zero-copy.
    diag_f = np.zeros((panel, panel, nblocks), dtype=np.float64, order="F")
    idx = np.arange(panel)
    diag_f[idx, idx, :] = 1.0
    d = in_blk
    diag_f[r_loc[d], ec[d] - blk[d] * panel, blk[d]] = ev[d]
    inv_diag = _invert_panels_f(diag_f).transpose(2, 0, 1).astype(dtype)
    del diag_f

    # Off-panel entries in ELL layout: position within row via cumcount.
    o = ~in_blk
    orow, ocol, oval = er[o], ec[o], ev[o]
    counts = np.bincount(orow, minlength=n_pad)
    max_off = max(1, int(counts.max()) if counts.size else 1)
    order = np.argsort(orow, kind="stable")
    starts = np.zeros(n_pad + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(orow.size) - starts[orow[order]]
    off_data = np.zeros((n_pad, max_off), dtype=dtype)
    off_cols = np.zeros((n_pad, max_off), dtype=np.int32)
    off_data[orow[order], pos] = oval[order]
    off_cols[orow[order], pos] = ocol[order]

    return BlockTriFactor(
        inv_diag=jnp.asarray(inv_diag),
        off_data=jnp.asarray(off_data),
        off_cols=jnp.asarray(off_cols),
        n=int(n),
        panel=int(panel),
    )


def block_tri_solve(tf: BlockTriFactor, b: jax.Array) -> jax.Array:
    """Solve T x = b for the prepared lower-triangular factor."""
    panel = tf.panel
    n_pad = tf.nblocks * panel
    x0 = jnp.zeros(n_pad, dtype=b.dtype)
    b_pad = x0.at[: tf.n].set(b)

    def body(i, x):
        r0 = i * panel
        od = jax.lax.dynamic_slice_in_dim(tf.off_data, r0, panel, axis=0)
        oc = jax.lax.dynamic_slice_in_dim(tf.off_cols, r0, panel, axis=0)
        gathered = jnp.take(x, oc, mode="clip")
        contrib = (od.astype(b.dtype) * gathered).sum(axis=1)
        rhs = jax.lax.dynamic_slice_in_dim(b_pad, r0, panel) - contrib
        inv = jax.lax.dynamic_index_in_dim(tf.inv_diag, i, keepdims=False)
        xb = jnp.matmul(inv.astype(b.dtype), rhs, precision=_HI)
        return jax.lax.dynamic_update_slice_in_dim(x, xb, r0, axis=0)

    x = jax.lax.fori_loop(0, tf.nblocks, body, x0)
    return x[: tf.n]


@partial(_register,
         data_fields=("inv_diag", "m_blocks"),
         meta_fields=("n", "panel"))
@dataclasses.dataclass(frozen=True)
class ScanTriFactor:
    """Block-bidiagonal lower factor prepared for an associative scan.

    When every off-panel entry of T comes from the immediately preceding
    panel (true for banded matrices under RCM ordering, where the LDL^T
    factor's subdiagonal reach is tiny), the blocked substitution

        x_i = inv_diag_i (b_i - S_i x_{i-1}) = M_i x_{i-1} + c_i

    is a first-order linear recurrence over panels — a parallel prefix.
    ``lax.associative_scan`` evaluates it in log2(nblocks) levels of
    batched (panel, panel) matmuls, replacing the O(nblocks) sequential
    ``fori_loop`` of ``block_tri_solve`` (~4900 sequential steps for a
    1.25M-row system at panel=256).
    """

    inv_diag: jax.Array  # (nblocks, panel, panel)
    m_blocks: jax.Array  # (nblocks, panel, panel); M_0 = 0
    n: int
    panel: int

    @property
    def nblocks(self) -> int:
        return self.inv_diag.shape[0]

    @property
    def work_nnz(self) -> int:
        """Arithmetic volume of one solve (for the profiling work model)."""
        nb, p = self.nblocks, self.panel
        levels = max(1, int(np.ceil(np.log2(max(nb, 2)))))
        return nb * p * p * levels


def build_scan_tri(T, panel: int = 128, dtype=None) -> ScanTriFactor | None:
    """Prepare T for the scan solve; None when entries reach beyond the
    preceding panel (the caller then falls back to ``build_block_tri``).
    Packing is vectorized numpy scatter + batched LAPACK/BLAS (O(nnz) +
    O(nblocks * panel^3) dense work), linear-time at production sizes."""
    T, er, ec, ev = _coo_canonical(T)
    n = T.shape[0]
    dtype = dtype or T.dtype
    reach = int((er - ec).max()) if ev.size else 0
    # Entries must stay within the previous panel for EVERY block boundary:
    # row r in block b may only reference columns >= (b-1)*panel, which is
    # guaranteed iff the subdiagonal reach is at most panel.
    if reach > panel:
        return None

    nblocks = max(1, -(-n // panel))
    blk = er // panel
    r_loc = er - blk * panel
    c_blk = ec // panel
    on_diag = c_blk == blk               # reach <= panel => diag or sub only

    diag_f = np.zeros((panel, panel, nblocks), dtype=np.float64, order="F")
    idx = np.arange(panel)
    diag_f[idx, idx, :] = 1.0            # padding rows solve to identity
    d = on_diag
    # The scatter overwrites the unit diagonal wherever T stores one.
    diag_f[r_loc[d], ec[d] - blk[d] * panel, blk[d]] = ev[d]
    s = ~on_diag
    # sub-blocks are nonzero only in their (reach x panel-trailing) corner:
    # row r = b*p + rl references c < b*p only when rl < reach, and
    # c >= r - reach >= b*p - reach; store just that (reach, reach) corner.
    rr = max(1, min(reach, panel))
    sub_c = np.zeros((nblocks, rr, rr), dtype=np.float64)
    sub_c[blk[s], r_loc[s], ec[s] - (blk[s] - 1) * panel - (panel - rr)] = ev[s]

    inv64 = _invert_panels_f(diag_f).transpose(2, 0, 1)   # (nb, p, p) view
    m_blocks = np.zeros((nblocks, panel, panel), dtype=dtype)
    if nblocks > 1:
        # Corner-restricted batched GEMM: O(nb * p * reach^2) build instead
        # of O(nb * p^3).
        prod = np.matmul(np.ascontiguousarray(inv64[1:, :, :rr]),
                         sub_c[1:])
        m_blocks[1:, :, panel - rr:] = -prod.astype(dtype)
    del sub_c

    return ScanTriFactor(inv_diag=jnp.asarray(inv64.astype(dtype)),
                         m_blocks=jnp.asarray(m_blocks),
                         n=int(n), panel=int(panel))


def _affine_combine(a, bb):
    """Compose two affine maps x -> M x + c (``a`` applied first)."""
    ma, ca = a
    mb, cb = bb
    return (jnp.matmul(mb, ma, precision=_HI),
            jnp.einsum("...ij,...j->...i", mb, ca, precision=_HI) + cb)


def scan_tri_solve(tf: ScanTriFactor, b: jax.Array) -> jax.Array:
    """Solve T x = b via parallel prefix over the panel recurrence."""
    p = tf.panel
    n_pad = tf.nblocks * p
    b_pad = jnp.zeros(n_pad, b.dtype).at[: tf.n].set(b)
    b2 = b_pad.reshape(tf.nblocks, p)
    c = jnp.einsum("bij,bj->bi", tf.inv_diag.astype(b.dtype), b2,
                   precision=_HI)
    m = tf.m_blocks.astype(b.dtype)
    _, x = jax.lax.associative_scan(_affine_combine, (m, c))
    return x.reshape(-1)[: tf.n]


@partial(_register,
         data_fields=("inv_diag", "w_blocks"),
         meta_fields=("n", "panel", "r"))
@dataclasses.dataclass(frozen=True)
class ReducedScanTriFactor:
    """Reduced-state parallel-prefix factor for small subdiagonal reach.

    The panel recurrence x_i = inv_i b_i - (inv_i S_i) x_{i-1} only reads
    the LAST ``r = reach`` entries of x_{i-1} (S_i's nonzero columns), so the
    scan state can be the r-vector s_i = tail(x_i) instead of the full
    panel:

        c_i = inv_i b_i                       (batched (p, p) matvec)
        s_i = Mr_i s_{i-1} + tail(c_i),  Mr_i = -tail_rows(inv_i S_i)
        x_i = c_i - W_i s_{i-1},         W_i  = inv_i S_i   ((p, r) blocks)

    vs the full ScanTriFactor this swaps log2(nb) passes over (nb, p, p)
    composed products for ONE pass over inv_diag plus a scan over (nb, r, r)
    — a >10x HBM traffic cut per solve when r << p (the production banded
    KKT factors have r of a few tens at panel 128+).
    """

    inv_diag: jax.Array   # (nb, p, p)
    w_blocks: jax.Array   # (nb, p, r) = inv_i @ S_i (nonzero column block)
    n: int
    panel: int
    r: int

    @property
    def nblocks(self) -> int:
        return self.inv_diag.shape[0]

    @property
    def work_nnz(self) -> int:
        """Arithmetic volume of one solve (for the profiling work model)."""
        nb, p, r = self.nblocks, self.panel, self.r
        levels = max(1, int(np.ceil(np.log2(max(nb, 2)))))
        return nb * (p * p + p * r) + nb * r * r * levels


def reduced_scan_tri_solve(tf: ReducedScanTriFactor, b: jax.Array):
    p = tf.panel
    r = tf.r
    nb = tf.nblocks
    b_pad = jnp.zeros(nb * p, b.dtype).at[: tf.n].set(b)
    b2 = b_pad.reshape(nb, p)
    c = jnp.einsum("bij,bj->bi", tf.inv_diag.astype(b.dtype), b2,
                   precision=_HI)
    w = tf.w_blocks.astype(b.dtype)
    mr = -w[:, p - r:, :]                       # (nb, r, r)
    cr = c[:, p - r:]                           # (nb, r)
    _, s = jax.lax.associative_scan(_affine_combine, (mr, cr))
    s_prev = jnp.concatenate([jnp.zeros((1, r), b.dtype), s[:-1]], axis=0)
    x = c - jnp.einsum("bij,bj->bi", w, s_prev, precision=_HI)
    return x.reshape(-1)[: tf.n]


def build_reduced_scan_tri(T, panel: int = 128, r: int | None = None,
                           dtype=None) -> ReducedScanTriFactor | None:
    """Prepare T for the reduced-state scan; None when the reach exceeds
    ``panel`` (caller falls back)."""
    T, er, ec, ev = _coo_canonical(T)
    n = T.shape[0]
    dtype = dtype or T.dtype
    reach = int((er - ec).max()) if ev.size else 0
    if reach > panel:
        return None
    if r is None:
        # Exact reach: every extra state row adds work to each scan level.
        r = max(1, reach)
    r = min(r, panel)

    nblocks = max(1, -(-n // panel))
    blk = er // panel
    r_loc = er - blk * panel
    on_diag = (ec // panel) == blk

    diag_f = np.zeros((panel, panel, nblocks), dtype=np.float64, order="F")
    idx = np.arange(panel)
    diag_f[idx, idx, :] = 1.0
    d = on_diag
    diag_f[r_loc[d], ec[d] - blk[d] * panel, blk[d]] = ev[d]
    s = ~on_diag
    sub_c = np.zeros((nblocks, reach if reach else 1, r), dtype=np.float64)
    if s.any():
        sub_c[blk[s], r_loc[s], ec[s] - (blk[s] - 1) * panel - (panel - r)] \
            = ev[s]

    inv64 = _invert_panels_f(diag_f).transpose(2, 0, 1)   # (nb, p, p) view
    w = np.zeros((nblocks, panel, r), dtype=dtype)
    if nblocks > 1 and reach:
        prod = np.matmul(np.ascontiguousarray(inv64[1:, :, :reach]),
                         sub_c[1:])
        w[1:] = prod.astype(dtype)
    return ReducedScanTriFactor(
        inv_diag=jnp.asarray(inv64.astype(dtype)),
        w_blocks=jnp.asarray(w),
        n=int(n), panel=int(panel), r=int(r))


def tri_solve(tf, b: jax.Array) -> jax.Array:
    """Dispatch on the prepared factor kind (static under jit: the factor
    class is part of the pytree structure)."""
    if isinstance(tf, ReducedScanTriFactor):
        return reduced_scan_tri_solve(tf, b)
    if isinstance(tf, ScanTriFactor):
        return scan_tri_solve(tf, b)
    return block_tri_solve(tf, b)


def build_block_tri_upper(U, panel: int = 256, dtype=None) -> BlockTriFactor:
    """Prepare an upper-triangular matrix by building its reversal.

    Solving U w = v is ``rev(solve_lower(J U J, rev(v)))``; callers fold the
    two reversals into their permutation vectors (see cp.py).
    """
    import scipy.sparse as sp

    U = sp.csr_matrix(U)
    n = U.shape[0]
    rev = np.arange(n - 1, -1, -1)
    T = U[rev][:, rev].tocsr()
    return build_block_tri(T, panel=panel, dtype=dtype)
