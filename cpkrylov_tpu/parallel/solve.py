"""Distributed solves for the WHOLE kernel family under one ``shard_map``.

Two complementary distribution strategies live in ``parallel/``:

* ``cpminres.dist_cpminres`` — a hand-fused flagship path (kept for its
  fully inlined recurrences).
* this module — the *generic* driver that runs ANY of the six serial
  kernels (solvers/) with ROW-SHARDED vectors: the matrix blocks A, B, B',
  C are 1-D row-partitioned over the mesh axis, every Krylov vector (and
  the whole GMRES/DQGMRES basis) lives as an O(N/ndev) per-device shard,
  and every reduction inside the kernels goes through
  ``solvers.common.vdot`` — which the ``reduce_axis`` context turns into a
  psum-fused local dot (SURVEY.md §2.4).  Scalar recurrence state stays
  replicated, bitwise identical across devices.

SpMV operands move either by halo exchange (``halo.plan_halo_block``:
edge-only ppermutes overlapped with local compute — used automatically
when the partitioned blocks are banded enough) or by all-gather fallback.

The preconditioner direct solve runs replicated on gathered vectors (the
factor is the sequential bottleneck on any device; ``schur.SchurFactor``
distributes it — its PartitionSpecs flow through ``precond_spec``).

Driver semantics (RHS shift / un-shift, reg_cpkrylov.m:152-173) are applied
inside the same region, so ``dist_solve`` is the distributed equivalent of
``cpkrylov_tpu.solve``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from ..config import PrecondOptions, SolverOptions
from ..operators.linop import FunctionOperator
from ..precond.cp import CPPrecond, CPState, make_preconditioner
from ..solvers.common import KrylovResult, reduce_axis
from .halo import HaloBlock, halo_extend, halo_matvec, plan_halo_block
from .partition import PartitionedBlocks, partition_blocks, shard_vector

AXIS = "rows"


def precond_spec(M: CPPrecond):
    """PartitionSpec pytree for a CPPrecond operand: replicated, except a
    distributed factor (e.g. schur.SchurFactor) contributes its own specs."""
    if hasattr(M.factor, "partition_spec"):
        factor_spec = M.factor.partition_spec()
    else:
        factor_spec = jax.tree_util.tree_map(lambda _: P(), M.factor)
    return dataclasses.replace(
        M, factor=factor_spec,
        kp=jax.tree_util.tree_map(lambda _: P(), M.kp))


class ShardedPrecond:
    """Shard-facing adapter over a replicated CPPrecond (inside shard_map).

    Three modes, decided statically from the factor and available
    operands (same predicate in ``init_state`` and ``apply_nm`` so the
    state pytree shape is consistent):

    * **sharded-full** — the factor carries a Schur shard plan AND the
      caller provides row-partitioned K_P block matvecs (``kp_mvs``): the
      ENTIRE reference application — GHN input correction, direct solve
      with fused factor refinement, GHN cache refresh, outer iterative
      refinement (opLDL2.m:161-188) — runs on O(N/ndev) shards with
      O(N/ndev + s) comms per apply.  The GHN caches live sharded.
      Closes VERDICT r4 item 4a: the examples' canonical configuration
      (residual_update + nitref, cpk_exprog1.m:87-92) no longer forces
      O(N) all-gathers.
    * **sharded-lean** — shard plan but no K_P matvecs: the direct solve
      is sharded; only lean options qualify (round-4 fast path).
    * **gather** — replicated factor: all-gather, apply, slice.
    """

    def __init__(self, inner: CPPrecond, n_loc: int, m_loc: int,
                 kp_mvs=None):
        self.inner = inner
        self.n_loc = n_loc
        self.m_loc = m_loc
        self.kp_mvs = kp_mvs          # (gmv, btmv, bmv, cmv) or None

    def _has_shard_factor(self) -> bool:
        M = self.inner
        return (getattr(M.factor, "has_shard_plan", False)
                and getattr(M.factor, "shard_nloc", 0) == self.n_loc
                and getattr(M.factor, "shard_mloc", 0) == self.m_loc)

    def _mode(self) -> str:
        if self._has_shard_factor():
            if self.kp_mvs is not None:
                return "sharded_full"
            M = self.inner
            opts = M.options
            if (M.factor_nitref == 0 and opts.nitref == 0
                    and not opts.force_itref and not opts.residual_update):
                return "sharded_lean"
        return "gather"

    def init_state(self, dtype=None) -> CPState:
        if self._mode() == "sharded_full":
            dtype = dtype or self.inner.kp.dtype
            return CPState(aty=jnp.zeros(self.n_loc, dtype),
                           cy=jnp.zeros(self.m_loc, dtype))
        return self.inner.init_state(dtype)

    def _gather(self, v_loc, size):
        return jax.lax.all_gather(v_loc, AXIS, tiled=True)[:size]

    def _slice(self, vfull, loc, size):
        d = jax.lax.axis_index(AXIS)
        nd = jax.lax.axis_size(AXIS)
        vpad = jnp.pad(vfull, (0, nd * loc - size))
        return jax.lax.dynamic_slice(vpad, (d * loc,), (loc,))

    # -- sharded-full application (reference ordering, opLDL2.m:161-188) --
    def _pnorm2(self, vn, vm):
        hi = jax.lax.Precision.HIGHEST
        return jax.lax.psum(jnp.dot(vn, vn, precision=hi)
                            + jnp.dot(vm, vm, precision=hi), AXIS)

    def _apply_sharded_full(self, state, zn, zm):
        M = self.inner
        opts = M.options
        gmv, btmv, bmv, cmv = self.kp_mvs

        def kp_mv(xn, xm):
            return gmv(xn) + btmv(xm), bmv(xn) - cmv(xm)

        def direct(dn, dm):
            yn, ym = M.factor.solve_sharded(dn, dm)
            for _ in range(M.factor_nitref):
                kn, km = kp_mv(yn, ym)
                cn, cm = M.factor.solve_sharded(dn - kn, dm - km)
                yn = yn + cn
                ym = ym + cm
            return yn, ym

        if opts.residual_update:
            zzn = zn - state.aty
            zzm = zm - state.cy
        else:
            zzn, zzm = zn, zm
        yn, ym = direct(zzn, zzm)

        if opts.residual_update:
            # gv = K_P [0; y2] = [B' y2; -C y2]: no G product needed
            state = CPState(aty=btmv(ym), cy=-cmv(ym))

        rnorm = jnp.zeros((), zn.dtype)
        if opts.nitref > 0:
            kn, km = kp_mv(yn, ym)
            rn, rm = zn - kn, zm - km
            rnorm = jnp.sqrt(self._pnorm2(rn, rm))
            xnorm = jnp.sqrt(self._pnorm2(zn, zm))
            if opts.force_itref:
                for _ in range(int(opts.nitref)):
                    cn, cm = direct(rn, rm)
                    yn = yn + cn
                    ym = ym + cm
                    kn, km = kp_mv(yn, ym)
                    rn, rm = zn - kn, zm - km
                    rnorm = jnp.sqrt(self._pnorm2(rn, rm))
                return state, yn, ym, rnorm

            def cond(carry):
                nit, _, _, _, _, rno = carry
                return (nit < opts.nitref) & (rno >= opts.itref_tol * xnorm)

            def body(carry):
                nit, yn_, ym_, rn_, rm_, _ = carry
                cn, cm = direct(rn_, rm_)
                yn_ = yn_ + cn
                ym_ = ym_ + cm
                kn_, km_ = kp_mv(yn_, ym_)
                rn2, rm2 = zn - kn_, zm - km_
                return (nit + 1, yn_, ym_, rn2, rm2,
                        jnp.sqrt(self._pnorm2(rn2, rm2)))

            _, yn, ym, _, _, rnorm = jax.lax.while_loop(
                cond, body, (0, yn, ym, rn, rm, rnorm))
        return state, yn, ym, rnorm

    def apply_nm(self, state, zn_loc, zm_loc):
        n, m = self.inner.n, self.inner.m
        mode = self._mode()
        if mode == "sharded_full":
            return self._apply_sharded_full(state, zn_loc, zm_loc)
        if mode == "sharded_lean":
            # O(N/ndev + s) comms per apply: halo ppermutes + two s-sized
            # psums instead of the O(N) all-gather/psum pair (VERDICT r3
            # item 6).
            yn, ym = self.inner.factor.solve_sharded(zn_loc, zm_loc)
            return state, yn, ym, jnp.zeros((), zn_loc.dtype)
        zn = self._gather(zn_loc, n)
        zm = self._gather(zm_loc, m)
        state, y, rnorm = self.inner.apply(state, jnp.concatenate([zn, zm]))
        return (state, self._slice(y[:n], self.n_loc, n),
                self._slice(y[n:], self.m_loc, m), rnorm)

    def apply(self, state, z_loc_pair):
        """Full-vector apply on an (n_loc + m_loc,) shard pair layout."""
        zn_loc = z_loc_pair[: self.n_loc]
        zm_loc = z_loc_pair[self.n_loc:]
        state, yn, ym, _ = self.apply_nm(state, zn_loc, zm_loc)
        return state, jnp.concatenate([yn, ym])


def _local_matvec(data, cols, in_size):
    """Local ELL rows (global column ids) -> local row results, operand
    all-gathered."""

    def mv(x_loc):
        xf = jax.lax.all_gather(x_loc, AXIS, tiled=True)[:in_size]
        return (data * jnp.take(xf, cols, mode="clip")).sum(-1)

    return mv


def _halo_mv(data, cols, halo):
    def mv(x_loc):
        return halo_matvec(data, cols, halo_extend(x_loc, halo, AXIS))

    return mv


def _try_halo(mat, ndev, rows_loc, cols_loc, dtype) -> HaloBlock | None:
    try:
        return plan_halo_block(mat, ndev, rows_loc, cols_loc, dtype=dtype,
                               max_halo=max(1, cols_loc // 2))
    except ValueError:
        return None


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Host-side plan: partitioned blocks + optional halo blocks.

    ``g`` holds the row-partitioned G block of K_P (+ its halo in
    ``halos["g"]``) when the caller plans for a fully-sharded
    preconditioner application — the GHN/itref K_P SpMVs then run on
    shards like every other operand (VERDICT r4 item 4a)."""

    blocks: PartitionedBlocks
    halos: dict  # name -> HaloBlock | None, for "a", "b", "bt", "c", "g"
    g: tuple | None = None       # (g_data, g_cols) stacked ELL or None


def plan_dist(A, B, C, ndev: int, dtype=np.float64, halo: bool = True,
              G=None) -> DistPlan:
    from ..operators.linop import cache_device_form

    def build():
        import scipy.sparse as sp

        from .partition import _stack_blocks

        blocks = partition_blocks(A, B, C, ndev, dtype=dtype)
        halos = {"a": None, "b": None, "bt": None, "c": None, "g": None}
        g = None
        if G is not None:
            Gc = sp.csr_matrix(G)
            g = _stack_blocks(Gc, ndev, blocks.n_loc, dtype)
            if halo:
                halos["g"] = _try_halo(Gc, ndev, blocks.n_loc,
                                       blocks.n_loc, dtype)
        if halo:
            Ac = sp.csr_matrix(A)
            Bc = sp.csr_matrix(B)
            Cc = sp.csr_matrix(C)
            halos["a"] = _try_halo(Ac, ndev, blocks.n_loc, blocks.n_loc,
                                   dtype)
            halos["b"] = _try_halo(Bc, ndev, blocks.m_loc, blocks.n_loc,
                                   dtype)
            halos["bt"] = _try_halo(Bc.T.tocsr(), ndev, blocks.n_loc,
                                    blocks.m_loc, dtype)
            halos["c"] = _try_halo(Cc, ndev, blocks.m_loc, blocks.m_loc,
                                   dtype)
        return DistPlan(blocks=blocks, halos=halos, g=g)

    # Memoized per host-A + content fingerprints of all partitioned
    # blocks (advisor r4: an id()-only key partitions stale data after an
    # in-place update; same ndev/dtype/halo): repeated dist_solve calls
    # on one system must reuse both the packed blocks AND the plan object
    # identity — the compiled shard_map program is cached on it below.
    # A changed fingerprint replaces the plan; the old plan's finalizer
    # then evicts its compiled programs from _MAPPED_CACHE.
    from ..operators.linop import host_fingerprint

    return cache_device_form(
        A, ("dist_plan", ndev, np.dtype(dtype).str, bool(halo),
            G is not None), build,
        fingerprint=(host_fingerprint(A), host_fingerprint(B),
                     host_fingerprint(C),
                     None if G is None else host_fingerprint(G)))


def _host_staging():
    """Create arrays on the host's CPU device while this context is open.

    The per-device operand stacks are built whole before they are split
    over the mesh; built on the default accelerator they would sit on its
    first device in full.  Without a CPU backend (``JAX_PLATFORMS`` names
    only the accelerator) arrays go to the default device."""
    try:
        return jax.default_device(jax.devices("cpu")[0])
    except RuntimeError:
        return contextlib.nullcontext()


def _place(mesh: Mesh, tree, specs):
    """``device_put`` each subtree of ``tree`` with the PartitionSpec that
    ``specs`` (a tree prefix of ``tree``) gives it, over ``mesh``."""
    return jax.tree_util.tree_map(
        lambda spec, sub: jax.device_put(sub, NamedSharding(mesh, spec)),
        specs, tree, is_leaf=lambda s: isinstance(s, P))


# Operand stacks placed over a mesh, keyed by (plan identity, mesh), so
# repeated solves on one plan transfer them once.
_PLACED_CACHE: dict = {}

# Compiled shard_map programs, keyed by (plan identity, mesh, kernel,
# options, shift flag).  Without this every dist_solve call rebuilds the
# closure and XLA recompiles the whole region (~100 s at production sizes
# — round-3 bench_scaling was timing recompilation, not solves).
_MAPPED_CACHE: dict = {}


def dist_solve(mesh: Mesh, method: str, b, A, B, C, G, *,
               opts: SolverOptions | None = None,
               precond_opts: PrecondOptions | None = None,
               M: CPPrecond | None = None, panel: int = 256,
               halo: bool = True, dtype=None):
    """Distributed ``solve``: any kernel, row-sharded matrices AND vectors.

    Host-side entry: partitions the blocks, plans halo exchanges, builds
    (or reuses) the preconditioner, and runs shift -> kernel -> un-shift
    inside one ``shard_map`` region.  Returns the same ``(res, x1, x2)``
    triple as the serial driver core with global (gathered) arrays.
    """
    from ..driver import _solver_registry

    opts = opts or SolverOptions()
    if callable(method):
        method = method.__name__
    kernel = _solver_registry()[method]

    b = np.asarray(b).reshape(-1)
    dtype = np.dtype(dtype or b.dtype)
    dtype = jax.dtypes.canonicalize_dtype(dtype)
    n, m = A.shape[0], C.shape[0]
    ndev = int(np.prod(mesh.devices.shape))

    # Kernel itmax defaults use GLOBAL sizes (cpcg.m:99 itmax=n,
    # cpgmres.m:105 itmax=n+m); inside the region A.shape is local.
    if opts.itmax is None:
        default = n + m if method in ("cpgmres", "cpdqgmres") else n
        opts = dataclasses.replace(opts, itmax=int(default))

    with _host_staging():
        if M is None:
            # Prefer the distributed Schur factor: per-device factor memory
            # and trisolve cost are O(N/ndev) instead of the replicated
            # factor's O(N)-on-every-device.  Exactness means iteration
            # counts are unchanged.  Systems whose RCM profile stays too
            # wide for chunked partitioning fall back to the replicated
            # factor (build_dist_precond, shared with dist_solve_mixed).
            from .mixed import build_dist_precond

            M = build_dist_precond(G, B, C, ndev, precond_opts=precond_opts,
                                   panel=panel, dtype=dtype)
        # A Schur-sharded factor + row-partitioned G unlock the fully-
        # sharded preconditioner application (GHN + itref on shards).
        shard_g = getattr(M.factor, "has_shard_plan", False)
        plan = plan_dist(A, B, C, ndev, dtype=dtype, halo=halo,
                         G=G if shard_g else None)
        blocks = plan.blocks
        n_loc, m_loc = blocks.n_loc, blocks.m_loc
        b1_sh = shard_vector(b[:n].astype(dtype), ndev, n_loc)
        b2_sh = shard_vector(b[n:].astype(dtype), ndev, m_loc)
        zeros = jnp.zeros((ndev, 1, 1), dtype)
        izeros = jnp.zeros((ndev, 1, 1), jnp.int32)
    shift = bool(np.any(b[n:]))                    # reg_cpkrylov.m:154

    def h_operand(name):
        hb = plan.halos[name]
        if hb is None:
            return zeros, izeros
        return hb.data, hb.cols

    ha = h_operand("a")
    hb_ = h_operand("b")
    hbt = h_operand("bt")
    hc = h_operand("c")
    g_ops = plan.g if plan.g is not None else (zeros, izeros)
    hg = h_operand("g")

    def body(a_data, a_cols, b_data, b_cols, bt_data, bt_cols, c_data,
             c_cols, ha_d, ha_c, hb_d, hb_c, hbt_d, hbt_c, hc_d, hc_c,
             g_data, g_cols, hg_d, hg_c, M_rep, b1_loc, b2_loc):
        def pick(name, gdata, gcols, hd, hc_, in_size):
            hblk = plan.halos[name]
            if hblk is not None:
                return _halo_mv(hd[0], hc_[0], hblk.halo)
            return _local_matvec(gdata[0], gcols[0], in_size)

        amv = pick("a", a_data, a_cols, ha_d, ha_c, n)
        bmv = pick("b", b_data, b_cols, hb_d, hb_c, n)
        btmv = pick("bt", bt_data, bt_cols, hbt_d, hbt_c, m)
        cmv = pick("c", c_data, c_cols, hc_d, hc_c, m)
        kp_mvs = None
        if plan.g is not None:
            gmv = pick("g", g_data, g_cols, hg_d, hg_c, n)
            kp_mvs = (gmv, btmv, bmv, cmv)

        A_op = FunctionOperator(params=None, fn=lambda _, x: amv(x),
                                rfn=None, shape=(n_loc, n_loc))
        C_op = FunctionOperator(params=None, fn=lambda _, x: cmv(x),
                                rfn=None, shape=(m_loc, m_loc))
        B_op = FunctionOperator(params=None, fn=lambda _, x: bmv(x),
                                rfn=lambda _, y: btmv(y),
                                shape=(m_loc, n_loc))
        Msh = ShardedPrecond(M_rep, n_loc, m_loc, kp_mvs=kp_mvs)
        b1l = b1_loc[0]
        b2l = b2_loc[0]

        with reduce_axis(AXIS):
            mstate = Msh.init_state(b1l.dtype)
            if shift:
                # xy0 = M*[0; b2]; b1' = b1 - A*xy0_1 - B'*xy0_2
                # (reg_cpkrylov.m:154-158)
                mstate, xy0 = Msh.apply(
                    mstate, jnp.concatenate([jnp.zeros_like(b1l), b2l]))
                xy0n, xy0m = xy0[:n_loc], xy0[n_loc:]
                b1l = b1l - amv(xy0n) - btmv(xy0m)
            else:
                xy0n = jnp.zeros_like(b1l)
                xy0m = jnp.zeros_like(b2l)

            res = kernel(b1l, A_op, C_op, Msh, opts, mstate, B=B_op)
            x1 = xy0n + res.x                      # reg_cpkrylov.m:166-172
            x2 = xy0m + res.y
        return res, x1[None], x2[None]

    operands = (blocks.a_data, blocks.a_cols, blocks.b_data, blocks.b_cols,
                blocks.bt_data, blocks.bt_cols, blocks.c_data, blocks.c_cols,
                *ha, *hb_, *hbt, *hc, *g_ops, *hg)
    spec_blocks = jax.tree_util.tree_map(lambda _: P(AXIS), operands)
    spec_M = precond_spec(M)

    has_hists = method == "cpsymmlq"
    res_spec = KrylovResult(
        x=P(AXIS), y=P(AXIS), niters=P(), resid_history=P(),
        solved=P(), istatus=P(),
        cg_resid_history=P() if has_hists else None,
        lq_resid_history=P() if has_hists else None,
        qr_resid_history=P() if has_hists else None,
    )

    # Each device holds only its own slice of the operand stacks.
    pkey = (id(plan), mesh)
    placed = _PLACED_CACHE.get(pkey)
    if placed is None:
        placed = _place(mesh, operands, spec_blocks)
        weakref.finalize(plan, _PLACED_CACHE.pop, pkey, None)
        _PLACED_CACHE[pkey] = placed
    M = _place(mesh, M, spec_M)
    b1_sh, b2_sh = _place(mesh, (b1_sh, b2_sh), (P(AXIS), P(AXIS)))

    # Reuse the compiled program across calls with the same plan/mesh/
    # kernel/options/precond structure: `body` is a fresh closure per call,
    # so without an explicit cache jax.jit retraces (and XLA recompiles)
    # every solve.
    key = (id(plan), mesh, method, opts, shift,
           jax.tree_util.tree_structure((M, operands)))
    mapped = _MAPPED_CACHE.get(key)
    if mapped is None:
        mapped = jax.jit(shard_map(
            body, mesh=mesh,
            in_specs=(*spec_blocks, spec_M, P(AXIS), P(AXIS)),
            out_specs=(res_spec, P(AXIS), P(AXIS)),
            check_vma=False,
        ))
        # Register the finalizer FIRST and only cache on success (matching
        # cache_device_form): an entry without an eviction hook could be
        # served stale to a later plan that reuses the same id().
        try:
            weakref.finalize(plan, _MAPPED_CACHE.pop, key, None)
        except TypeError:  # pragma: no cover
            pass
        else:
            _MAPPED_CACHE[key] = mapped
    res, x1, x2 = mapped(*placed, M, b1_sh, b2_sh)
    # Trim shard padding on the gathered outputs.
    res = dataclasses.replace(res, x=res.x[:n], y=res.y[:m])
    return res, x1.reshape(-1)[:n], x2.reshape(-1)[:m]
