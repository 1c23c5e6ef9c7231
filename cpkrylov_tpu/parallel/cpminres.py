"""Distributed CP-MINRES: row-partitioned blocks under shard_map.

The solver loop runs entirely inside one ``shard_map`` region over the mesh
axis ``"rows"``: SpMV operands are all-gathered over ICI, the coupled dot
products ``dot(u,v)+dot(t,q)`` are psum-fused into the recurrence
(SURVEY.md §2.4), scalar recurrence state is replicated, and the
preconditioner factors are applied redundantly on every device (replicated
direct solve — the factor is the sequential bottleneck either way; a
distributed panel solve is the next refinement).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from ..config import SolverOptions
from ..precond.cp import CPPrecond, CPState
from ..solvers.common import eps100
from .halo import HaloBlock, halo_extend, halo_matvec
from .partition import PartitionedBlocks

AXIS = "rows"


class _Carry(NamedTuple):
    k: jax.Array
    x: jax.Array       # (n_loc,)
    y: jax.Array       # (m_loc,)
    vk: jax.Array
    qk: jax.Array
    vkp1: jax.Array
    qkp1: jax.Array
    beta: jax.Array
    deltabar: jax.Array
    epsln: jax.Array
    taubar: jax.Array
    cs: jax.Array
    sn: jax.Array
    wv: jax.Array
    wq: jax.Array
    wv2: jax.Array
    wq2: jax.Array
    resid: jax.Array
    hist: jax.Array
    mstate: CPState
    indefinite: jax.Array


def dist_cpminres(mesh: Mesh, blocks: PartitionedBlocks, M: CPPrecond,
                  b_sharded: jax.Array, opts: SolverOptions | None = None,
                  halo_a: HaloBlock | None = None,
                  halo_c: HaloBlock | None = None):
    """Solve on a mesh; returns (x_sh, y_sh, niters, resid, hist).

    ``b_sharded`` is (ndev, n_loc) laid out by ``partition.shard_vector``.
    When ``halo_a``/``halo_c`` are provided (see halo.plan_halo_block), the
    A and C matvecs exchange only neighbour edge regions via ppermute
    instead of all-gathering the operand — the ring/halo pattern of
    SURVEY.md §2.4, with XLA overlapping the permutes against local work.
    """
    opts = opts or SolverOptions()
    n, m = blocks.n, blocks.m
    n_loc, m_loc = blocks.n_loc, blocks.m_loc
    ndev = blocks.ndev
    itmax = int(opts.itmax) if opts.itmax is not None else n
    dtype = b_sharded.dtype
    e100 = eps100(dtype)
    # Static: the sharded direct solve replaces the gather+replicated
    # apply when the factor carries a matching Schur shard plan and the
    # options are lean (GHN/itref configurations route through the
    # generic dist_solve driver, which shards those too).
    mo = M.options
    shard_solve_ok = (getattr(M.factor, "has_shard_plan", False)
                      and getattr(M.factor, "shard_nloc", 0) == n_loc
                      and getattr(M.factor, "shard_mloc", 0) == m_loc
                      and M.factor_nitref == 0 and mo.nitref == 0
                      and not mo.force_itref and not mo.residual_update)

    def gather_n(v_loc):
        return jax.lax.all_gather(v_loc, AXIS, tiled=True)[:n]

    def gather_m(q_loc):
        return jax.lax.all_gather(q_loc, AXIS, tiled=True)[:m]

    def slice_n(vfull):
        d = jax.lax.axis_index(AXIS)
        vpad = jnp.pad(vfull, (0, ndev * n_loc - n))
        return jax.lax.dynamic_slice(vpad, (d * n_loc,), (n_loc,))

    def slice_m(vfull):
        d = jax.lax.axis_index(AXIS)
        vpad = jnp.pad(vfull, (0, ndev * m_loc - m))
        return jax.lax.dynamic_slice(vpad, (d * m_loc,), (m_loc,))

    def pdot(a_loc, b_loc):
        return jax.lax.psum(jnp.dot(a_loc, b_loc, precision=jax.lax.Precision.HIGHEST), AXIS)

    def body_fn(a_data, a_cols, b_data, b_cols, bt_data, bt_cols, c_data,
                c_cols, ha_data, ha_cols, hc_data, hc_cols, M_rep, b_loc):
        a_data, a_cols = a_data[0], a_cols[0]
        bt_data, bt_cols = bt_data[0], bt_cols[0]
        c_data, c_cols = c_data[0], c_cols[0]
        b_loc = b_loc[0]

        if halo_a is not None:
            ha_d, ha_c = ha_data[0], ha_cols[0]

            def amv(v_loc):
                return halo_matvec(ha_d, ha_c,
                                   halo_extend(v_loc, halo_a.halo, AXIS))
        else:
            def amv(v_loc):
                vf = gather_n(v_loc)
                return (a_data * jnp.take(vf, a_cols, mode="clip")).sum(-1)

        if halo_c is not None:
            hc_d, hc_c = hc_data[0], hc_cols[0]

            def cmv(q_loc):
                return halo_matvec(hc_d, hc_c,
                                   halo_extend(q_loc, halo_c.halo, AXIS))
        else:
            def cmv(q_loc):
                qf = gather_m(q_loc)
                return (c_data * jnp.take(qf, c_cols, mode="clip")).sum(-1)

        if shard_solve_ok:
            def m_apply(mstate, un_loc, tm_loc):
                """Schur-native sharded apply: O(N/ndev + s) comms instead
                of the O(N) all-gather pair (VERDICT r4 weak #1 — the
                flagship no longer all-gathers full vectors for the
                preconditioner when the factor carries a shard plan)."""
                yn, ym = M_rep.factor.solve_sharded(un_loc, tm_loc)
                return mstate, yn, ym
        else:
            def m_apply(mstate, un_loc, tm_loc):
                """Preconditioner on the (gathered) full pair; replicated
                solve."""
                z = jnp.concatenate([gather_n(un_loc), gather_m(tm_loc)])
                mstate, yfull, _ = M_rep.apply(mstate, z)
                return mstate, slice_n(yfull[:n]), slice_m(yfull[n:])

        zero = jnp.zeros((), dtype)
        zeron = jnp.zeros(n_loc, dtype)
        zerom = jnp.zeros(m_loc, dtype)

        mstate = M_rep.init_state(dtype)
        mstate, w1, w2 = m_apply(mstate, b_loc, zerom)
        vkp1 = w1
        qkp1 = -w2
        beta0 = pdot(b_loc, vkp1)
        # Relative threshold, matching the serial kernels'
        # initial_lanczos_pair (solvers/common.py) exactly.
        indefinite0 = beta0 < -e100 * (1 + jnp.abs(beta0))
        beta = jnp.sqrt(jnp.abs(beta0))
        pos = beta > 0
        denom = jnp.where(pos, beta, 1.0)
        vkp1 = jnp.where(pos, vkp1 / denom, vkp1)
        qkp1 = jnp.where(pos, qkp1 / denom, qkp1)

        resid0 = beta
        stop_tol = opts.atol + opts.rtol * resid0
        hist = jnp.full(itmax + 1, jnp.nan, dtype).at[0].set(resid0)

        carry = _Carry(
            k=jnp.zeros((), jnp.int32), x=zeron, y=zerom,
            vk=zeron, qk=zerom, vkp1=vkp1, qkp1=qkp1, beta=beta,
            deltabar=zero, epsln=zero, taubar=beta,
            cs=jnp.asarray(-1.0, dtype), sn=zero,
            wv=vkp1, wq=qkp1, wv2=zeron, wq2=zerom,
            resid=resid0, hist=hist, mstate=mstate,
            indefinite=indefinite0,
        )

        def cond(c: _Carry):
            return (c.resid > stop_tol) & (c.k < itmax) & (~c.indefinite)

        def body(c: _Carry) -> _Carry:
            k = c.k + 1
            vkm1, qkm1 = c.vk, c.qk
            vk, qk = c.vkp1, c.qkp1

            u = amv(vk)
            t = cmv(qk)
            alpha = pdot(u, vk) + pdot(t, qk)
            mstate, w1, w2 = m_apply(c.mstate, u, -t)
            vkp1 = w1 - alpha * vk - c.beta * vkm1
            qkp1 = (qk - w2) - alpha * qk - c.beta * qkm1
            beta2 = pdot(u, vkp1) + pdot(t, qkp1)
            indefinite = beta2 < -e100 * (1 + jnp.abs(alpha))
            beta = jnp.sqrt(jnp.abs(beta2))
            pos = beta > 0
            denom = jnp.where(pos, beta, 1.0)
            vkp1 = jnp.where(pos, vkp1 / denom, vkp1)
            qkp1 = jnp.where(pos, qkp1 / denom, qkp1)

            oldeps = c.epsln
            delta = c.cs * c.deltabar + c.sn * alpha
            gammabar = c.sn * c.deltabar - c.cs * alpha
            epsln = c.sn * beta
            deltabar = -c.cs * beta
            gamma = jnp.hypot(gammabar, beta)
            cs = gammabar / gamma
            sn = beta / gamma
            tau = cs * c.taubar
            taubar = sn * c.taubar

            wv1, wq1 = c.wv2, c.wq2
            wv2, wq2 = c.wv, c.wq
            wv = (vk - oldeps * wv1 - delta * wv2) / gamma
            wq = (qk - oldeps * wq1 - delta * wq2) / gamma
            x = c.x + tau * wv
            y = c.y - tau * wq

            resid = taubar
            hist = c.hist.at[k].set(resid)
            return _Carry(k=k, x=x, y=y, vk=vk, qk=qk, vkp1=vkp1, qkp1=qkp1,
                          beta=beta, deltabar=deltabar, epsln=epsln,
                          taubar=taubar, cs=cs, sn=sn, wv=wv, wq=wq,
                          wv2=wv2, wq2=wq2, resid=resid, hist=hist,
                          mstate=mstate, indefinite=indefinite)

        out = jax.lax.while_loop(cond, body, carry)
        return (out.x[None], out.y[None], out.k, out.resid, out.hist)

    zeros = jnp.zeros((ndev, 1, 1), dtype)
    izeros = jnp.zeros((ndev, 1, 1), jnp.int32)
    ha_data = halo_a.data if halo_a is not None else zeros
    ha_cols = halo_a.cols if halo_a is not None else izeros
    hc_data = halo_c.data if halo_c is not None else zeros
    hc_cols = halo_c.cols if halo_c is not None else izeros

    operands = (blocks.a_data, blocks.a_cols, blocks.b_data, blocks.b_cols,
                blocks.bt_data, blocks.bt_cols, blocks.c_data,
                blocks.c_cols, ha_data, ha_cols, hc_data, hc_cols)
    spec_blocks = jax.tree_util.tree_map(lambda _: P(AXIS), operands)
    from .solve import precond_spec
    spec_M = precond_spec(M)

    mapped = shard_map(
        body_fn, mesh=mesh,
        in_specs=(*spec_blocks, spec_M, P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(), P(), P()),
        check_vma=False,
    )
    return mapped(*operands, M, b_sharded)
