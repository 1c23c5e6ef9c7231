"""Permutation application for the preconditioner hot path.

Every factor solve applies two permutations (``z[perm]`` in, scatter out —
the P and P' of the reference's ``P L^-T D^-1 L^-1 P'`` composition,
/root/reference/ops/opLDL2.m:86).  A gather reads an index array besides
the data; structured orderings avoid that metadata.

This module provides ``PermuteOp`` implementations chosen at build time:

* ``IdentityPermute`` — no-op.
* ``InterleavePermute`` — the structured "riffle" ordering that interleaves
  the n-part and m-part proportionally (c = n/m integer): applied with
  reshapes and one concatenate, i.e. at full HBM bandwidth with zero
  index metadata.  Used when the factorization was *built* on this
  ordering (``build_factor_apply(..., base_order=...)``).
* ``DiaPermute`` — permutations whose displacement set {perm[i] - i} is
  small (local pivot swaps / amalgamation splices composed on a base
  ordering): applied as masked shifted adds, the DIA trick on a 0/1
  permutation matrix.
* ``GatherPermute`` — general fallback (RCM and friends).

``plan_permute`` picks the cheapest representation; ``compose`` covers the
factorization's (base ordering ∘ local adjustment) structure.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@partial(_register, data_fields=(), meta_fields=("n",))
@dataclasses.dataclass(frozen=True)
class IdentityPermute:
    n: int

    def apply(self, z: jax.Array) -> jax.Array:        # z[perm] = z
        return z

    def apply_inv(self, z: jax.Array) -> jax.Array:
        return z


@partial(_register, data_fields=(), meta_fields=("n", "m", "c"))
@dataclasses.dataclass(frozen=True)
class InterleavePermute:
    """Proportional riffle of the n-part and m-part, with an x-tail.

    The first m groups lay out c x-entries followed by one y-entry; the
    remaining ``n - c*m`` x-entries follow as a contiguous tail:

        perm[g*(c+1) + j] = g*c + j   (j < c, g < m)
        perm[g*(c+1) + c] = n + g
        perm[m*(c+1) + t] = c*m + t   (tail)

    Pure reshape + concatenate both ways — full HBM bandwidth, zero index
    metadata.  ``c = 1`` places y_g right next to x_g (B blocks with a unit
    main diagonal); ``c = n // m`` matches slope-c couplings x_{c g} ~ y_g.
    """

    n: int
    m: int
    c: int

    @property
    def perm(self) -> np.ndarray:
        """The explicit permutation array (host-side, for factorization)."""
        out = np.empty(self.n + self.m, dtype=np.int64)
        grid = np.arange(self.m)
        for j in range(self.c):
            out[grid * (self.c + 1) + j] = grid * self.c + j
        out[grid * (self.c + 1) + self.c] = self.n + grid
        cm = self.c * self.m
        out[self.m * (self.c + 1):] = np.arange(cm, self.n)
        return out

    def apply(self, z: jax.Array) -> jax.Array:        # z[perm]
        cm = self.c * self.m
        a = z[:cm].reshape(self.m, self.c)
        b = z[self.n: self.n + self.m].reshape(self.m, 1)
        head = jnp.concatenate([a, b], axis=1).reshape(-1)
        return jnp.concatenate([head, z[cm: self.n]])

    def apply_inv(self, z: jax.Array) -> jax.Array:    # out[perm] = z
        cm = self.c * self.m
        g = z[: self.m * (self.c + 1)].reshape(self.m, self.c + 1)
        return jnp.concatenate([g[:, : self.c].reshape(-1),
                                z[self.m * (self.c + 1):],
                                g[:, self.c]])


@partial(_register, data_fields=("masks", "inv_masks"),
         meta_fields=("n", "offsets", "inv_offsets"))
@dataclasses.dataclass(frozen=True)
class DiaPermute:
    """Permutation with a small displacement set, as masked shifted adds.

    ``z[perm][i] = z[i + d]`` for d = perm[i] - i in a small offset set:
    exactly a DIA matvec with 0/1 diagonals.
    """

    masks: jax.Array       # (ndiag, n) 0/1
    inv_masks: jax.Array   # (ndiag_inv, n) 0/1 for the inverse permutation
    n: int
    offsets: tuple
    inv_offsets: tuple

    @staticmethod
    def _shift_apply(z, masks, offsets, n):
        neg = max(0, -min(offsets))
        pos = max(0, max(offsets))
        zp = jnp.pad(z, (neg, pos))
        m = masks.astype(z.dtype)
        acc = jnp.zeros(n, z.dtype)
        for k, off in enumerate(offsets):
            acc = acc + m[k] * jax.lax.dynamic_slice_in_dim(zp, neg + off, n)
        return acc

    def apply(self, z: jax.Array) -> jax.Array:
        return self._shift_apply(z, self.masks, self.offsets, self.n)

    def apply_inv(self, z: jax.Array) -> jax.Array:
        return self._shift_apply(z, self.inv_masks, self.inv_offsets, self.n)


@partial(_register, data_fields=("idx", "inv_idx"), meta_fields=())
@dataclasses.dataclass(frozen=True)
class GatherPermute:
    idx: jax.Array      # (n,) int32: apply(z) = z[idx]
    inv_idx: jax.Array  # (n,) int32: argsort(idx)

    def apply(self, z: jax.Array) -> jax.Array:
        return jnp.take(z, self.idx)

    def apply_inv(self, z: jax.Array) -> jax.Array:
        return jnp.take(z, self.inv_idx)


@partial(_register, data_fields=("first", "second"), meta_fields=())
@dataclasses.dataclass(frozen=True)
class ComposedPermute:
    """apply(z) = second.apply(first.apply(z))  (i.e. perm = first ∘ second:
    z[perm][i] = first(z)[second_perm[i]])."""

    first: object
    second: object

    def apply(self, z: jax.Array) -> jax.Array:
        return self.second.apply(self.first.apply(z))

    def apply_inv(self, z: jax.Array) -> jax.Array:
        return self.first.apply_inv(self.second.apply_inv(z))


def _dia_from_perm(perm: np.ndarray, max_offsets: int):
    n = perm.shape[0]
    base = np.arange(n)
    disp = perm - base
    offs = np.unique(disp)
    if offs.size > max_offsets:
        return None
    inv = np.argsort(perm)
    ioffs = np.unique(inv - base)
    masks = np.stack([(disp == o) for o in offs]).astype(np.float32)
    imasks = np.stack([(inv - base == o) for o in ioffs]).astype(np.float32)
    return DiaPermute(masks=jnp.asarray(masks), inv_masks=jnp.asarray(imasks),
                      n=int(n), offsets=tuple(int(o) for o in offs),
                      inv_offsets=tuple(int(o) for o in ioffs))


def interleave_ordering(n: int, m: int,
                        c: int | None = None) -> InterleavePermute | None:
    """The proportional interleave of an n-part and an m-part with group
    size ``c`` (default n // m); leftover x-entries form the tail."""
    if m <= 0 or n < m:
        return None
    if c is None:
        c = max(1, n // m)
    if c * m > n:
        return None
    return InterleavePermute(n=int(n), m=int(m), c=int(c))


def interleave_candidates(n: int, m: int) -> list:
    """Candidate structured orderings, cheapest-bandwidth-wins at the
    caller: c = 1 (y_g beside x_g — unit-diagonal B blocks) and c = n//m
    (slope-matched couplings)."""
    cands = []
    for c in {1, max(1, n // m if m else 1)}:
        op = interleave_ordering(n, m, c)
        if op is not None:
            cands.append(op)
    return cands


def plan_permute(perm: np.ndarray, base: InterleavePermute | None = None,
                 max_offsets: int = 48):
    """Best gather-free representation of ``z -> z[perm]``.

    ``base`` is the structured ordering the factorization was seeded with
    (make_preconditioner's interleave); when the final factor ordering
    differs from it only by local splices, the result is the reshape-speed
    base composed with a DiaPermute of the residual displacement.
    """
    n = perm.shape[0]
    base_arr = np.arange(n)
    if np.array_equal(perm, base_arr):
        return IdentityPermute(n=int(n))
    if base is not None and base.n + base.m == n:
        bp = base.perm
        if np.array_equal(perm, bp):
            return base
        # perm = bp ∘ delta: z[perm][i] = z[bp][delta[i]] with
        # delta = pos-in-bp of perm, local when only splices happened.
        pos = np.empty(n, dtype=np.int64)
        pos[bp] = base_arr
        delta = pos[perm]
        d = _dia_from_perm(delta, max_offsets)
        if d is not None:
            return ComposedPermute(first=base, second=d)
    d = _dia_from_perm(perm, max_offsets)
    if d is not None:
        return d
    return GatherPermute(idx=jnp.asarray(perm.astype(np.int32)),
                         inv_idx=jnp.asarray(np.argsort(perm)
                                             .astype(np.int32)))
