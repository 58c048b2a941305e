"""XLA merge kernel: the packed tiktoken loop as a jitted JAX program.

Bit-exact device implementation of :func:`merge_packed_numpy` (which is
itself bit-exact with the host oracle).  All arithmetic is int32/uint32
(hashing with wraparound, gathers, argmin) — no floats, no x64.  The
layout is ``[L, B]`` column-per-piece: the minor dimension is the batch,
so every elementwise op and the probe gathers vectorize across pieces,
and the per-iteration argmin reduces over L.  XLA compiles it for
whichever backend JAX runs on; there is no hand-written kernel.

The merge loop runs under ``lax.while_loop`` — one *global-min merge
per column* per iteration (the reference's exact semantics,
BytePairEncoder.cs:45-64) — and exits as soon as every column has
converged, so the trip count is the max merge count in the batch, not
the tile height.

The hash-table probe is ``max_probes`` unrolled gathers (a build-time
verified bound, typically 2-6) against the replicated table arrays.
This kernel is also the unit `shard_map` maps over the data mesh
(:mod:`tokenizer_tpu.parallel`).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pair_table import MAX_RANK, PairTable

__all__ = ["merge_packed_jax", "jit_merge_fn", "lookup_pairs", "device_table"]

_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_FIB = np.uint32(0x9E3779B9)


def device_table(table: PairTable):
    """The table's device operands as a dict of jnp arrays."""
    return {
        "key_left": jnp.asarray(table.key_left),
        "key_right": jnp.asarray(table.key_right),
        "values": jnp.asarray(table.values),
    }


def lookup_pairs(
    tab,
    slot_bits: int,
    max_probes: int,
    left: jnp.ndarray,
    right: jnp.ndarray,
) -> jnp.ndarray:
    """Vectorized (left,right) -> merged id probe; MAX_RANK on miss.

    Bit-identical to :meth:`PairTable.lookup` (same uint32 mix, same
    probe order, full-key comparison, stop-at-empty).
    """
    valid = (left >= 0) & (right >= 0)
    l = jnp.where(valid, left, 0).astype(jnp.uint32)
    r = jnp.where(valid, right, 0).astype(jnp.uint32)
    h = (l * _C1) ^ (r * _C2)
    h = h ^ (h >> jnp.uint32(16))
    slot = ((h * _FIB) >> jnp.uint32(32 - slot_bits)).astype(jnp.int32)
    mask = jnp.int32((1 << slot_bits) - 1)

    out = jnp.full(left.shape, MAX_RANK, dtype=jnp.int32)
    unresolved = valid
    kl_a, kr_a, vv_a = tab["key_left"], tab["key_right"], tab["values"]
    for _ in range(max_probes):
        kl = kl_a[slot]
        kr = kr_a[slot]
        hit = unresolved & (kl == left) & (kr == right)
        out = jnp.where(hit, vv_a[slot], out)
        unresolved = unresolved & (kl != -1) & ~hit
        slot = (slot + 1) & mask
    return out


@partial(jax.jit, static_argnames=("slot_bits", "max_probes"))
def merge_packed_jax(
    tab,
    ids: jnp.ndarray,
    lengths: jnp.ndarray,
    *,
    slot_bits: int,
    max_probes: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge a packed [L, B] tile. Returns (out_ids [L,B], out_n [B])."""
    L, B = ids.shape
    n0 = lengths.astype(jnp.int32)
    row = jax.lax.broadcasted_iota(jnp.int32, (L, B), 0)

    # Initial adjacent-pair ranks (one batched probe over the tile).
    if L >= 2:
        ids_next = jnp.concatenate(
            [ids[1:], jnp.full((1, B), -1, jnp.int32)], axis=0
        )
        rank = lookup_pairs(tab, slot_bits, max_probes, ids, ids_next)
    else:
        rank = jnp.full((L, B), MAX_RANK, jnp.int32)
    rank = jnp.where(row >= n0[None, :] - 1, MAX_RANK, rank)

    def cond(state):
        _ids, rank, _n, it = state
        return jnp.logical_and(it < L - 1, jnp.min(rank) != MAX_RANK)

    def body(state):
        ids, rank, n, it = state
        cols = jax.lax.broadcasted_iota(jnp.int32, (B,), 0)

        j = jnp.argmin(rank, axis=0).astype(jnp.int32)  # first-min per col
        minrank = jnp.min(rank, axis=0)
        active = minrank != MAX_RANK
        jb = j[None, :]

        # ids: row j <- merged id (== minrank); rows > j shift up.
        ids_shift = jnp.concatenate(
            [ids[1:], jnp.full((1, B), -1, jnp.int32)], axis=0
        )
        ids_new = jnp.where(
            row < jb, ids, jnp.where(row == jb, minrank[None, :], ids_shift)
        )
        ids = jnp.where(active[None, :], ids_new, ids)
        n = jnp.where(active, n - 1, n)

        # Re-probe the two affected pairs (BytePairEncoder.cs:55-64).
        jm1 = jnp.maximum(j - 1, 0)
        jp1 = jnp.minimum(j + 1, L - 1)
        id_jm1 = ids[jm1, cols]
        id_j = ids[j, cols]
        id_jp1 = ids[jp1, cols]
        probe_left = lookup_pairs(tab, slot_bits, max_probes, id_jm1, id_j)
        probe_right = lookup_pairs(tab, slot_bits, max_probes, id_j, id_jp1)
        probe_left = jnp.where(j > 0, probe_left, MAX_RANK)
        probe_right = jnp.where(j < n - 1, probe_right, MAX_RANK)

        rank_shift = jnp.concatenate(
            [rank[1:], jnp.full((1, B), MAX_RANK, jnp.int32)], axis=0
        )
        rank_new = jnp.where(
            row < jb - 1,
            rank,
            jnp.where(
                row == jb - 1,
                probe_left[None, :],
                jnp.where(row == jb, probe_right[None, :], rank_shift),
            ),
        )
        rank_new = jnp.where(row >= n[None, :] - 1, MAX_RANK, rank_new)
        rank = jnp.where(active[None, :], rank_new, rank)

        return ids, rank, n, it + 1

    ids, rank, n, _ = jax.lax.while_loop(
        cond, body, (ids, rank, n0, jnp.int32(0))
    )
    return ids, n


def jit_merge_fn(table: PairTable):
    """Bind a PairTable's static config; returns fn(tab, ids, lengths)."""
    return partial(
        merge_packed_jax,
        slot_bits=table.slot_bits,
        max_probes=table.max_probes,
    )
