"""Ragged piece packing into fixed-shape device tiles.

Regex pieces are short (SURVEY.md §5 long-context: merges never cross
piece boundaries, so any document decomposes into independent pieces).
The packer buckets unique pieces by byte length into column-major
``[L, B]`` int32 tiles — the minor dimension is the batch, so every
elementwise op of the merge loop vectorizes across pieces, and L stays
a multiple of 8.

Bucket L in ``BUCKETS`` (16..512); pieces longer than the widest
bucket (pathological p50k digit runs / no-whitespace runs, SURVEY.md §7
'oversized-piece tail') are routed to the host oracle and counted,
never silently truncated.  Length-1 pieces skip the kernel entirely
(their id is ``byte_to_id[b]``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PackedBatch",
    "PackPlan",
    "SpanPlan",
    "pack_pieces",
    "pack_spans",
    "BUCKETS",
    "LANE",
]

#: Piece-length buckets (multiples of 8).  The device path covers
#: pieces up to 512 bytes — no-whitespace scripts (Chinese/Japanese
#: text under every pattern generation) produce multi-hundred-byte
#: `\p{L}+` pieces as the NORM, so they belong on the chip; beyond 512
#: the O(L) while-loop trip count stops paying and the native C++
#: heap-merge fallback (runtime/native tt_bpe_encode) takes over.
BUCKETS: Tuple[int, ...] = (16, 64, 128, 256, 512)
#: Batch quantum — batch dims are padded to a multiple of this.
LANE = 128
#: Widest tile the packer emits.  Together with the power-of-two tiers
#: this bounds the COMPILED SHAPE SET to ~log2(MAX_B/LANE)+1 widths per
#: bucket — every novel shape costs an XLA compile, which an unbounded
#: one-off [16, 65536] tile would pay for far less compute.  Oversized
#: unique-piece waves simply emit several MAX_B tiles, which also
#: pipelines: the merge dispatches are async, so tile k+1's host fill
#: overlaps tile k's device execution.
MAX_B = 8192


@dataclass
class PackedBatch:
    """One bucket's packed tile: ids[L, B] (pad -1) + lengths[B] (pad 0)."""

    l_max: int
    ids: np.ndarray  # int32 [L, B]
    lengths: np.ndarray  # int32 [B]
    n_real: int  # columns that carry real pieces (<= B)


@dataclass
class PackPlan:
    """Routing of a unique-piece list into tiles / direct / host paths.

    ``route[i]`` for unique piece i is one of:
      ('direct', token_id)            — length-1 piece
      ('bucket', batch_idx, column)   — packed into batches[batch_idx]
      ('host', host_idx)              — host-oracle fallback

    A bucket may span several batches (tiles) when more than ``MAX_B``
    pieces of its length class arrive at once.
    """

    batches: List[PackedBatch]
    route: List[tuple]
    host_pieces: List[bytes]

    @property
    def n_host_fallback(self) -> int:
        return len(self.host_pieces)


@dataclass
class SpanPlan:
    """Fully-vectorized routing of a span wave into tiles.

    The span twin of :class:`PackPlan`, cutting the per-wave blocking
    host cost: routing lives in ARRAYS, not per-piece tuples,
    so dispatch and finish never run a per-piece Python loop.

    ``batch_piece_idx[b][col]`` is the wave index of tile b's column
    col; ``direct_idx``/``direct_ids`` are the length<=1 pieces and
    their ids (-1 for empty); ``host_idx`` the oversized pieces routed
    to the host oracle.
    """

    batches: List[PackedBatch]
    batch_piece_idx: List[np.ndarray]
    direct_idx: np.ndarray
    direct_ids: np.ndarray
    host_idx: np.ndarray


def pack_spans(
    buf,
    starts: np.ndarray,
    ends: np.ndarray,
    byte_to_id: np.ndarray,
    buckets: Tuple[int, ...] = BUCKETS,
    lane: int = LANE,
    b_quantum: Optional[int] = None,
) -> SpanPlan:
    """Pack byte-range spans of one buffer into per-bucket tiles.

    Vectorized end to end — bucket assignment via ``searchsorted``,
    tile fill via one fancy-index gather — with no per-piece Python loop.
    Force-host pieces are
    assumed already filtered (the native wave path does this during uid
    registration).
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    lens = ends - starts
    quantum = b_quantum or lane
    max_b = max(MAX_B, quantum)
    barr = np.asarray(buckets, dtype=np.int64)
    bview = (
        np.frombuffer(buf, dtype=np.uint8)
        if isinstance(buf, (bytes, bytearray, memoryview))
        else buf
    )
    bi = np.searchsorted(barr, lens, side="left")  # first L >= len
    direct = lens <= 1
    host = (~direct) & (bi >= len(buckets))
    batches: List[PackedBatch] = []
    batch_piece_idx: List[np.ndarray] = []
    for b_i, L in enumerate(buckets):
        sel = np.nonzero((bi == b_i) & ~direct)[0]
        if sel.size == 0:
            continue
        if sel.size > max_b:
            # Length-homogeneous tiles for multi-tile buckets (the merge
            # loop's trip count is the tile's max merge count).
            sel = sel[np.argsort(lens[sel], kind="stable")]
        for s0 in range(0, sel.size, max_b):
            chunk = sel[s0 : s0 + max_b]
            n_real = len(chunk)
            B = quantum
            while B < n_real:
                B *= 2
            l = lens[chunk]
            row = np.arange(L, dtype=np.int64)[:, None]
            mask = row < l[None, :]
            flat = np.minimum(starts[chunk][None, :] + row, bview.size - 1)
            ids = np.full((L, B), -1, dtype=np.int32)
            ids[:, :n_real] = np.where(mask, byte_to_id[bview[flat]], -1)
            lengths = np.zeros((B,), dtype=np.int32)
            lengths[:n_real] = l
            batches.append(
                PackedBatch(l_max=L, ids=ids, lengths=lengths, n_real=n_real)
            )
            batch_piece_idx.append(chunk)
    d_idx = np.nonzero(direct)[0]
    d_ids = np.full(d_idx.size, -1, dtype=np.int32)
    one = lens[d_idx] == 1
    d_ids[one] = byte_to_id[bview[starts[d_idx[one]]]]
    return SpanPlan(
        batches=batches,
        batch_piece_idx=batch_piece_idx,
        direct_idx=d_idx,
        direct_ids=d_ids,
        host_idx=np.nonzero(host)[0],
    )


def pack_pieces(
    pieces: Sequence[bytes],
    byte_to_id: np.ndarray,
    buckets: Tuple[int, ...] = BUCKETS,
    lane: int = LANE,
    force_host: Optional[set] = None,
    b_quantum: Optional[int] = None,
) -> PackPlan:
    """Pack unique piece byte-strings into per-bucket [L, B] tiles.

    ``force_host`` is the (normally empty) set of pieces that must take
    the host oracle — the pair-merge-unreachable vocab tokens from
    :meth:`PairTable.verify_merge_closure`.

    ``b_quantum`` (default: ``lane``) is the smallest batch tier; B is
    always ``b_quantum * 2**k``.  The sharded merge path passes
    ``mesh_size * lane`` so every tile divides evenly into lane-aligned
    per-device shards (SURVEY.md §2.3 DP row).
    """
    per_bucket: List[List[int]] = [[] for _ in buckets]
    route: List[tuple] = [None] * len(pieces)  # type: ignore[list-item]
    host_pieces: List[bytes] = []
    batches: List[PackedBatch] = []
    quantum = b_quantum or lane
    max_b = max(MAX_B, quantum)

    for i, p in enumerate(pieces):
        n = len(p)
        if n == 0:
            route[i] = ("direct", -1)
            continue
        if force_host is not None and p in force_host:
            route[i] = ("host", len(host_pieces))
            host_pieces.append(p)
            continue
        if n == 1:
            route[i] = ("direct", int(byte_to_id[p[0]]))
            continue
        for bi, L in enumerate(buckets):
            if n <= L:
                per_bucket[bi].append(i)
                break
        else:
            route[i] = ("host", len(host_pieces))
            host_pieces.append(p)

    for bi, L in enumerate(buckets):
        idxs = per_bucket[bi]
        # Sort by length so multi-tile buckets get length-homogeneous
        # tiles: the merge loop's trip count is the tile's MAX merge
        # count, so mixing short and long pieces stalls short columns
        # on the longest one.
        if len(idxs) > max_b:
            idxs.sort(key=lambda i: len(pieces[i]))
        # Chunk the bucket into tiles of at most max_b columns; the last
        # (or only) tile pads B to a power-of-two tier >= quantum so the
        # compiled shape set stays bounded.
        for start in range(0, len(idxs), max_b):
            chunk = idxs[start : start + max_b]
            n_real = len(chunk)
            B = quantum
            while B < n_real:
                B *= 2
            batch_idx = len(batches)
            batches.append(
                _fill_tile(pieces, chunk, L, B, byte_to_id, route, batch_idx)
            )

    return PackPlan(batches=batches, route=route, host_pieces=host_pieces)


def _fill_tile(
    pieces, chunk, L, B, byte_to_id, route, batch_idx
) -> PackedBatch:
    """Vectorized fill of one [L, B] tile from the chunk's piece bytes."""
    n_real = len(chunk)
    sel = [pieces[pi] for pi in chunk]
    blob = np.frombuffer(b"".join(sel), dtype=np.uint8)
    lens = np.fromiter((len(p) for p in sel), dtype=np.int32, count=n_real)
    offs = np.zeros(n_real, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    row = np.arange(L, dtype=np.int64)[:, None]
    mask = row < lens[None, :]
    flat = np.minimum(offs[None, :] + row, blob.size - 1)
    ids = np.full((L, B), -1, dtype=np.int32)
    ids[:, :n_real] = np.where(mask, byte_to_id[blob[flat]], -1)
    lengths = np.zeros((B,), dtype=np.int32)
    lengths[:n_real] = lens
    for col, pi in enumerate(chunk):
        route[pi] = ("bucket", batch_idx, col)
    return PackedBatch(l_max=L, ids=ids, lengths=lengths, n_real=n_real)
