"""Train REAL-SCALE synthetic BPE vocabularies (offline, deterministic).

Targets: cl100k_synth (pattern 2, 100,256 ranks) and o200k_synth
(pattern 3, 199,998 ranks) — run with target names as arguments.

The driver environment has zero egress, so the real cl100k_base rank
file cannot be fetched.  The north-star
metric is "encode bytes/s/chip (cl100k_base)" — a 100k-token pair table
probed through REGEX_PATTERN_2 — and nothing about that metric depends
on WHICH 100k merges the table holds.  So this tool trains a 100,256-
rank vocabulary (256 byte tokens + 100,000 merges, the exact mergeable-
rank count of cl100k_base) with standard merge-frequency BPE over a
deterministic diverse corpus, and the bench/tests pair it with the REAL
cl100k_base pattern + special-token table (models/registry.py).

Because the training is ordinary BPE, the result is merge-closed (every
multi-byte token is the concat of two lower-ranked tokens), contains
all 256 single-byte tokens at ranks 0-255, and is accepted verbatim by
Rust tiktoken's ``Encoding(pat_str=..., mergeable_ranks=...)`` — which
is the cross-oracle the conformance tests use
(tests/test_cl100k_synth.py), the same scheme as the pattern-2/3
synthetic cross-validation (tests/test_tiktoken_cross_p23.py:47-60)
scaled up ~300x.

Run:  python tools/train_synth_vocab.py [cl100k_synth] [o200k_synth]
(writes vocab/<name>.tiktoken.gz; ~1-3 min each).  Outputs are
committed, so this only reruns when the recipe changes.
"""

from __future__ import annotations

import base64
import gzip
import heapq
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: Per-target settings: 256 byte tokens + N merges match the real
#: encoding's mergeable-rank count (cl100k_base: 100,256 exactly;
#: o200k-SCALE: 199,998 ranks, sitting just under the 199,999
#: endoftext special so the real o200k special table rides on top
#: collision-free).
TARGETS = {
    "cl100k_synth": dict(pattern="p2", n_merges=100_000, corpus_mb=48.0),
    "o200k_synth": dict(pattern="p3", n_merges=199_742, corpus_mb=96.0),
}
#: Training corpus (out-of-sample from every bench seed).
CORPUS_SEED = 987_321
#: Pieces are truncated to this many bytes for TRAINING ONLY (pair
#: statistics, not encode correctness); cl100k's own longest mergeable
#: token is far below this.
MAX_WORD = 32


def piece_counts(pattern: str, corpus_mb: float):
    """(unique piece bytes, frequency) via the native scanner."""
    from bench import gen_corpus
    from tokenizer_tpu.runtime import native

    docs = gen_corpus(corpus_mb, seed=CORPUS_SEED)
    buf = "\n".join(docs).encode("utf-8")
    ctx = native.SplitContext(native.PATTERN_IDS[pattern])
    # One segment per ~4 MB window (threaded scan); windows split on
    # ASCII newlines so pieces never straddle a boundary incorrectly.
    bounds = [0]
    step = 4 << 20
    while bounds[-1] < len(buf):
        j = buf.find(b"\n", min(bounds[-1] + step, len(buf) - 1))
        bounds.append(len(buf) if j < 0 else j + 1)
    seg_start = np.asarray(bounds[:-1], np.int64)
    seg_end = np.asarray(bounds[1:], np.int64)
    uid_buf, offs, counts, news = ctx.split_batch(buf, seg_start, seg_end)
    n = int(counts.sum())
    # Segment uid runs are packed at byte offsets; gather the real uids.
    uids = np.concatenate(
        [uid_buf[int(o) : int(o) + int(c)] for o, c in zip(offs, counts)]
    )
    freq = np.bincount(uids, minlength=ctx.n_pieces)
    nu, ns, ne = news
    by_uid = {int(u): buf[s:e] for u, s, e in zip(nu, ns, ne)}
    print(f"corpus {len(buf)/1e6:.1f} MB, {n} pieces, {len(by_uid)} unique")
    return [(by_uid[u], int(freq[u])) for u in range(ctx.n_pieces)]


def train(words, n_merges: int):
    """Merge-frequency BPE with incremental pair counts.

    ``words``: list of (bytes, freq).  Returns the rank dict.  The merge
    picked each round is (max count, then lowest (left, right) symbol
    ids) — deterministic; pairs whose byte concat collides with an
    existing token are skipped (the concat can only be produced by the
    earlier-ranked token, so keeping both would strand one).
    """
    ranks = {bytes([i]): i for i in range(256)}
    sym_bytes = [bytes([i]) for i in range(256)]

    seqs = []  # list[list[int]] symbol ids per unique word
    freqs = []
    for w, f in words:
        if f <= 0 or len(w) < 2:
            continue
        seqs.append(list(w[:MAX_WORD]))
        freqs.append(f)
    counts = defaultdict(int)
    occ = defaultdict(list)  # pair -> word indices (append-only, lazy)
    for wi, s in enumerate(seqs):
        f = freqs[wi]
        for a, b in zip(s, s[1:]):
            counts[(a, b)] += f
            occ[(a, b)].append(wi)
    heap = [(-c, a, b) for (a, b), c in counts.items()]
    heapq.heapify(heap)

    # Invariant: a word currently containing pair p appears in occ[p]
    # (stale entries allowed; rewrites no-op on them).  Any adjacency in
    # a rewritten word either existed at the same spot before the
    # rewrite or involves the fresh symbol, so only fresh-symbol pairs
    # need occ appends.
    t0 = time.perf_counter()
    merged = 0
    while merged < n_merges and heap:
        negc, a, b = heapq.heappop(heap)
        c = counts.get((a, b), 0)
        if c <= 0 or -negc != c:
            continue  # stale heap entry
        tok = sym_bytes[a] + sym_bytes[b]
        if tok in ranks:
            # Collision with an existing concat: this pair can never be
            # a distinct token; retire it permanently.
            del counts[(a, b)]
            occ.pop((a, b), None)
            continue
        new_id = len(sym_bytes)
        ranks[tok] = new_id
        sym_bytes.append(tok)
        merged += 1

        wis = occ.pop((a, b), ())
        del counts[(a, b)]
        seen = set()
        touched = set()
        for wi in wis:
            if wi in seen:
                continue
            seen.add(wi)
            s = seqs[wi]
            f = freqs[wi]
            out = []
            i = 0
            changed = False
            L = len(s)
            while i < L:
                if i + 1 < L and s[i] == a and s[i + 1] == b:
                    out.append(new_id)
                    i += 2
                    changed = True
                else:
                    out.append(s[i])
                    i += 1
            if not changed:
                continue  # stale occ entry
            # Apply the pair-count delta: old adjacencies out (the
            # retired pair itself is already fully removed), new ones in.
            prev = s[0]
            for x in s[1:]:
                if prev == a and x == b:
                    prev = x
                    continue
                counts[(prev, x)] -= f
                touched.add((prev, x))
                prev = x
            prev = out[0]
            for x in out[1:]:
                p = (prev, x)
                counts[p] += f
                touched.add(p)
                if prev == new_id or x == new_id:
                    occ[p].append(wi)
                prev = x
            seqs[wi] = out
        for p in touched:
            c2 = counts.get(p)
            if c2 is None:
                continue
            if c2 > 0:
                heapq.heappush(heap, (-c2, p[0], p[1]))
            else:
                del counts[p]
                occ.pop(p, None)
        if merged % 10000 == 0:
            print(
                f"  {merged} merges, {time.perf_counter()-t0:.1f}s, "
                f"heap {len(heap)}, live pairs {len(counts)}"
            )
    if merged < n_merges:
        raise SystemExit(
            f"pair supply exhausted at {merged} merges; grow CORPUS_MB"
        )
    return ranks


def main():
    targets = [a for a in sys.argv[1:] if not a.startswith("-")] or [
        "cl100k_synth"
    ]
    for name in targets:
        cfg = TARGETS[name]
        words = piece_counts(cfg["pattern"], cfg["corpus_mb"])
        ranks = train(words, cfg["n_merges"])
        assert len(ranks) == 256 + cfg["n_merges"]
        lines = []
        for tok, rank in sorted(ranks.items(), key=lambda kv: kv[1]):
            lines.append(base64.b64encode(tok) + b" " + str(rank).encode())
        raw = b"\n".join(lines) + b"\n"
        out = REPO / "vocab" / f"{name}.tiktoken.gz"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(gzip.compress(raw, mtime=0))
        print(
            f"wrote {out} ({out.stat().st_size/1e6:.2f} MB gz, "
            f"{len(ranks)} ranks)"
        )


if __name__ == "__main__":
    main()
