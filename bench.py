"""Throughput benchmark — prints ONE JSON line.

Headline metric: steady-state end-to-end encode bytes/s of the device
pipeline (pipelined encode_batch_stream) on a procedurally DIVERSE
corpus, with the NORTH-STAR encoding shape: REGEX_PATTERN_2 + the real
cl100k special-token table + a 100,256-rank pair table (the vendored
cl100k_synth vocabulary, cross-validated id-for-id against Rust
tiktoken — BASELINE.json names the metric "encode bytes/s/chip
(cl100k_base)" and the reference's own perf rigs bench the gpt-4
tokenizer, PerfBenchmark/Program.cs:29-37).  Measured with the
REFERENCE'S protocol: the reference's 20.27 MB/s comes from looping the
same corpus >=5 cycles through its warm LRU
(tokenizer_ts/perf/benchmark-folder.js:23-37, notebook cell 8), so the
comparable number here is the min-cycle time over the same corpus with
the dedup table warm.  A gpt2/pattern-1 block is retained for
continuity.  The headline line names the device it ran on.

Also measured (reported on stderr as a JSON detail record):
  * COLD e2e (first pass over the corpus, dedup table empty): every
    document carries fresh identifiers/numbers/unicode, so unique
    pieces keep arriving for the whole timed region;
  * kernel-only device throughput per bucket (merge_packed_jax,
    device-resident operands, jax.block_until_ready-fenced);
  * overlap A/B (synchronous per-chunk vs the pipelined stream);
  * forced-device cold e2e with full host-oracle parity.

Everything runs in ONE process: a JAX process reserves most of the
card's memory, so a second one could not open it.  A failed block
fails the run.

Baseline: 20.27 MB/s single-thread encode of the released
@microsoft/tiktokenizer (reference perf notebook cell 8, BASELINE.md).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

BASELINE_MBS = 20.27

#: Seed code text for the corpus: the reference's conformance file,
#: vendored in the repo.
SEED_TEXT = Path(__file__).resolve().parent / "tests" / "testdata" / "lib.rs.txt"

_WORDS = (
    "the of and to in is was he for it with as his on be at by had not are"
    " but from or have an they which one you were all her she there would"
    " their we him been has when who will no more if out so up said what"
    " its about than into them can only other time new some could these"
    " two may first then do any like my now over such our man me even most"
    " made after also did many off before must well back through years"
    " where much your way down should because each just those people how"
    " too little state good very make world still see own men work long"
    " here get both between life being under never day same another know"
    " while last might us great old year come since against go came right"
    " used take three".split()
)


def _load_seed_text() -> str:
    return SEED_TEXT.read_text(encoding="utf-8")


def gen_corpus(target_mb: float, seed: int) -> list:
    """Diverse documents: code with renamed identifiers, fresh numeric
    literals, Zipf-ish natural text, and unicode runs.  Unique-piece
    arrival stays roughly uniform across the corpus."""
    rng = np.random.default_rng(seed)
    base = _load_seed_text()
    # Chunk the seed code file into ~8 KB windows.
    chunks = [base[i : i + 8192] for i in range(0, len(base), 8192)]
    docs = []
    total = 0
    target = int(target_mb * 1e6)
    alpha = "abcdefghijklmnopqrstuvwxyz"
    k = 0
    while total < target:
        kind = k % 4
        k += 1
        if kind == 0:
            # Code chunk with per-doc identifier renaming: splice a fresh
            # suffix into every word boundary-ish position.
            c = chunks[int(rng.integers(len(chunks)))]
            suf = "_" + "".join(
                alpha[i] for i in rng.integers(0, 26, size=6)
            )
            doc = c.replace("self", "slf" + suf).replace("fn ", "fn x" + suf)
        elif kind == 1:
            # Natural-ish text with occasional fresh rare words.
            n = int(rng.integers(600, 1400))
            idx = rng.zipf(1.3, size=n) % len(_WORDS)
            words = [_WORDS[i] for i in idx]
            for j in range(0, n, 37):
                words[j] = "".join(
                    alpha[i] for i in rng.integers(0, 26, size=int(rng.integers(5, 12)))
                )
            doc = " ".join(words)
        elif kind == 2:
            # Numeric/log-like lines: fresh digit runs every doc.
            rows = [
                f"[{int(rng.integers(1e9)):010d}] metric_{int(rng.integers(1e4))}"
                f" = {rng.random():.9f} ({int(rng.integers(1e6))} us)"
                for _ in range(int(rng.integers(40, 120)))
            ]
            doc = "\n".join(rows)
        else:
            # Unicode mix: CJK runs + accents + emoji-ish stars.
            n = int(rng.integers(200, 600))
            cps = rng.integers(0x4E00, 0x4E00 + 2000, size=n)
            doc = (
                "".join(chr(c) for c in cps)
                + " étoile ⭐ " * int(rng.integers(1, 5))
            )
        docs.append(doc)
        total += len(doc.encode("utf-8"))
    return docs


def _nbytes(docs) -> int:
    return sum(len(d.encode("utf-8")) for d in docs)


def e2e_bench(tok, docs, cycles: int = 3, chunk_docs: int = 512):
    """(cold_seconds, steady_seconds_min, stats_delta, tokens).

    Cold runs the PRODUCTION shape: the pipelined chunk stream
    (encode_batch_stream), so host split of chunk k+1 overlaps the
    device merging chunk k, exactly like encode_corpus.  Steady re-runs
    the same corpus with the dedup table hot (the reference-LRU
    analogue of natural-language traffic).
    """
    chunks = [docs[i : i + chunk_docs] for i in range(0, len(docs), chunk_docs)]
    before = tok.stats.as_dict()
    t0 = time.perf_counter()
    out = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
    cold = time.perf_counter() - t0
    delta = {k: tok.stats.as_dict()[k] - before[k] for k in before}
    tokens = int(sum(len(ids) for ids in out))
    steady = float("inf")
    for _ in range(cycles):
        t0 = time.perf_counter()
        for _batch in tok.encode_batch_stream(chunks):
            pass
        steady = min(steady, time.perf_counter() - t0)
    # Second genuinely-cold pass (BOTH dedup generations dropped —
    # rotation alone keeps the old bank warm) for hypervisor-steal
    # spike rejection — min-of-2, same spirit as steady's min-of-cycles.
    tok._reset_dedup_full()
    t0 = time.perf_counter()
    for _batch in tok.encode_batch_stream(chunks):
        pass
    cold = min(cold, time.perf_counter() - t0)
    return cold, steady, delta, tokens


def _synth_bucket_pieces(rng, lo: int, hi: int, count: int = 64):
    """Realistic pieces for a byte-length window the corpus sample left
    empty: CJK `\\p{L}+` runs (the packer routes no-space scripts to the
    big buckets by design, ops/packing.py BUCKETS note), plus digit and
    no-space ASCII runs."""
    out = []
    for k in range(count):
        kind = k % 3
        target = int(rng.integers(lo + 1, hi + 1))
        if kind == 0:  # CJK run (3-byte chars; never split a char)
            n = max(1, target // 3)
            cps = rng.integers(0x4E00, 0x4E00 + 2000, size=n)
            out.append("".join(chr(c) for c in cps).encode("utf-8"))
        elif kind == 1:  # digit run (p50k-style unbounded digits)
            out.append(bytes(rng.integers(48, 58, size=target).astype("u1")))
        else:  # no-space ASCII identifier run
            out.append(
                bytes(rng.integers(97, 123, size=target).astype("u1"))
            )
    return [p for p in out if lo < len(p) <= hi]


def bucket_pieces(tok, docs, buckets=None) -> dict:
    """Realistic pieces per packing bucket: ``{L: [piece bytes, ...]}``.

    Buckets the corpus sample's real regex pieces by byte length; windows
    where the sample has few pieces (the big CJK buckets) are topped up
    with synthesized realistic pieces so EVERY bucket has varied work.
    Sorted, so the result depends only on the corpus."""
    from tokenizer_tpu.ops.packing import BUCKETS

    buckets = BUCKETS if buckets is None else buckets
    pieces = set()
    for d in docs[:200]:
        pieces.update(p.encode("utf-8") for p in tok._split(d, 0, len(d)))
    by_bucket = {}
    rng = np.random.default_rng(1234)
    prev = 1
    for L in buckets:
        by_bucket[L] = sorted(p for p in pieces if prev < len(p) <= L)
        if len(by_bucket[L]) < 64:
            by_bucket[L] += _synth_bucket_pieces(rng, prev, L)
        prev = L
    return by_bucket


def kernel_bench(tok, docs):
    """Device-kernel-only throughput per bucket (block_until_ready)."""
    import jax

    from tokenizer_tpu.ops.packing import BUCKETS

    tok._ensure_device()
    table, merge_fn, tab = tok.table, tok._merge_fn, tok._device_tab()
    by_bucket = bucket_pieces(tok, docs)
    results = {}
    import jax.numpy as jnp

    B = tok._b_quantum * max(1, 2048 // tok._b_quantum)
    for L in BUCKETS:
        pool = by_bucket[L]
        if not pool:
            continue
        ids = np.full((L, B), -1, np.int32)
        lengths = np.zeros(B, np.int32)
        nb = 0
        for c in range(B):
            p = pool[c % len(pool)]
            ids[: len(p), c] = table.byte_to_id[np.frombuffer(p, np.uint8)]
            lengths[c] = len(p)
            nb += len(p)
        # Device-resident operands: this measures the KERNEL, not the
        # host transfers (which the e2e numbers carry).
        di, dl = jnp.asarray(ids), jnp.asarray(lengths)
        jax.block_until_ready(merge_fn(tab, di, dl))  # compile
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(merge_fn(tab, di, dl))
            best = min(best, time.perf_counter() - t0)
        results[f"L{L}"] = {
            "pieces_per_s": round(B / best),
            "MB_per_s": round(nb / best / 1e6, 2),
            "batch": B,
            "seconds": round(best, 5),
        }
    return results


def overlap_ab(docs, chunk_docs: int = 128, rounds: int = 3):
    """A/B: synchronous per-chunk encode_batch vs the pipelined stream.

    Per round, two fresh tokenizers (so both arms are equally cold)
    encode the same chunked corpus; the pipelined arm overlaps host
    split of chunk k+1 with the device merging chunk k.  Min over
    rounds rejects hypervisor-steal spikes
    on shared hosts, which otherwise dwarf the effect under test.
    """
    from tokenizer_tpu import create_by_encoder_name

    chunks = [docs[i : i + chunk_docs] for i in range(0, len(docs), chunk_docs)]

    def run_sync():
        tok = create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=True)
        tok.encode_batch(gen_corpus(0.2, seed=321))  # compile warmup
        t0 = time.perf_counter()
        for c in chunks:
            tok.encode_batch(c)
        return time.perf_counter() - t0

    def run_pipe():
        tok = create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=True)
        tok.encode_batch(gen_corpus(0.2, seed=321))
        t0 = time.perf_counter()
        for _ in tok.encode_batch_stream(chunks):
            pass
        return time.perf_counter() - t0

    sync_s = pipe_s = float("inf")
    for r in range(rounds):
        # Alternate arm order: process-global drift (e.g. probe threads
        # accumulating per tokenizer) must not systematically tax one
        # arm.
        arms = (run_sync, run_pipe) if r % 2 == 0 else (run_pipe, run_sync)
        for arm in arms:
            dt = arm()
            if arm is run_sync:
                sync_s = min(sync_s, dt)
            else:
                pipe_s = min(pipe_s, dt)
    return {
        "sync_s": round(sync_s, 3),
        "pipelined_s": round(pipe_s, 3),
        "speedup": round(sync_s / pipe_s, 3) if pipe_s else None,
        "note": (
            "since the fused scan+merge+EMIT landed, host-routed chunks"
            " are a SINGLE native pass in both arms — sync vs pipelined"
            " do near-identical work and parity +/- noise is the"
            " structurally correct result; the stream's remaining"
            " overlap (device merge of chunk k under split of k+1)"
            " applies only to device-routed waves, i.e. on a healthy"
            " transport"
        ),
    }


def force_device_route(tok, timeout: float = 300.0) -> None:
    """Send every merge wave above the router's floor to the device.

    Waits for the channel probe, fails when the device route did not
    come up, then pins the host route's cost to +inf, so the adaptive
    router (and the fused-split predicate) prefer the device for any
    wave above ``_HOST_WAVE_MAX``.
    """
    tok._start_channel_probe()
    if not tok._dev_event.wait(timeout) or not tok._dev_ready:
        raise RuntimeError(
            f"device route not ready: {tok.device_error or 'probe timed out'}"
        )
    tok._host_pp = float("inf")


def device_e2e_forced():
    """Cold e2e with every merge wave FORCED onto the device.

    The adaptive router keeps the device off the critical path when the
    host wins, which leaves no number showing the DEVICE pipeline
    sustaining e2e throughput.  This block measures exactly that, in
    this process (one process per card), with full-output parity
    against the host engine.
    """
    from tokenizer_tpu import create_by_encoder_name

    docs = gen_corpus(1.0, seed=11)
    nbytes = _nbytes(docs)
    tok = create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=True)
    force_device_route(tok)
    chunks = [docs[i : i + 256] for i in range(0, len(docs), 256)]
    before = tok.stats.as_dict()
    t0 = time.perf_counter()
    out = [ids for b in tok.encode_batch_stream(chunks) for ids in b]
    cold = time.perf_counter() - t0
    d = {k: tok.stats.as_dict()[k] - before[k] for k in before}
    host = create_by_encoder_name("gpt2", allow_fetch=False)
    for i, doc in enumerate(docs):
        assert list(out[i]) == host.encode(doc), i
    return {
        "MBps": round(nbytes / cold / 1e6, 2),
        "seconds": round(cold, 3),
        "bytes": nbytes,
        "device_pieces": d["device_pieces"],
        "unique_pieces": d["unique_pieces"],
        "parity_checked_docs": len(docs),
    }


def scan_threads_bench(docs, cycles: int = 5):
    """Split-phase (native scan+intern, steady) MB/s at 1/2/4/8 threads.

    The e2e headline is host-scan-bound, so the scan's thread-scaling
    curve is the record that matters; thread tiers above the host's
    free cores measure oversubscription.  Pure scan (no interning) is
    the per-thread ceiling.
    """
    import numpy as np

    from tokenizer_tpu.runtime import native

    if not native.available():
        return {"error": "native unavailable"}
    datas = [d.encode("utf-8") for d in docs]
    buf = b"".join(datas)
    ends = np.cumsum([len(d) for d in datas], dtype=np.int64)
    starts = ends - np.array([len(d) for d in datas], dtype=np.int64)
    n = len(buf)

    def best(f, k=cycles):
        b = float("inf")
        for _ in range(k):
            t0 = time.perf_counter()
            f()
            b = min(b, time.perf_counter() - t0)
        return b

    pure = best(lambda: native.presplit(buf, 2))
    ctx = native.SplitContext(2)
    ctx.split_batch(buf, starts, ends, nthreads=1)  # intern (warm-up)
    points = []
    for t in (1, 2, 4, 8):
        b = best(lambda: ctx.split_batch(buf, starts, ends, nthreads=t))
        points.append(
            {"threads": t, "MBps": round(n / b / 1e6, 1)}
        )
    # The PRODUCTION steady pass is scan+intern+EMIT (token ids written
    # in-scan); measure it at the same thread tiers so the artifact
    # carries the e2e-relevant native ceiling, not just the uid scan.
    from tokenizer_tpu import create_by_encoder_name

    tok = create_by_encoder_name(
        "cl100k_synth", allow_fetch=False, use_tpu=True
    )
    # Host-only: this block measures the native scan; a channel-probe
    # thread compiling during the 1T/2T tiers would steal a core.
    tok._dev_probe_started = True
    tok._dev_event.set()
    tok.encode_batch(docs)  # resolve every row through the real path
    args = (
        tok.table,
        tok._rows,
        tok._row_len,
        tok._row_u16,
        tok._uid_rows,
    )
    ectx = tok._split_ctx
    emit_points = []
    for t in (1, 2, 4, 8):
        b = best(
            lambda: ectx.split_emit_batch(
                buf,
                starts,
                ends,
                *args,
                tok._n_rows,
                ovf_pool=tok._ovf_pool,
                nthreads=t,
                uid_ids=tok._uid_ids,
            )
        )
        emit_points.append({"threads": t, "MBps": round(n / b / 1e6, 1)})
    return {
        "pure_scan_MBps": round(n / pure / 1e6, 1),
        "steady_points": points,
        "emit_points": emit_points,
        "bytes": n,
    }


def decode_bench(tok, docs, cycles: int = 5):
    """Bulk decode throughput (flattened single-gather decode_batch)."""
    ids = tok.encode_batch(docs)
    out_bytes = sum(
        len(t.encode("utf-8", "ignore")) for t in tok.decode_batch(ids)
    )
    best = float("inf")
    for _ in range(cycles):
        t0 = time.perf_counter()
        tok.decode_batch(ids)
        best = min(best, time.perf_counter() - t0)
    return {
        "decode_MBps": round(out_bytes / best / 1e6, 2),
        "tokens": int(sum(len(x) for x in ids)),
        "bytes_out": out_bytes,
    }


def trim_bench(tok, docs, cycles: int = 3, budget: int = 64):
    """encodeTrimSuffix bulk throughput (the reference perf harness
    loops encodeTrimSuffix too, benchmark-folder.js:30-35); budget-aware
    assembly means MB/s here measures split+merge+bookkeeping, not
    output materialization."""
    nbytes = _nbytes(docs)
    tok.encode_trim_suffix_batch(docs[:32], budget)  # warm
    best = float("inf")
    for _ in range(cycles):
        t0 = time.perf_counter()
        tok.encode_trim_suffix_batch(docs, budget)
        best = min(best, time.perf_counter() - t0)
    return {
        "trim_suffix_MBps": round(nbytes / best / 1e6, 2),
        "budget": budget,
        "docs": len(docs),
    }


def corpus_cold_blend(docs, copies: int = 6):
    """Cold/steady blend at the BASELINE north-star corpus shape:
    a ~48 MB high-unique-rate corpus (per-copy
    identifier mutation keeps fresh pieces arriving throughout) with
    ``max_unique_rows`` scaled so generational ROTATION is active —
    a 1/20-scale model of the 1 GB-corpus config (1 GB at default
    1M-row bound rotates ~8x; this reproduces that regime).  Records
    whether the cold path is first-order for the north-star mix.
    """
    from tokenizer_tpu import create_by_encoder_name

    big = []
    for k in range(copies):
        # LETTER tags: a digit tag would split off as its own \p{N}
        # piece under the cl100k pattern and create almost no fresh
        # word pieces (measured: 6 copies added only ~1.4k uniques).
        tag = "qjxzvwky"[k % 8]
        big.extend(d.replace("e", "e" + tag).replace("a", tag + "a") for d in docs)
    nbytes = _nbytes(big)
    tok = create_by_encoder_name(
        "cl100k_synth",
        allow_fetch=False,
        use_tpu=True,
        # Rotation-active but NOT thrashing: total uniques (~56k)
        # exceed the per-generation bound (32k) so rotations + old-gen
        # resurrection run, while the bound stays above the
        # instantaneous hot set (~20k/copy).  At 1<<14 (8k bound <
        # hot set) eviction thrash re-merges the hot set every
        # generation and collapses throughput; size
        # ``max_unique_rows`` above the working set.
        max_unique_rows=1 << 16,
    )
    tok._dev_probe_started = True
    tok._dev_event.set()  # host-route: this block measures the scan path
    chunks = [big[i : i + 512] for i in range(0, len(big), 512)]
    with _StealMeter() as sm:
        t0 = time.perf_counter()
        for _b in tok.encode_batch_stream(chunks):
            pass
        cold = time.perf_counter() - t0
    steady = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _b in tok.encode_batch_stream(chunks):
            pass
        steady = min(steady, time.perf_counter() - t0)
    d = tok.stats.as_dict()
    return {
        "bytes": nbytes,
        "cold_MBps": round(nbytes / cold / 1e6, 2),
        "steady_MBps": round(nbytes / steady / 1e6, 2),
        "unique_pieces": d["unique_pieces"],
        "dedup_resets": d["dedup_resets"],
        "dedup_gen_copies": d["dedup_gen_copies"],
        "steal_pct": sm.steal_pct,
        "note": (
            "cold pass IS the north-star blend (fresh pieces keep"
            " arriving + rotation active); steady re-pass also rotates"
            " (cross-generation repeats resurrect from the old bank),"
            " so blend ~= both numbers.  Bound sizing matters: a"
            " generation bound below the hot working set thrashes"
        ),
    }


def _steal_jiffies():
    """(steal, total) jiffies from /proc/stat — the hypervisor-steal
    meter.  Shared hosts see steal bursts; recording the
    timed region's steal share makes a poisoned window self-documenting
    in the artifact instead of masquerading as a regression."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        vals = [int(x) for x in parts[1:9]]
        return vals[7], sum(vals)
    except Exception:
        return 0, 0


class _StealMeter:
    def __enter__(self):
        self.s0, self.t0 = _steal_jiffies()
        return self

    def __exit__(self, *exc):
        s1, t1 = _steal_jiffies()
        dt = t1 - self.t0
        self.steal_pct = round(100.0 * (s1 - self.s0) / dt, 1) if dt else None


def _e2e_block(tok, docs, nbytes: int, cycles: int):
    """Warm-up on an out-of-sample seed, then cold + steady e2e."""
    tok.encode_batch(gen_corpus(0.5, seed=123))
    # Let the channel probe (and its jit compile, which contends for
    # host cores) settle before the timed region.
    ev = getattr(tok, "_dev_event", None)
    if ev is not None:
        ev.wait(45.0)
    done = getattr(tok, "_probe_thread_done", None)
    if done is not None:
        # Readiness is not the end of the probe THREAD: pre-arm wave
        # compiles continue on it and steal a core from the timed region.
        done.wait(60.0)
    with _StealMeter() as sm:
        cold_s, steady_s, delta, tokens = e2e_bench(tok, docs, cycles=cycles)
    return {
        "e2e_cold_MBps": round(nbytes / cold_s / 1e6, 2),
        "e2e_steady_MBps": round(nbytes / steady_s / 1e6, 2),
        "tokens": tokens,
        "steal_pct_during_block": sm.steal_pct,
        "timed_region_stats_delta": delta,
    }


def _steady_only(tok, docs, nbytes: int, cycles: int):
    """One more min-of-cycles steady pass (corpus already warm)."""
    with _StealMeter() as sm:
        best = float("inf")
        for _ in range(cycles):
            t0 = time.perf_counter()
            for _batch in tok.encode_batch_stream(
                [docs[i : i + 512] for i in range(0, len(docs), 512)]
            ):
                pass
            best = min(best, time.perf_counter() - t0)
    return round(nbytes / best / 1e6, 2), sm.steal_pct


def measure():
    import jax

    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    fast = os.environ.get("BENCH_FAST") == "1"
    target_mb = 4.0 if fast else 8.0

    from tokenizer_tpu import create_by_encoder_name

    docs = gen_corpus(target_mb, seed=7)
    nbytes = _nbytes(docs)
    # Steady is min-of-cycles; hypervisor steal spikes on shared hosts
    # make more cycles = better spike rejection.
    cycles = 3 if fast else 5

    # PRIMARY: the north-star shape — REGEX_PATTERN_2 + real cl100k
    # special table + a 100,256-rank pair table (BASELINE.json metric:
    # "encode bytes/s/chip (cl100k_base)"; the vendored synthetic ranks
    # are cross-validated vs Rust tiktoken, tests/test_cl100k_synth.py).
    def note(msg):
        print(f"# phase {msg} t={time.perf_counter()-T0:.0f}s", file=sys.stderr, flush=True)

    T0 = time.perf_counter()
    tok_c = create_by_encoder_name(
        "cl100k_synth", allow_fetch=False, use_tpu=True
    )
    # Kernel-only blocks run first, before any e2e block starts a
    # channel-probe thread, so no probe compile shares the host with
    # their timed regions.  Their operands are device-resident, so the
    # numbers time the card, not host transfers.
    note("kernel cl100k")
    kern_c = kernel_bench(tok_c, docs)
    note("kernel gpt2")
    tok_g = create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=True)
    kern_g = None if fast else kernel_bench(tok_g, docs)

    note("e2e cl100k")
    cl100k = _e2e_block(tok_c, docs, nbytes, cycles)
    cl100k["kernel_only"] = kern_c
    cl100k["stats_total"] = tok_c.stats.as_dict()

    # SECONDARY: gpt2/pattern-1 (round-1/2 continuity).  Secondary
    # tokenizers run HOST-ONLY (probe suppressed): their blocks measure
    # the host-route e2e, and a second/third probe thread compiling
    # would steal host cores from them (the device route is exercised by
    # the primary + forced-device blocks).
    def _host_only(tok):
        tok._dev_probe_started = True
        tok._dev_event.set()
        return tok

    note("e2e gpt2")
    gpt2 = _e2e_block(_host_only(tok_g), docs, nbytes, cycles)
    gpt2["note"] = "host-route only (secondary probe suppressed)"
    s2, st2 = _steady_only(tok_g, docs, nbytes, max(cycles - 2, 2))
    gpt2["e2e_steady_MBps"] = max(gpt2["e2e_steady_MBps"], s2)
    gpt2["steal_pct_during_rerun"] = st2
    if kern_g is not None:
        gpt2["kernel_only"] = kern_g

    # TERTIARY: o200k-scale / pattern-3 e2e (full mode only).
    o200k = None
    if not fast:
        note("e2e o200k")
        tok_o = create_by_encoder_name(
            "o200k_synth", allow_fetch=False, use_tpu=True
        )
        o200k = _e2e_block(_host_only(tok_o), docs, nbytes, cycles)
        o200k["note"] = "host-route only (secondary probe suppressed)"
        s3, st3 = _steady_only(tok_o, docs, nbytes, max(cycles - 2, 2))
        o200k["e2e_steady_MBps"] = max(o200k["e2e_steady_MBps"], s3)
        o200k["steal_pct_during_rerun"] = st3

    note("scan threads")
    scan_threads = scan_threads_bench(docs, cycles=3 if fast else 5)
    note("decode")
    decode = decode_bench(tok_c, docs, cycles=cycles)
    note("trim")
    trims = trim_bench(tok_c, docs, cycles=2 if fast else 3)
    note("trim prefix")
    trims_p = None
    if not fast:
        tok_c.encode_trim_prefix_batch(docs[:32], 64)
        bestp = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            tok_c.encode_trim_prefix_batch(docs, 64)
            bestp = min(bestp, time.perf_counter() - t0)
        trims_p = {
            "trim_prefix_MBps": round(nbytes / bestp / 1e6, 2),
            "budget": 64,
        }
    note("cold blend")
    blend = None if fast else corpus_cold_blend(docs)
    note("overlap")
    overlap = overlap_ab(gen_corpus(2.0 if fast else 4.0, seed=99))
    # The forced-device block runs in this process, after the other
    # blocks: a second JAX process could not open the card, whose
    # memory this one has reserved.
    note("device e2e forced")
    dev_e2e = {} if fast else device_e2e_forced()
    # The headline block re-measures LAST: hypervisor steal bursts on a
    # shared host would otherwise make a poisoned first window the
    # run's number.  Two independently-timed min-of-cycles passes, best
    # wins; each records its steal share.
    note("headline re-measure")
    steady2, steal2 = _steady_only(tok_c, docs, nbytes, cycles)
    cl100k["e2e_steady_MBps_rerun"] = steady2
    cl100k["steal_pct_during_rerun"] = steal2
    # Third independently-timed window: host-clock throughput drifts
    # between clean windows within one run, so a best-of-three spread
    # is the steady estimator (same min-of-cycles protocol per window).
    note("headline re-measure 2")
    steady3, steal3 = _steady_only(tok_c, docs, nbytes, cycles)
    cl100k["e2e_steady_MBps_rerun2"] = steady3
    cl100k["steal_pct_during_rerun2"] = steal3
    note("done")

    steady = max(cl100k["e2e_steady_MBps"], steady2, steady3)
    detail = {
        "corpus_bytes": nbytes,
        "corpus_docs": len(docs),
        "cl100k_synthetic": cl100k,
        "gpt2": gpt2,
        "o200k_synthetic": o200k,
        "scan_threads": scan_threads,
        "decode": decode,
        "trim_suffix": trims,
        "trim_prefix": trims_p,
        "corpus_cold_blend": blend,
        "overlap_ab": overlap,
        "device_e2e_forced": dev_e2e,
    }
    print(
        json.dumps(
            {
                "metric": "encode_throughput_e2e_cl100k_synth",
                "value": steady,
                "unit": "MB/s",
                "vs_baseline": round(steady / BASELINE_MBS, 2),
                "device": device,
            }
        )
    )
    print("# detail " + json.dumps(detail), file=sys.stderr)


if __name__ == "__main__":
    measure()
