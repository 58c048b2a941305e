"""Long-horizon randomized differential campaign: device pipeline vs host oracle.

Runs unbounded random (encoding, threads, subseg, dedup-bound, route,
specials, batch, budgets, API) configurations and asserts bit parity
between every bulk device-pipeline API and the reference-parity host
engine loop.  This is the heavy-artillery complement to the pytest
fuzz suites: pytest covers each feature's edge cases cheaply on every
run; the campaign explores the CROSS-PRODUCT of runtime states for
hours at a time (generational dedup rotation mid-workload, forced
device routing, thread/subseg interactions, degenerate budgets, ...).

Both round-4 state bugs were found by this harness, not by the unit
suites:
  * stale ``_n_rows`` high-water commit when the no-fuse emit path ran
    under a device-routed wave (heap corruption after row recycling);
  * dedup rotation triggered by a degenerate-budget fallback MID-LOOP
    in the batch trims, orphaning later texts' window row indices
    (iter 24,823 of seed 31337 — now a deterministic regression test,
    tests/test_bulk_trims.py::test_trim_batch_degenerate_budget_before_rotation).

Usage (CPU, any machine):

    JAX_PLATFORMS=cpu python tools/fuzz_campaign.py <mode> <seed> <seconds>

where mode is ``encode`` (encode_batch / stream / single / decode
round-trip) or ``trim`` (bulk suffix+prefix trims vs the host loop,
every budget 0-30, both suffix modes).  Exit 0 = every iteration
matched; exit 1 prints the failing configuration (the RNG draws are a
pure function of the seed and iteration index, so any report replays
deterministically by fast-forwarding the draws).
"""

from __future__ import annotations

import os
import random
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Mesh mode shards every wave over an 8-device VIRTUAL CPU mesh — the
# flags must be set before jax first imports (lazily, on device use);
# data_mesh raises if fewer devices show up.
if len(sys.argv) > 1 and sys.argv[1] == "mesh":
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 "
        + os.environ.get("XLA_FLAGS", "")
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"  # mesh mode is ALWAYS virtual

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tokenizer_tpu.engine import TikTokenizer
from tokenizer_tpu.models.registry import get_encoding_spec
from tokenizer_tpu.tpu import TpuTokenizer
from tokenizer_tpu.vocab import Vocabulary

# Atom soup tuned to cross every scanner class boundary: ASCII words,
# digit runs, CJK, combining-free Latin-1, astral pairs, contractions
# (upper/lower), specials, long single-piece runs, whitespace shapes.
ATOMS = [
    "abc", "QRS", "xyz ", "0", "12", "345 ", "你好", "世界", "こん",
    "é", "ß", "💩", "⭐", "𝄞", "'ll", "'VE", "'s", "!", "@#$", " ",
    "\t", "\n", "\r\n", "/", "<|endoftext|>", "a" * 40, "好" * 30,
    " " * 6, "9" * 12, "\ud800", "a\udfff",
]

_VOCABS: dict = {}


def get(enc: str):
    if enc not in _VOCABS:
        v = Vocabulary.for_encoding(enc, allow_fetch=False)
        s = get_encoding_spec(enc)
        _VOCABS[enc] = (v, s, TikTokenizer(v, s.special_tokens, s.pattern))
    return _VOCABS[enc]


def make_tok(rng: random.Random, v, spec) -> TpuTokenizer:
    """Random runtime configuration, including FORCED device routing
    (private-attribute override: the probe is bypassed so the wave
    router exercises the device path deterministically on CPU)."""
    os.environ["TOKENIZER_TPU_THREADS"] = str(rng.choice([1, 2, 8]))
    os.environ["TOKENIZER_TPU_SUBSEG_BYTES"] = str(
        rng.choice([4096, 524288])
    )
    tok = TpuTokenizer(
        v,
        spec.special_tokens,
        spec.pattern,
        mesh=None,
        max_unique_rows=rng.choice([600, 1 << 20]),
    )
    if rng.random() < 0.4:
        tok._ensure_device()
        tok._dev_ready = True
        tok._dev_probe_started = True
        tok._dev_event.set()
        tok._dev_pp = 1e-12
        tok._host_pp = 1.0
        tok._news_per_byte = 1.0
    else:
        tok._dev_probe_started = True
        tok._dev_event.set()
    return tok


def iter_encode(rng: random.Random) -> None:
    enc = rng.choice(["gpt2", "cl100k_synth", "o200k_synth"])
    v, spec, host = get(enc)
    tok = make_tok(rng, v, spec)
    allowed = rng.choice([None, "all"])
    docs = [
        "".join(rng.choice(ATOMS) for _ in range(rng.randint(0, 80)))
        for _ in range(rng.randint(1, 60))
    ]
    want = [host.encode(t, allowed_special=allowed) for t in docs]
    api = rng.choice(["batch", "stream", "single"])
    if api == "batch":
        got = tok.encode_batch(docs, allowed_special=allowed)
        for g, w, t in zip(got, want, docs):
            assert list(g) == w, ("batch", t)
        dec = tok.decode_batch(got)
        for d_, w in zip(dec, want):
            assert d_ == host.decode(w), "decode"
    elif api == "stream":
        k = rng.randint(1, max(len(docs) // 2, 1))
        batches = [docs[i : i + k] for i in range(0, len(docs), k)]
        flat = [
            ids
            for b in tok.encode_batch_stream(
                iter(batches), allowed_special=allowed
            )
            for ids in b
        ]
        for g, w in zip(flat, want):
            assert list(g) == w, "stream"
    else:
        for t in docs[:10]:
            assert tok.encode(t, allowed_special=allowed) == host.encode(
                t, allowed_special=allowed
            ), ("single", t)


def iter_trim(rng: random.Random) -> None:
    enc = rng.choice(["gpt2", "cl100k_synth", "o200k_synth"])
    v, spec, host = get(enc)
    tok = make_tok(rng, v, spec)
    allowed = rng.choice([None, "all"])
    docs = [
        "".join(rng.choice(ATOMS) for _ in range(rng.randint(0, 80)))
        for _ in range(rng.randint(1, 40))
    ]
    budgets = [rng.randint(0, 30) for _ in docs]
    mode = rng.choice(["ts", "cs"])
    # Warm BOTH caches first: the reference's trimmed TEXT is LRU-
    # cache-state-dependent (docs/parity.md "Known divergences");
    # warm-cache behavior is the deterministic comparison target.
    for t in docs:
        host.encode(t, allowed_special=allowed)
        tok.encode_trim_suffix(t, 1 << 30, allowed_special=allowed)
    ts = tok.encode_trim_suffix_batch(
        docs, budgets, allowed_special=allowed, mode=mode
    )
    tp = tok.encode_trim_prefix_batch(docs, budgets, allowed_special=allowed)
    for t, b, rs, rp in zip(docs, budgets, ts, tp):
        es = host.encode_trim_suffix(t, b, allowed_special=allowed, mode=mode)
        ep = host.encode_trim_prefix(t, b, allowed_special=allowed)
        assert (rs.token_ids, rs.text) == tuple(es), ("suffix", t, b, mode)
        assert (rp.token_ids, rp.text) == tuple(ep), ("prefix", t, b)


def iter_threads(rng: random.Random) -> None:
    """Concurrency iteration: ONE shared tokenizer, several threads
    each running a random API mix (the public entries are thread-safe,
    like the reference's ITokenizer) — every thread's results must
    equal the host oracle.  Seeded per-thread RNGs keep each thread's
    draw sequence deterministic regardless of interleaving."""
    from concurrent.futures import ThreadPoolExecutor

    enc = rng.choice(["gpt2", "cl100k_synth", "o200k_synth"])
    v, spec, host = get(enc)
    tok = make_tok(rng, v, spec)
    seeds = [rng.randrange(1 << 30) for _ in range(4)]

    def work(seed):
        r = random.Random(seed)
        for _ in range(3):
            docs = [
                "".join(r.choice(ATOMS) for _ in range(r.randint(0, 40)))
                for _ in range(r.randint(1, 12))
            ]
            api = r.choice(["batch", "trims", "stream"])
            if api == "batch":
                got = tok.encode_batch(docs)
                for g, t in zip(got, docs):
                    assert list(g) == host.encode(t), ("batch", t)
                assert tok.decode_batch(got) == [
                    host.decode(host.encode(t)) for t in docs
                ]
            elif api == "stream":
                flat = [
                    ids
                    for b in tok.encode_batch_stream(iter([docs]))
                    for ids in b
                ]
                for g, t in zip(flat, docs):
                    assert list(g) == host.encode(t), ("stream", t)
            else:
                b = r.randint(1, 30)
                for t in docs:
                    # Warm the host LRU: its trimmed TEXT is cache-
                    # state-dependent (docs/parity.md); the bulk path
                    # implements the deterministic warm-cache behavior.
                    host.encode(t)
                for t, res in zip(docs, tok.encode_trim_suffix_batch(docs, b)):
                    want = host.encode_trim_suffix(t, b)
                    assert (res.token_ids, res.text) == tuple(want), (
                        "trim", t, b,
                    )
        return True

    with ThreadPoolExecutor(max_workers=4) as ex:
        assert all(ex.map(work, seeds))


_MESH_TOKS: dict = {}


def _mesh_tok(rng: random.Random, enc: str) -> TpuTokenizer:
    """Process-cached 8-device-mesh tokenizer (jit fns are per-instance,
    so recreating one per iteration would re-trace the sharded merge
    every time).  Iterations randomly drop the dedup state instead —
    together with a small ``max_unique_rows`` instance this covers cold
    packs, generational rotation under a mesh, and warm wave reuse."""
    key = (enc, rng.random() < 0.3)  # (encoding, small-rows instance)
    tok = _MESH_TOKS.get(key)
    if tok is None:
        from tokenizer_tpu.parallel.mesh import data_mesh

        v, spec, _host = get(enc)
        tok = TpuTokenizer(
            v,
            spec.special_tokens,
            spec.pattern,
            mesh=data_mesh(8),
            max_unique_rows=600 if key[1] else 1 << 20,
        )
        _MESH_TOKS[key] = tok
    if rng.random() < 0.5:
        tok._reset_dedup_full()
    return tok


def iter_mesh(rng: random.Random) -> None:
    """The mesh path under the randomized campaign.  Every wave here runs the shard_map merge over the
    8-device virtual mesh (mesh tokenizers route no waves to the host
    router); encode_batch / stream / bulk trims mix, differential
    against the host oracle."""
    os.environ["TOKENIZER_TPU_THREADS"] = str(rng.choice([1, 2, 8]))
    os.environ["TOKENIZER_TPU_SUBSEG_BYTES"] = str(
        rng.choice([4096, 524288])
    )
    enc = rng.choice(["gpt2", "cl100k_synth", "o200k_synth"])
    v, spec, host = get(enc)
    tok = _mesh_tok(rng, enc)
    allowed = rng.choice([None, "all"])
    docs = [
        "".join(rng.choice(ATOMS) for _ in range(rng.randint(0, 60)))
        for _ in range(rng.randint(1, 40))
    ]
    api = rng.choice(["batch", "stream", "trims"])
    if api == "batch":
        got = tok.encode_batch(docs, allowed_special=allowed)
        for g, t in zip(got, docs):
            assert list(g) == host.encode(t, allowed_special=allowed), (
                "mesh-batch", t,
            )
    elif api == "stream":
        k = rng.randint(1, max(len(docs) // 2, 1))
        batches = [docs[i : i + k] for i in range(0, len(docs), k)]
        flat = [
            ids
            for b in tok.encode_batch_stream(
                iter(batches), allowed_special=allowed
            )
            for ids in b
        ]
        for g, t in zip(flat, docs):
            assert list(g) == host.encode(t, allowed_special=allowed), (
                "mesh-stream", t,
            )
    else:
        b = rng.randint(1, 30)
        for t in docs:
            host.encode(t, allowed_special=allowed)  # warm host LRU
        ts = tok.encode_trim_suffix_batch(docs, b, allowed_special=allowed)
        tp = tok.encode_trim_prefix_batch(docs, b, allowed_special=allowed)
        for t, rs, rp in zip(docs, ts, tp):
            es = host.encode_trim_suffix(t, b, allowed_special=allowed)
            ep = host.encode_trim_prefix(t, b, allowed_special=allowed)
            assert (rs.token_ids, rs.text) == tuple(es), ("mesh-ts", t, b)
            assert (rp.token_ids, rp.text) == tuple(ep), ("mesh-tp", t, b)


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "encode"
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 7
    budget_s = float(sys.argv[3]) if len(sys.argv) > 3 else 1500.0
    step = {
        "encode": iter_encode,
        "trim": iter_trim,
        "threads": iter_threads,
        "mesh": iter_mesh,
    }[mode]
    rng = random.Random(seed)
    t0 = time.time()
    it = 0
    while time.time() - t0 < budget_s:
        it += 1
        try:
            step(rng)
        except AssertionError as e:
            print(
                f"MISMATCH at iter {it} seed {seed} mode {mode}:",
                repr(e.args[0])[:300],
            )
            return 1
        if it % 200 == 0:
            print(f"iter {it} ok ({time.time() - t0:.0f}s)", flush=True)
    print(
        f"CAMPAIGN PASS [{mode} seed={seed}]: {it} iterations,"
        f" {time.time() - t0:.0f}s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
