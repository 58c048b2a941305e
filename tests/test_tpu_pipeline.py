"""TpuTokenizer bulk pipeline vs host engine — bit-identical outputs.

Runs on the CPU backend (conftest).  Every case asserts
``encode_batch(texts) == [host.encode(t) for t in texts]`` including
edge paths: empty texts, specials, oversized pieces (host-fallback +
overflow rows), repeated batches (dedup reuse), and adversarial vocabs
with pair-merge-unreachable tokens (force-host routing).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from conftest import has_vocab

from tokenizer_tpu.engine import TikTokenizer
from tokenizer_tpu.tpu import TpuTokenizer
from tokenizer_tpu.vocab import Vocabulary

pytestmark = pytest.mark.skipif(
    not has_vocab("gpt2"), reason="gpt2 rank file not available offline"
)


@pytest.fixture(scope="module")
def pair():
    from tokenizer_tpu import create_by_encoder_name

    tpu = create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=True)
    host = create_by_encoder_name("gpt2", allow_fetch=False)
    return tpu, host


def _assert_match(tpu, host, texts, allowed=None):
    got = tpu.encode_batch(texts, allowed_special=allowed)
    for text, ids in zip(texts, got):
        assert list(ids) == host.encode(text, allowed_special=allowed), repr(
            text
        )


def test_basic_batch(pair):
    tpu, host = pair
    _assert_match(
        tpu,
        host,
        [
            "Hello World",
            "",
            "x",
            "  spaces   and\ttabs\n\nnewlines ",
            "unicode ⭐ 💩 你好 é",
            "don't can't I'll they'd",
            "numbers 1 22 333 123456789",
        ],
    )


def test_specials_batch(pair):
    tpu, host = pair
    texts = [
        "<|endoftext|>",
        "a<|endoftext|>b",
        "<|endoftext|><|endoftext|>",
        "no specials here",
    ]
    _assert_match(tpu, host, texts, allowed=["<|endoftext|>"])
    # Disallowed → encoded as plain text, still identical.
    _assert_match(tpu, host, texts, allowed=None)


def test_oversized_piece_overflow_row(pair):
    tpu, host = pair
    texts = ["z" * 5000, "ok " + "9" * 300 + " tail", "z" * 5000]
    before = tpu.stats.host_fallback_pieces
    _assert_match(tpu, host, texts)
    assert tpu.stats.host_fallback_pieces > before
    # Round-trip through decode.
    ids = tpu.encode_batch(["z" * 5000])[0]
    assert tpu.decode(ids) == "z" * 5000


def test_dedup_reuse_across_calls(pair):
    tpu, host = pair
    u0 = tpu.stats.unique_pieces
    _assert_match(tpu, host, ["repeat me repeat me repeat me"])
    u1 = tpu.stats.unique_pieces
    _assert_match(tpu, host, ["repeat me repeat me repeat me"])
    # Second call adds no unique pieces.
    assert tpu.stats.unique_pieces == u1
    assert u1 > u0


def test_row_matrix_growth(pair):
    tpu, host = pair
    # Thousands of distinct pieces force _reserve_rows doubling.
    texts = [" ".join(f"tok{i}x{j}" for j in range(50)) for i in range(60)]
    _assert_match(tpu, host, texts)


def test_unreachable_token_force_host():
    # Adversarial vocab: "xyz" exists but cannot be formed by merges;
    # whole-piece parity requires the host-oracle route.
    enc = {bytes([b]): b for b in range(256)}
    enc[b"xyz"] = 256
    enc[b"ab"] = 257
    specials = {"<|eot|>": 999}
    tpu = TpuTokenizer(dict(enc), specials, r"[a-z]+|\s+|.")
    host = TikTokenizer(dict(enc), specials, r"[a-z]+|\s+|.")
    assert b"xyz" in tpu.table.unreachable_tokens
    texts = ["xyz", "ab xyz ab", "xyzxyz"]
    got = tpu.encode_batch(texts)
    for text, ids in zip(texts, got):
        assert list(ids) == host.encode(text), repr(text)
    # The whole-piece hit must yield the single token id.
    assert list(tpu.encode_batch(["xyz"])[0]) == [256]
    assert tpu.stats.host_fallback_pieces >= 1


def test_concurrent_intern_stress(pair):
    """Many distinct pieces across many segments: exercises the native
    context's multi-threaded scan with racing lock-free reads and
    mutex inserts (plus table/arena growth mid-batch)."""
    tpu, host = pair
    import random

    rng = random.Random(99)
    texts = []
    for d in range(64):
        words = [
            "w%dx%d" % (d, rng.randrange(4000)) for _ in range(400)
        ]
        texts.append(" ".join(words))
    got = tpu.encode_batch(texts)
    for text, ids in zip(texts, got):
        assert list(ids) == host.encode(text), text[:60]
    # Same batch again: fully interned, still identical.
    got2 = tpu.encode_batch(texts)
    for a, b in zip(got, got2):
        assert list(a) == list(b)


def test_batch_trims_and_decode_consistency(pair):
    tpu, host = pair
    text = "The quick brown fox ⭐ jumps 1234 over the lazy dog!"
    assert tpu.encode(text) == host.encode(text)
    assert tpu.encode_trim_suffix(text, 5) == host.encode_trim_suffix(text, 5)
    assert tpu.encode_trim_prefix(text, 5) == host.encode_trim_prefix(text, 5)
    ids = tpu.encode_batch([text])[0]
    assert tpu.decode(ids) == text
    assert tpu.decode_batch([ids]) == [text]


def test_encode_batch_stream_matches_encode_batch(pair, lib_rs_text):
    """The pipelined stream is bit-identical to per-batch encode_batch,
    including cross-batch dedup (a piece first seen in batch k reused in
    batch k+1)."""
    tok, _host = pair
    batches = [
        [lib_rs_text[:3000], "shared piece alpha beta"],
        ["shared piece alpha beta", lib_rs_text[3000:7000]],
        ["⭐ étoile 12345", lib_rs_text[:100]],
    ]
    got = list(tok.encode_batch_stream(iter(batches)))
    want = [tok.encode_batch(b) for b in batches]
    assert len(got) == len(want)
    for g_batch, w_batch in zip(got, want):
        for g, w in zip(g_batch, w_batch):
            assert list(g) == list(w)


def test_encode_batch_stream_empty(pair):
    tok, _ = pair
    assert list(tok.encode_batch_stream(iter([]))) == []


def test_single_string_encode_native_scanner_parity(pair, lib_rs_text):
    """TpuTokenizer.encode (native C++ scanner + host piece resolution)
    is bit-identical to the host engine, including specials and
    surrogate-free unicode."""
    tpu, host = pair
    cases = [
        ("", None),
        ("Hello World", None),
        (lib_rs_text, None),
        ("⭐ étoile  123  \t\n mixed   runs", None),
        ("Hello<|endoftext|>World", ["<|endoftext|>"]),
        ("<|endoftext|>" * 3, "all"),
        ("a<|endoftext|>b", None),  # special NOT allowed -> plain text
    ]
    for text, allowed in cases:
        assert tpu.encode(text, allowed) == host.encode(text, allowed), (
            text[:40],
            allowed,
        )
    # Cache warm path (second call hits the LRU).
    assert tpu.encode(lib_rs_text) == host.encode(lib_rs_text)


def test_long_cjk_pieces_through_device_buckets(pair):
    """Multi-hundred-byte no-whitespace pieces (CJK) route through the
    wide device buckets (<=512B) and beyond that the native heap merge,
    matching the host oracle exactly."""
    tpu, host = pair
    texts = [
        "".join(chr(0x4E00 + (i * 7) % 2000) for i in range(150)),   # ~450B
        "".join(chr(0x4E00 + (i * 13) % 2000) for i in range(400)),  # ~1.2KB
        "word " + "好" * 300 + " tail",
        "9" * 700,  # digit run (single piece under pattern 1)
    ]
    got = tpu.encode_batch(texts)
    for g, t in zip(got, texts):
        assert list(g) == host.encode(t)
    # decode round-trip
    for g, t in zip(got, texts):
        assert tpu.decode(g) == t


def test_wave_cache_overflow_falls_back_per_tile(gpt2_vocab, lib_rs_text):
    """When the wave-combo jit cache is full, dispatch falls back to
    per-tile calls with identical results."""
    from tokenizer_tpu.models.registry import get_encoding_spec
    from tokenizer_tpu.tpu import TpuTokenizer

    spec = get_encoding_spec("gpt2")
    tok = TpuTokenizer(gpt2_vocab, spec.special_tokens, spec.pattern, mesh=None)
    tok._ensure_device()
    tok._wave_fns = {("sentinel", i): None for i in range(16)}  # full
    (ids,) = tok.encode_batch([lib_rs_text[:2000]])
    host = TpuTokenizer(gpt2_vocab, spec.special_tokens, spec.pattern, mesh=None)
    (want,) = host.encode_batch([lib_rs_text[:2000]])
    assert list(ids) == list(want)


def test_small_wave_host_router(gpt2_vocab):
    """Single-device waves below the threshold resolve via the native
    C++ merge (no device dispatch), bit-identical to the device path."""
    import jax

    from tokenizer_tpu.engine import TikTokenizer
    from tokenizer_tpu.models.registry import get_encoding_spec
    from tokenizer_tpu.tpu import TpuTokenizer

    spec = get_encoding_spec("gpt2")
    tok = TpuTokenizer(gpt2_vocab, spec.special_tokens, spec.pattern, mesh=None)
    host = TikTokenizer(gpt2_vocab, spec.special_tokens, spec.pattern)
    texts = ["a tiny batch with few unique pieces ⭐", "9" * 700]
    got = tok.encode_batch(texts)
    for g, t in zip(got, texts):
        assert list(g) == host.encode(t)
    if tok._native is not None:
        assert tok.stats.host_wave_pieces > 0
        assert tok.stats.device_pieces == 0


def test_register_new_uids_unsorted_news(pair):
    """uid->row growth must use the MAX new uid, not the last one.

    tt_ctx_split_batch concatenates per-thread news lists, so the last
    element need not carry the largest uid; growing from news[-1] used
    to IndexError exactly when a batch crossed the map's power-of-two
    boundary with an out-of-order tail (regression for the fix in
    _register_new_uids).
    """
    from tokenizer_tpu import create_by_encoder_name

    tpu = create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=True)
    cap = len(tpu._uid_rows)
    # Seed uids [0, cap-2) so the next two interns straddle the boundary.
    base = [f" w{j}x" for j in range(cap - 2)]
    tpu.encode_batch(["".join(base)])
    assert len(tpu._uid_rows) == cap
    # Hand the registrar an unsorted news batch crossing the boundary:
    # max uid first, smaller uid last (the threaded-scan ordering).
    import numpy as np

    n = tpu._split_ctx.n_pieces
    buf = b" zz1x zz0x"
    news = (
        np.array([n + 1, n], np.int32),
        np.array([0, 5], np.int32),
        np.array([5, 10], np.int32),
    )
    wave = tpu._register_new_uids_arrays(news, buf)
    assert len(tpu._uid_rows) >= n + 2
    rows, starts, ends, wbuf, uids = wave
    # uid -> row publication is DEFERRED to wave resolution; the wave
    # carries the (rows, uids) pairing instead.
    assert int(tpu._uid_rows[n]) == -1 and int(tpu._uid_rows[n + 1]) == -1
    assert sorted(uids.tolist()) == [n, n + 1]
    assert wbuf is buf and list(starts) == [0, 5]
    # Resolution publishes them.
    tpu._finish_new_piece_rows(tpu._dispatch_wave(wave))
    assert set(rows.tolist()) == {
        int(tpu._uid_rows[n]), int(tpu._uid_rows[n + 1])
    }


def test_adaptive_wave_router_gates_on_probe(gpt2_vocab):
    """Big waves route to the host until the background channel probe
    completes (stall immunity), then to the device; output identical."""
    from tokenizer_tpu.engine import TikTokenizer
    from tokenizer_tpu.models.registry import get_encoding_spec
    from tokenizer_tpu.tpu import TpuTokenizer

    spec = get_encoding_spec("gpt2")
    tok = TpuTokenizer(gpt2_vocab, spec.special_tokens, spec.pattern, mesh=None)
    if tok._native is None:
        import pytest

        pytest.skip("native library unavailable")
    host = TikTokenizer(gpt2_vocab, spec.special_tokens, spec.pattern)
    # A wave big enough to clear the static host-wave floor: letter-only
    # pseudo-random words so pattern 1 yields one unique piece per word.
    import hashlib

    def word(i, j, salt):
        h = hashlib.blake2b(f"{i}.{j}.{salt}".encode(), digest_size=6).digest()
        return "".join(chr(97 + b % 26) for b in h)

    big = [" ".join(word(i, j, 0) + word(j, i, 3) for j in range(80)) for i in range(40)]

    tok._ensure_device()
    tok._dev_ready = False  # simulate a stalled channel probe
    # ...and pin the simulation: without this the first wave launches
    # the REAL probe thread, whose warm-compile-cache merge can finish
    # inside the 0.5 s grace window and flip _dev_ready back (flaky).
    tok._dev_probe_started = True
    tok._dev_event.set()
    got = tok.encode_batch(big)
    for g, t in zip(got, big):
        assert list(g) == host.encode(t)
    assert tok.stats.device_pieces == 0
    assert tok.stats.host_wave_pieces > 1024

    # Channel proves itself: the next big batch takes the device.
    tok._dev_ready = True
    tok._dev_pp = None
    big2 = [" ".join(word(i, j, 9) + word(j, i, 14) for j in range(80)) for i in range(40)]
    got2 = tok.encode_batch(big2)
    for g, t in zip(got2, big2):
        assert list(g) == host.encode(t)
    assert tok.stats.device_pieces > 0
    assert tok._dev_pp is not None  # EMA fed by the measured wave



def test_adaptive_router_explores_after_host_streak(gpt2_vocab):
    """With the device measured slower than the host, waves route host;
    after 32 host waves one exploration wave re-measures the device."""
    from tokenizer_tpu.models.registry import get_encoding_spec
    from tokenizer_tpu.tpu import TpuTokenizer

    spec = get_encoding_spec("gpt2")
    tok = TpuTokenizer(gpt2_vocab, spec.special_tokens, spec.pattern, mesh=None)
    if tok._native is None:
        import pytest

        pytest.skip("native library unavailable")
    tok._ensure_device()
    # Suppress the REAL channel probe: _route_wave_host would launch it
    # and its completion overwrites _dev_pp/_dev_ready concurrently —
    # the fixture values below must stay authoritative (this race was
    # an intermittent suite failure under heavy box contention).
    tok._dev_probe_started = True
    tok._dev_event.set()
    tok._dev_ready = True
    tok._dev_pp = 1.0  # device measured terrible
    tok._host_pp = 1e-6
    big = 2048  # above the static host-wave floor
    assert tok._route_wave_host(big) is True
    tok._host_waves_since_dev = 31
    assert tok._route_wave_host(big) is True
    tok._host_waves_since_dev = 32
    assert tok._route_wave_host(big) is False  # exploration wave
    # A healthy device wins outright.
    tok._dev_pp = 1e-9
    tok._host_waves_since_dev = 0
    assert tok._route_wave_host(big) is False
    # Small waves always take the host.
    assert tok._route_wave_host(8) is True


def test_bounded_dedup_reset(gpt2_vocab):
    """With a tiny max_unique_rows, the dedup state flushes at safe
    points, output stays bit-identical, and streams never flush while a
    batch is in flight."""
    import hashlib

    from tokenizer_tpu.engine import TikTokenizer
    from tokenizer_tpu.models.registry import get_encoding_spec
    from tokenizer_tpu.tpu import TpuTokenizer

    spec = get_encoding_spec("gpt2")
    tok = TpuTokenizer(
        gpt2_vocab, spec.special_tokens, spec.pattern, max_unique_rows=500
    )
    host = TikTokenizer(gpt2_vocab, spec.special_tokens, spec.pattern)

    def word(i, j):
        h = hashlib.blake2b(f"{i}:{j}".encode(), digest_size=5).digest()
        return "".join(chr(97 + b % 26) for b in h)

    batches = [
        [" ".join(word(i, j) for j in range(120)) for i in range(6)]
        for _ in range(4)
    ]
    # encode_batch path: resets between calls.
    for texts in batches:
        got = tok.encode_batch(texts)
        for g, t in zip(got, texts):
            assert list(g) == host.encode(t)
    assert tok.stats.dedup_resets >= 1
    assert tok._n_rows <= 500 + 1200  # bounded: at most one batch over

    # stream path: resets only between chunks, output identical.
    resets_before = tok.stats.dedup_resets
    flat = [
        ids for b in tok.encode_batch_stream(iter(batches)) for ids in b
    ]
    want = [host.encode(t) for texts in batches for t in texts]
    for g, w in zip(flat, want):
        assert list(g) == w
    assert tok.stats.dedup_resets > resets_before

    # trims survive resets too.
    r = tok.encode_trim_suffix_batch(batches[0], 7)
    for t, res in zip(batches[0], r):
        assert (res.token_ids, res.text) == tuple(host.encode_trim_suffix(t, 7))


@pytest.mark.parametrize("mesh,fuse", [(None, True), ("auto", True), (None, False)])
def test_generational_dedup_no_sawtooth(gpt2_vocab, mesh, fuse):
    """Past max_unique_rows the dedup must degrade
    SMOOTHLY — hot pieces resurrect from the frozen old generation by
    row copy (dedup_gen_copies), never re-merging a fully cold chunk —
    while total live rows stay bounded.  mesh=None exercises the fused
    scan-thread resurrection; mesh="auto" (8-device CPU mesh) the
    unfused news-path resurrection; fuse=False forces the
    _resurrect_old_gen lookup_spans route."""
    import hashlib

    from tokenizer_tpu.engine import TikTokenizer
    from tokenizer_tpu.models.registry import get_encoding_spec
    from tokenizer_tpu.tpu import TpuTokenizer

    spec = get_encoding_spec("gpt2")
    tok = TpuTokenizer(
        gpt2_vocab,
        spec.special_tokens,
        spec.pattern,
        mesh=mesh,
        max_unique_rows=1600,  # per-generation bound: 800 rows
    )
    if not fuse:
        # Force the UNFUSED news path so _resurrect_old_gen (the python
        # lookup_spans route) is exercised, not just the scan-thread
        # C++ resurrection.
        tok._should_fuse = lambda nbytes: False
    host = TikTokenizer(gpt2_vocab, spec.special_tokens, spec.pattern)

    def word(tag, j):
        h = hashlib.blake2b(f"{tag}:{j}".encode(), digest_size=6).digest()
        return "".join(chr(97 + b % 26) for b in h)

    hot = [word("hot", j) for j in range(300)]  # in every chunk
    merges_per_chunk = []
    copies_per_chunk = []
    for ci in range(8):
        fresh = [word(f"c{ci}", j) for j in range(250)]
        text = " ".join(hot + fresh)
        before = tok.stats.as_dict()
        got = tok.encode_batch([text])[0]
        assert list(got) == host.encode(text), f"chunk {ci} parity"
        d = {k: tok.stats.as_dict()[k] - before[k] for k in before}
        copies_per_chunk.append(d["dedup_gen_copies"])
        merges_per_chunk.append(d["unique_pieces"] - d["dedup_gen_copies"])
    assert tok.stats.dedup_resets >= 2, "stream never rotated"
    assert tok.stats.dedup_gen_copies > 0, "old generation never probed"
    # Bounded: current gen stays around the per-gen bound (one chunk of
    # overshoot allowed — rotation happens between batches).
    assert tok._n_rows <= 800 + 700
    # NO SAWTOOTH: a post-rotation chunk re-MERGES only its fresh
    # pieces; the hot vocabulary comes back as row copies.  A cold
    # sawtooth would re-merge hot+fresh (>500 merges).
    post_rotation = [
        m for m, c in zip(merges_per_chunk, copies_per_chunk) if c > 0
    ]
    assert post_rotation, "no chunk exercised resurrection"
    for m in post_rotation:
        assert m <= 400, f"cold-chunk sawtooth: {m} re-merges in one chunk"
    # Hot pieces specifically resurrected (not merely some stragglers).
    assert max(copies_per_chunk) >= 200


def test_subset_allowed_special_bulk_paths():
    """allowed_special as a SUBSET collection (not None/'all') through
    the bulk device paths: only listed specials stay atomic; the rest
    tokenize as plain text (findNextSpecialToken skip semantics,
    tikTokenizer.ts:118-140).  p50k_edit carries 4 specials so a
    2-of-4 subset is meaningful."""
    if not has_vocab("gpt2"):
        pytest.skip("gpt2 vocab unavailable")
    from tokenizer_tpu import create_by_encoder_name

    tpu = create_by_encoder_name("p50k_edit", allow_fetch=False, use_tpu=True)
    host = create_by_encoder_name("p50k_edit", allow_fetch=False)
    sub = ["<|fim_prefix|>", "<|fim_suffix|>"]
    docs = [
        "a<|fim_prefix|>b<|fim_middle|>c<|fim_suffix|>d<|endoftext|>e",
        "<|fim_prefix|><|fim_prefix|>",
        "x<|endoftext|>",
    ]
    want = [host.encode(t, allowed_special=sub) for t in docs]
    got = tpu.encode_batch(docs, allowed_special=sub)
    for g, w, t in zip(got, want, docs):
        assert list(g) == w, t
    for t, r in zip(docs, tpu.encode_trim_suffix_batch(docs, 3, allowed_special=sub)):
        assert (r.token_ids, r.text) == tuple(
            host.encode_trim_suffix(t, 3, allowed_special=sub)
        ), t
    for t, r in zip(docs, tpu.encode_trim_prefix_batch(docs, 3, allowed_special=sub)):
        assert (r.token_ids, r.text) == tuple(
            host.encode_trim_prefix(t, 3, allowed_special=sub)
        ), t


def test_megapiece_single_token_run(pair):
    """A 1 MB SINGLE piece (one regex match, unsplittable by the
    subsegment scheme) must merge natively without the reference's
    quadratic-loop cost and round-trip exactly.  The host oracle's
    pure-python loop is O(n^2) here (as is the reference,
    BytePairEncoder.cs:13-76), so parity is asserted at 4 KB and the
    megapiece is held to round-trip + determinism instead."""
    tpu, host = pair
    p4 = "a" * 4096
    assert tpu.encode(p4) == host.encode(p4)
    big = "a" * (1 << 20)
    ids = tpu.encode_batch([big])[0]
    assert tpu.decode_batch([np.asarray(ids)])[0] == big
    again = tpu.encode_batch([big])[0]
    assert list(ids) == list(again)


def test_overlapping_custom_specials_insertion_order():
    """The specials matcher is leftmost-ALTERNATIVE in insertion order
    (JS RegExp '|', tikTokenizer.ts:100-105), NOT longest-match: with
    {'<|a|>', '<|a|>b'} registered in that order, '<|a|>b' encodes as
    [id('<|a|>'), 'b'] — and the REVERSED insertion order flips the
    result.  The native byte scanner must reproduce both orders."""
    if not has_vocab("gpt2"):
        pytest.skip("gpt2 vocab unavailable")
    from tokenizer_tpu import create_by_encoder_name

    docs = ["<|a|>b", "x<|a|>bz", "<|a|><|a|>b", "pre<|a|>"]
    for extras in (
        {"<|a|>": 50258, "<|a|>b": 50259},
        {"<|a|>b": 50259, "<|a|>": 50258},
    ):
        host = create_by_encoder_name(
            "gpt2", allow_fetch=False, extra_special_tokens=extras
        )
        tpu = create_by_encoder_name(
            "gpt2", allow_fetch=False, use_tpu=True, extra_special_tokens=extras
        )
        for t in docs:
            w = host.encode(t, allowed_special="all")
            assert tpu.encode(t, allowed_special="all") == w, (extras, t)
            assert (
                list(tpu.encode_batch([t], allowed_special="all")[0]) == w
            ), (extras, t)
    # Sanity: the two orders genuinely differ on the overlap.
    a = create_by_encoder_name(
        "gpt2", allow_fetch=False,
        extra_special_tokens={"<|a|>": 50258, "<|a|>b": 50259},
    ).encode("<|a|>b", allowed_special="all")
    b = create_by_encoder_name(
        "gpt2", allow_fetch=False,
        extra_special_tokens={"<|a|>b": 50259, "<|a|>": 50258},
    ).encode("<|a|>b", allowed_special="all")
    assert a == [50258, 65] and b == [50259]


def test_bulk_apis_reject_bare_string(pair):
    """A bare string passed where a sequence of texts is expected would
    silently char-iterate into one-char results; every bulk entry
    rejects it with a TypeError instead."""
    tpu, _ = pair
    with pytest.raises(TypeError, match="sequence of texts"):
        tpu.encode_batch("hello")
    with pytest.raises(TypeError, match="sequence of texts"):
        tpu.encode_trim_suffix_batch("hello", 3)
    with pytest.raises(TypeError, match="sequence of texts"):
        tpu.encode_trim_prefix_batch("hello", 3)
    with pytest.raises(TypeError, match="sequence of texts"):
        list(tpu.encode_batch_stream(iter(["hello"])))


def test_concurrent_public_api_threads():
    """The PUBLIC entries are callable from many threads (the C#
    reference's ITokenizer is; LRUCache.cs:14): 8 threads hammer
    encode_batch / bulk trims / decode_batch on ONE tokenizer with a
    small dedup bound (rotation pressure) — every result must equal
    the host oracle."""
    if not has_vocab("gpt2"):
        pytest.skip("gpt2 vocab unavailable")
    from concurrent.futures import ThreadPoolExecutor

    from tokenizer_tpu import create_by_encoder_name

    tpu = create_by_encoder_name(
        "gpt2", allow_fetch=False, use_tpu=True,
        max_unique_rows=600, mesh=None,
    )
    host = create_by_encoder_name("gpt2", allow_fetch=False)
    import random

    def work(seed):
        rng = random.Random(seed)
        for _ in range(6):
            docs = [
                " ".join(
                    "t%d_%d" % (seed, rng.randrange(3000))
                    for _ in range(rng.randint(5, 60))
                )
                for _ in range(rng.randint(1, 12))
            ]
            got = tpu.encode_batch(docs)
            for t, ids in zip(docs, got):
                assert list(ids) == host.encode(t), t[:50]
            assert tpu.decode_batch(got) == docs
            r = tpu.encode_trim_suffix_batch(docs, 5)
            for t, res in zip(docs, r):
                want = host.encode_trim_suffix(t, 5)
                assert (res.token_ids, res.text) == tuple(want)
        return True

    with ThreadPoolExecutor(max_workers=8) as ex:
        assert all(ex.map(work, range(8)))


def test_stream_interleaved_with_bulk_calls():
    """Other bulk calls BETWEEN stream yields (same or another thread)
    must not rotate the dedup out from under the stream's deferred
    chunk — the _stream_inflight hold defers rotation to the stream's
    own safe points.  Small max_unique_rows forces the pressure."""
    if not has_vocab("gpt2"):
        pytest.skip("gpt2 vocab unavailable")
    from tokenizer_tpu import create_by_encoder_name

    tpu = create_by_encoder_name(
        "gpt2", allow_fetch=False, use_tpu=True,
        max_unique_rows=600, mesh=None,
    )
    host = create_by_encoder_name("gpt2", allow_fetch=False)
    batches = [
        ["s%d_%d unique piece soup %d" % (b, i, i * 7) for i in range(40)]
        for b in range(6)
    ]
    side_docs = ["side %d words %d here" % (k, k * 13) for k in range(300)]
    out = []
    k = 0
    for got in tpu.encode_batch_stream(iter(batches)):
        out.append(got)
        # Interleave a rotation-pressure bulk call between yields.
        side = side_docs[k * 50 : (k + 1) * 50]
        sids = tpu.encode_batch(side)
        for t, ids in zip(side, sids):
            assert list(ids) == host.encode(t)
        k += 1
    assert len(out) == len(batches)
    for batch, got in zip(batches, out):
        for t, ids in zip(batch, got):
            assert list(ids) == host.encode(t), t
    assert tpu._stream_inflight == 0


def test_stream_abandoned_with_deferred_chunk():
    """Closing a stream generator early (consumer breaks) with a chunk
    in flight must finish the wave, release the rotation hold, and
    leave the tokenizer fully usable."""
    if not has_vocab("gpt2"):
        pytest.skip("gpt2 vocab unavailable")
    from tokenizer_tpu import create_by_encoder_name

    tpu = create_by_encoder_name(
        "gpt2", allow_fetch=False, use_tpu=True,
        max_unique_rows=600, mesh=None,
    )
    host = create_by_encoder_name("gpt2", allow_fetch=False)
    batches = [
        ["ab%d cd%d" % (b * 100 + i, i) for i in range(30)]
        for b in range(5)
    ]
    gen = tpu.encode_batch_stream(iter(batches))
    first = next(gen)
    for t, ids in zip(batches[0], first):
        assert list(ids) == host.encode(t)
    gen.close()  # abandon with batch 1 potentially deferred
    assert tpu._stream_inflight == 0
    # Tokenizer still healthy afterward, rotation unblocked.
    docs = ["post abandon %d" % i for i in range(40)]
    got = tpu.encode_batch(docs)
    for t, ids in zip(docs, got):
        assert list(ids) == host.encode(t)


def test_decode_batch_unknown_ids_and_empty(pair):
    """gather_bytes_batch parity: unknown ids silently skipped
    (TikTokenizer.cs:591-599), empty texts keep their slots, U+FFFD
    replacement never crosses text boundaries."""
    tpu, host = pair
    batches = [
        list(range(200)),  # bulk path
        [],  # empty text
        [10, -5, 99999999, 20] * 80,  # unknowns interleaved, bulk
        host.encode("étoile ⭐ 你好") * 40,
    ]
    got = tpu.decode_batch(batches)
    want = [host.decode(ids) for ids in batches]
    assert got == want
    # Single bulk decode (>=64 ids) takes the native gather too.
    big = [3, 4, 5, -1, 2**31 - 1] * 30
    assert tpu.decode(big) == host.decode(big)


def test_trim_vec_mixed_overflow_rows(pair):
    """Vectorized bulk-trim bookkeeping with overflow-pool rows inside
    the budget windows (a CJK megapiece merges to > row width): the
    batched gather must stay exact, suffix and prefix, both modes."""
    tpu, host = pair
    docs = [
        "plain words " * 40,
        "mid " + "好" * 200 + " tail words " * 30,  # overflow row early
        "lead words " * 30 + "好" * 200,  # overflow row at the end
        "",
        "short",
    ]
    for t in docs:
        host.encode(t)  # warm host LRU (trim text is cache-dependent)
    for budget in (3, 17, 64):
        for mode in ("ts", "cs"):
            got = tpu.encode_trim_suffix_batch(docs, budget, mode=mode)
            for t, r in zip(docs, got):
                want = host.encode_trim_suffix(t, budget, mode=mode)
                assert (r.token_ids, r.text) == tuple(want), (t[:30], budget, mode)
        gotp = tpu.encode_trim_prefix_batch(docs, budget)
        for t, r in zip(docs, gotp):
            want = host.encode_trim_prefix(t, budget)
            assert (r.token_ids, r.text) == tuple(want), (t[:30], budget)


def test_trim_prefix_vec_overshoot_batched(pair):
    """Long docs at small budgets ALWAYS take the reference's naive
    overshoot fallback (tikTokenizer.ts:454-462) — now batched through
    one decode_batch; parity with the host loop."""
    tpu, host = pair
    docs = ["word%d " % i + "filler words here " * 50 for i in range(20)]
    for t in docs:
        host.encode(t)
    got = tpu.encode_trim_prefix_batch(docs, 5)
    for t, r in zip(docs, got):
        want = host.encode_trim_prefix(t, 5)
        assert (r.token_ids, r.text) == tuple(want)


def test_data_mesh_raises_on_too_few_devices():
    """data_mesh(n) must fail loudly instead of silently building a
    smaller mesh (a 'sharded' fuzz campaign once ran single-device)."""
    import jax

    from tokenizer_tpu.parallel.mesh import data_mesh

    n = len(jax.devices())
    with pytest.raises(ValueError, match="device"):
        data_mesh(n + 1)
