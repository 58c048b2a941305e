"""Bulk trim APIs vs the host engine loop — bit parity.

encode_trim_suffix_batch / encode_trim_prefix_batch reuse the device
pipeline's split/dedup rows and do only budget bookkeeping per text;
every (text, budget, mode, specials) cell must equal the reference-
parity host loop exactly (ids AND surviving text).
"""

from __future__ import annotations

import pytest

from conftest import require_vocab

TEXTS = [
    "",
    "!",
    "Hello World, this is a somewhat longer sentence for trimming.",
    "don't CAN'T it's I'll we've",
    "numbers 1 22 333 4444 55555 123456789",
    "  leading spaces   and   runs  ",
    "line\nbreaks\r\nand\rreturns \n \n mixed \n\n\n",
    "unicode ⭐ étoile Straße ñandú",
    "CJK 你好世界 こんにちは 안녕하세요 with tails",
    "emoji 💩 👍🏽 astral pairs 𝄞 music",
    "a" * 300,
    "x<|endoftext|>y<|endoftext|>z tail",
    "<|endoftext|>lead",
]

BUDGETS = [0, 1, 2, 3, 5, 8, 13, 40, 10_000]


@pytest.fixture(scope="module")
def tpu_tok():
    require_vocab("gpt2")
    from tokenizer_tpu import create_by_encoder_name

    return create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=True)


@pytest.fixture(scope="module")
def host_tok():
    require_vocab("gpt2")
    from tokenizer_tpu import create_by_encoder_name

    return create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=False)


@pytest.mark.parametrize("allowed", [None, "all"])
@pytest.mark.parametrize("mode", ["ts", "cs"])
def test_trim_suffix_batch_parity(tpu_tok, host_tok, allowed, mode):
    for budget in BUDGETS:
        got = tpu_tok.encode_trim_suffix_batch(
            TEXTS, budget, allowed_special=allowed, mode=mode
        )
        for text, res in zip(TEXTS, got):
            expect = host_tok.encode_trim_suffix(
                text, budget, allowed_special=allowed, mode=mode
            )
            assert res.token_ids == expect.token_ids, (text, budget, mode)
            assert res.text == expect.text, (text, budget, mode)


@pytest.mark.parametrize("allowed", [None, "all"])
def test_trim_prefix_batch_parity(tpu_tok, host_tok, allowed):
    for budget in BUDGETS:
        got = tpu_tok.encode_trim_prefix_batch(
            TEXTS, budget, allowed_special=allowed
        )
        for text, res in zip(TEXTS, got):
            expect = host_tok.encode_trim_prefix(
                text, budget, allowed_special=allowed
            )
            assert res.token_ids == expect.token_ids, (text, budget)
            assert res.text == expect.text, (text, budget)


def test_per_text_budgets(tpu_tok, host_tok):
    budgets = list(range(1, len(TEXTS) + 1))
    got = tpu_tok.encode_trim_suffix_batch(TEXTS, budgets)
    for text, b, res in zip(TEXTS, budgets, got):
        expect = host_tok.encode_trim_suffix(text, b)
        assert (res.token_ids, res.text) == tuple(expect), (text, b)


def test_trim_batch_on_cl100k_synth():
    require_vocab("cl100k_synth")
    from tokenizer_tpu import create_by_encoder_name

    tpu = create_by_encoder_name("cl100k_synth", allow_fetch=False, use_tpu=True)
    host = create_by_encoder_name(
        "cl100k_synth", allow_fetch=False, use_tpu=False
    )
    for budget in (1, 4, 9, 50):
        got = tpu.encode_trim_suffix_batch(TEXTS, budget, allowed_special="all")
        for text, res in zip(TEXTS, got):
            expect = host.encode_trim_suffix(
                text, budget, allowed_special="all"
            )
            assert (res.token_ids, res.text) == tuple(expect), (text, budget)
        gotp = tpu.encode_trim_prefix_batch(TEXTS, budget, allowed_special="all")
        for text, res in zip(TEXTS, gotp):
            expect = host.encode_trim_prefix(text, budget, allowed_special="all")
            assert (res.token_ids, res.text) == tuple(expect), (text, budget)


def test_fuzz_trim_parity(tpu_tok, host_tok):
    import random

    rng = random.Random(77)
    alphabet = (
        "abc ABC 123 \n\r\t ⭐你好 é 💩 '! .,"
        "<|endoftext|>"
    )
    for _ in range(120):
        text = "".join(
            rng.choice(alphabet) for _ in range(rng.randint(0, 50))
        )
        budget = rng.randint(0, 25)
        mode = rng.choice(["ts", "cs"])
        allowed = rng.choice([None, "all"])
        got = tpu_tok.encode_trim_suffix_batch(
            [text], budget, allowed_special=allowed, mode=mode
        )[0]
        expect = host_tok.encode_trim_suffix(
            text, budget, allowed_special=allowed, mode=mode
        )
        assert (got.token_ids, got.text) == tuple(expect), (
            text,
            budget,
            mode,
            allowed,
        )
        gp = tpu_tok.encode_trim_prefix_batch(
            [text], budget, allowed_special=allowed
        )[0]
        ep = host_tok.encode_trim_prefix(text, budget, allowed_special=allowed)
        assert (gp.token_ids, gp.text) == tuple(ep), (text, budget, allowed)


def test_trim_batch_is_budget_aware(tpu_tok, host_tok):
    """A small-budget trim over a large doc must not materialize the
    full id stream: tokens_out advances by about
    the budget, not the document's token count."""
    doc = ("budget aware trims never assemble everything " * 64 + "\n") * 64
    base = tpu_tok.stats.tokens_out
    got = tpu_tok.encode_trim_suffix_batch([doc], 8)[0]
    grew = tpu_tok.stats.tokens_out - base
    assert grew <= 64, f"suffix trim assembled {grew} ids for budget 8"
    expect = host_tok.encode_trim_suffix(doc, 8)
    assert (got.token_ids, got.text) == tuple(expect)

    base = tpu_tok.stats.tokens_out
    gp = tpu_tok.encode_trim_prefix_batch([doc], 8)[0]
    grew = tpu_tok.stats.tokens_out - base
    assert grew <= 64, f"prefix trim assembled {grew} ids for budget 8"
    ep = host_tok.encode_trim_prefix(doc, 8)
    assert (gp.token_ids, gp.text) == tuple(ep)


def test_trim_batch_mixed_budgets(tpu_tok, host_tok):
    """Heterogeneous per-text budgets size each segment's bookkeeping
    WINDOW independently — parity across the whole budget range in one
    call, both trim directions and both suffix modes."""
    texts = [t for t in TEXTS if True]
    budgets = [(i * 7 + 1) % 45 for i in range(len(texts))]
    budgets[0] = 0      # degenerate -> host loop
    budgets[-1] = 10000  # total <= b -> full gather
    for mode in ("ts", "cs"):
        got = tpu_tok.encode_trim_suffix_batch(
            texts, budgets, allowed_special="all", mode=mode
        )
        for t, b, res in zip(texts, budgets, got):
            want = host_tok.encode_trim_suffix(
                t, b, allowed_special="all", mode=mode
            )
            assert (res.token_ids, res.text) == tuple(want), (t, b, mode)
    gotp = tpu_tok.encode_trim_prefix_batch(
        texts, budgets, allowed_special="all"
    )
    for t, b, res in zip(texts, budgets, gotp):
        want = host_tok.encode_trim_prefix(t, b, allowed_special="all")
        assert (res.token_ids, res.text) == tuple(want), (t, b)


def test_trim_batch_degenerate_budget_before_rotation(host_tok):
    """Regression (found by the randomized trim campaign, iter 24,823):
    a budget<1 text early in the batch used to fall back to the
    SINGLE-DOC trim MID-LOOP; that path re-tokenizes, which can rotate
    the dedup generation and orphan the precomputed window row indices
    of every later text — their id gathers then read the fresh (empty)
    row bank and silently return [] while the trimmed TEXT (from the
    precomputed UTF-16 cums) stays correct.  The degenerate budgets are
    now resolved BEFORE the batch setup; a loud identity check on the
    row bank guards the loop.

    Engineered deterministically: per-generation bound 300 rows
    (max_unique_rows=600), a batch carrying ~400 unique pieces so the
    batch setup leaves the dedup past the bound, and a budget-0 doc
    ordered BEFORE the real one so the old fallback would rotate
    mid-loop."""
    require_vocab("gpt2")
    from tokenizer_tpu.models.registry import get_encoding_spec
    from tokenizer_tpu.tpu import TpuTokenizer
    from tokenizer_tpu.vocab import Vocabulary

    v = Vocabulary.for_encoding("gpt2", allow_fetch=False)
    spec = get_encoding_spec("gpt2")
    tok = TpuTokenizer(
        v, spec.special_tokens, spec.pattern, max_unique_rows=600
    )
    big = " ".join(f"w{i} {i}" for i in range(200)) + " tail piece here"
    # The budget-0 doc must be >= _BATCH_DELEGATE_BYTES so its
    # single-doc fallback takes the batched pipeline (the only
    # single-doc entry that can rotate).
    docs = ["hello world " * 120, big]
    budgets = [0, 7]

    for mode in ("ts", "cs"):
        got = tok.encode_trim_suffix_batch(docs, budgets, mode=mode)
        for t, b, res in zip(docs, budgets, got):
            want = host_tok.encode_trim_suffix(t, b, mode=mode)
            assert (res.token_ids, res.text) == tuple(want), (b, mode)
    gotp = tok.encode_trim_prefix_batch(docs, budgets)
    for t, b, res in zip(docs, budgets, gotp):
        want = host_tok.encode_trim_prefix(t, b)
        assert (res.token_ids, res.text) == tuple(want), b
        assert res.token_ids or b == 0 or not t
