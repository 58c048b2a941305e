"""Cross-validation against OpenAI tiktoken's Rust core.

The reference is a transliteration of tiktoken's ``byte_pair_merge``
(TikTokenizer.cs:14-18, tikTokenizer.ts:55-58), so the installed
``tiktoken`` package (Rust bindings, constructed offline from our parsed
gpt2 ranks) is a second independent oracle.  Fuzzes the host engine and
the packed device path on adversarial inputs covering every branch of the
regex patterns.
"""

import random
import string

import pytest

tiktoken = pytest.importorskip("tiktoken")

from conftest import has_vocab

from tokenizer_tpu.models.registry import REGEX_PATTERN_1

pytestmark = pytest.mark.skipif(
    not has_vocab("gpt2"), reason="gpt2 rank file not available offline"
)


@pytest.fixture(scope="module")
def oracle_pair():
    from tokenizer_tpu import create_by_encoder_name
    from tokenizer_tpu.vocab import load_encoding_ranks

    ranks = load_encoding_ranks("gpt2", allow_fetch=False)
    rust = tiktoken.Encoding(
        name="gpt2-local",
        pat_str=REGEX_PATTERN_1,
        mergeable_ranks=ranks,
        special_tokens={"<|endoftext|>": 50256},
    )
    ours = create_by_encoder_name("gpt2", allow_fetch=False)
    return ours, rust


CORPUS = [
    "",
    "!",
    "Hello World",
    "hello world",
    "  leading and   multiple   spaces  ",
    "tabs\tand\nnewlines\r\nand\rcarriage",
    "don't can't won't it's I'll we've they'd I'm",
    "DON'T CAN'T WON'T IT'S",
    "numbers 1 22 333 4444 55555 123456789012345",
    "mixed123abc456def",
    "punct!@#$%^&*()_+-=[]{}|;:'\",.<>?/~`",
    "unicode ⭐ ✨ ♥ ÿ é ü ñ",
    "emoji 💩 👍🏽 👨‍👩‍👧‍👦 🇺🇸",
    "CJK 你好世界 こんにちは 안녕하세요",
    "arabic مرحبا بالعالم hebrew שלום עולם",
    "combining áé ñ",
    "    ",
    "\n\n\n",
    " \n \n ",
    "a" * 300,
    "ab" * 200,
    "supercalifragilisticexpialidocious",
    "x1y2z3 " * 50,
    "\x00\x01\x02 control bytes",
    "trailing space ",
    " ",
    "   line separators",
]


@pytest.mark.parametrize("idx", range(len(CORPUS)))
def test_corpus_matches_rust(oracle_pair, idx):
    ours, rust = oracle_pair
    text = CORPUS[idx]
    assert ours.encode(text) == rust.encode(text, disallowed_special=())


def test_random_fuzz_matches_rust(oracle_pair):
    ours, rust = oracle_pair
    rng = random.Random(0xBEEF)
    alphabet = (
        string.ascii_letters
        + string.digits
        + string.punctuation
        + "     \t\n\r"
        + "⭐💩你好éñ́"
    )
    for _ in range(300):
        n = rng.randint(0, 120)
        text = "".join(rng.choice(alphabet) for _ in range(n))
        assert ours.encode(text) == rust.encode(text, disallowed_special=()), (
            repr(text)
        )


def test_random_bytes_fuzz_matches_rust(oracle_pair):
    ours, rust = oracle_pair
    rng = random.Random(0xF00D)
    for _ in range(100):
        n = rng.randint(1, 80)
        raw = bytes(rng.randrange(256) for _ in range(n))
        text = raw.decode("utf-8", errors="replace")
        assert ours.encode(text) == rust.encode(text, disallowed_special=())


def test_specials_match_rust(oracle_pair):
    ours, rust = oracle_pair
    text = "A<|endoftext|>B<|endoftext|>"
    assert ours.encode(text, allowed_special="all") == rust.encode(
        text, allowed_special="all"
    )


def test_decode_matches_rust(oracle_pair):
    ours, rust = oracle_pair
    ids = rust.encode("round trip ⭐ fidelity 123!", disallowed_special=())
    assert ours.decode(ids) == rust.decode(ids)
