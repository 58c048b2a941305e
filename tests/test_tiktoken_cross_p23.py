"""Cross-validation of the cl100k/o200k PATTERN paths vs Rust tiktoken.

The real cl100k_base/o200k_base rank files cannot be fetched in this
offline environment, so the pattern-2/3 golden tests gate on network.
This module closes most of that gap with an independent oracle that
needs no rank file: a small BPE vocabulary trained offline (standard
merge-frequency training, so every multi-byte token is the concat of
two earlier tokens), combined with the REAL pattern strings and special
-token tables of cl100k_base and o200k_base
(tokenizerBuilder.ts:66-89,126-154).  Rust tiktoken accepts any
(pat_str, mergeable_ranks) pair, and its byte_pair_merge is the
algorithm the reference transliterated (TikTokenizer.cs:14-18) — so
agreement here validates our pattern-2/3 regex handling, special
scanning, and merge loop end-to-end, on both the host engine and the
packed device path.
"""

import random
import string
from collections import Counter

import pytest

tiktoken = pytest.importorskip("tiktoken")
regex = pytest.importorskip("regex")

from tokenizer_tpu.models.registry import (
    REGEX_PATTERN_2,
    REGEX_PATTERN_3,
    get_special_tokens_by_encoder,
)

_SEED_CORPUS = (
    "The quick brown fox jumps over the lazy dog. "
    "DON'T can't won't it's I'll we've they'd I'm you're THEY'RE "
    "def f(x):\n    return x + 1  # comment\n"
    "for i in range(100): print(i, 2.5e-3)\n"
    "numbers 1 22 333 4444 55555 123456789 0xdeadbeef\n"
    "  indented\tblock\r\nwindows line\rold mac\n\n\n"
    "punct !@#$%^&*()_+-=[]{}|;:'\",.<>?/~`\n"
    "unicode ⭐ étoile ñandú Straße\n"
    "你好世界 こんにちは 안녕하세요 مرحبا שלום\n"
) * 4


def train_bpe(pattern: str, n_merges: int):
    """Offline BPE training: returns a closure-valid ranks dict."""
    pat = regex.compile(pattern)
    words = Counter()
    for piece in pat.findall(_SEED_CORPUS):
        words[tuple(bytes([b]) for b in piece.encode("utf-8"))] += 1
    ranks = {bytes([i]): i for i in range(256)}
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in words.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        # Deterministic: max count, then lexicographically smallest pair.
        cand = sorted(
            pairs.items(), key=lambda kv: (-kv[1], kv[0][0], kv[0][1])
        )
        merged = None
        for (a, b), _c in cand:
            if a + b not in ranks:  # skip concat collisions (ab+c vs a+bc)
                merged = (a, b)
                break
        if merged is None:
            break
        a, b = merged
        ranks[a + b] = len(ranks)

        def apply(w):
            out = []
            i = 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            return tuple(out)

        words = Counter({apply(w): c for w, c in words.items()})
    return ranks


def _build(pattern: str, encoder_name: str):
    from tokenizer_tpu import create_tokenizer

    ranks = train_bpe(pattern, 300)
    specials = get_special_tokens_by_encoder(encoder_name)
    rust = tiktoken.Encoding(
        name=f"{encoder_name}-synth",
        pat_str=pattern,
        mergeable_ranks=ranks,
        special_tokens=specials,
    )
    host = create_tokenizer(ranks, specials, pattern, use_tpu=False)
    tpu = create_tokenizer(ranks, specials, pattern, use_tpu=True)
    return host, tpu, rust


@pytest.fixture(scope="module", params=["p2", "p3"])
def trio(request):
    if request.param == "p2":
        return _build(REGEX_PATTERN_2, "cl100k_base")
    return _build(REGEX_PATTERN_3, "o200k_base")


CORPUS = [
    "",
    "!",
    "Hello World",
    "MixedCASE WordS aNd ACRONYMS NASA iPhone",
    "don't CAN'T it'S I'Ll we'Ve they'D THEY'RE y'eR",
    "numbers 1 22 333 4444 55555 1234 12345678",
    "  leading spaces   and   runs  ",
    "line\nbreaks\r\nand\rreturns \n \n mixed \n\n\n",
    "space before\n newline and spaces \n",
    "punct!@# $%^ &*()[]{} //path/to/file// a//b",
    "url https://example.com/a/b?q=1&r=2",
    "unicode ⭐ étoile Straße ñandú",
    "CJK 你好世界 こんにちは 안녕하세요",
    "emoji 💩 👍🏽 flags 🇺🇸",
    "a" * 300,
    " 123456 digits run " + "9" * 40,
    "trailing space ",
    "\t\t tabs \t ",
]


@pytest.mark.parametrize("idx", range(len(CORPUS)))
def test_corpus_matches_rust(trio, idx):
    host, tpu, rust = trio
    text = CORPUS[idx]
    want = rust.encode(text, disallowed_special=())
    assert host.encode(text) == want
    got = tpu.encode_batch([text])[0]
    assert list(got) == want


def test_random_fuzz_matches_rust(trio):
    host, tpu, rust = trio
    rng = random.Random(0xC100C1)
    alphabet = (
        string.ascii_letters
        + string.digits
        + string.punctuation
        + "     \t\n\r"
        + "⭐💩你好éñÉÑΑβΓ"
    )
    texts = [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 120)))
        for _ in range(200)
    ]
    want = [rust.encode(t, disallowed_special=()) for t in texts]
    for t, w in zip(texts, want):
        assert host.encode(t) == w, repr(t)
    got = tpu.encode_batch(texts)
    for t, w, g in zip(texts, want, got):
        assert list(g) == w, repr(t)


def test_specials_match_rust(trio):
    host, tpu, rust = trio
    eot = "<|endoftext|>"
    text = f"before {eot} after {eot}"
    want = rust.encode(text, allowed_special={eot})
    assert host.encode(text, allowed_special={eot}) == want
    assert list(tpu.encode_batch([text], allowed_special={eot})[0]) == want


def test_decode_matches_rust(trio):
    host, _tpu, rust = trio
    for text in CORPUS:
        ids = rust.encode(text, disallowed_special=())
        assert host.decode(ids) == rust.decode(ids)
