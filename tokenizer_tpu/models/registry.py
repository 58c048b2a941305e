"""Encoding/model registry: the configuration tables of the framework.

This is the equivalent of the reference's builder registries
(`Tokenizer_C#/TokenizerLib/TokenizerBuilder.cs:14-66` and
`tokenizer_ts/src/tokenizerBuilder.ts:6-55`): model-name -> encoding maps
(exact and prefix), per-encoding regex pre-split patterns, special-token
tables, and rank-file URLs.  Everything here is immutable data; the tables
reproduce the reference verbatim (the TS side, which is the newer superset:
it adds o200k_base/gpt-4o and the Azure "gpt-35-turbo-" prefix).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Mapping, Optional, Tuple

ENDOFTEXT = "<|endoftext|>"
FIM_PREFIX = "<|fim_prefix|>"
FIM_MIDDLE = "<|fim_middle|>"
FIM_SUFFIX = "<|fim_suffix|>"
ENDOFPROMPT = "<|endofprompt|>"

# ---------------------------------------------------------------------------
# Regex pre-split patterns.
#
# Three pattern generations, mirroring tokenizer_ts/src/tokenizerBuilder.ts:66-89.
# Python's `regex` module supports the same Unicode property classes (\p{L},
# \p{N}, \p{Lu}, ...) and the \s+(?!\S) lookahead used by all three.
# ---------------------------------------------------------------------------

#: Pattern used before gpt-3.5-turbo (gpt2 / r50k_base / p50k_base / p50k_edit).
#: Reference: tokenizerBuilder.ts:66-67 (REGEX_PATTERN_1), TokenizerBuilder.cs:140.
REGEX_PATTERN_1 = (
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)

#: Pattern used for cl100k_base (gpt-3.5-turbo / gpt-4).  The TS reference
#: enumerates contraction case variants explicitly (including the asymmetric
#: 'eR and the absent 'rE) rather than using an inline case-insensitive
#: group like the C# side; the goldens are generated with this enumeration,
#: so we reproduce it exactly.  Reference: tokenizerBuilder.ts:72-73
#: (REGEX_PATTERN_2); C# equivalent TokenizerBuilder.cs:112.
REGEX_PATTERN_2 = (
    r"(?:'s|'S|'t|'T|'re|'RE|'Re|'eR|'ve|'VE|'vE|'Ve|'m|'M|'ll|'lL|'Ll|'LL|'d|'D)"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+"
    r"|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)

#: Pattern used for o200k_base (gpt-4o).  Reference: tokenizerBuilder.ts:79-89
#: (REGEX_PATTERN_3); the TS source embeds literal CR/LF characters via
#: template strings, which are equivalent to the \r\n escapes used here.
_O200K_PARTS: Tuple[str, ...] = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"(?:'s|'S|'t|'T|'re|'RE|'Re|'eR|'ve|'VE|'vE|'Ve|'m|'M|'ll|'lL|'Ll|'LL|'d|'D)?",
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"(?:'s|'S|'t|'T|'re|'RE|'Re|'eR|'ve|'VE|'vE|'Ve|'m|'M|'ll|'lL|'Ll|'LL|'d|'D)?",
    r"\p{N}{1,3}",
    r" ?[^\s\p{L}\p{N}]+[\r\n/]*",
    r"\s*[\r\n]+",
    r"\s+(?!\S)",
    r"\s+",
)
REGEX_PATTERN_3 = "|".join(_O200K_PARTS)


# ---------------------------------------------------------------------------
# Encoding specs
# ---------------------------------------------------------------------------

_OPENAI_BLOB = "https://openaipublic.blob.core.windows.net/encodings"


@dataclass(frozen=True)
class EncodingSpec:
    """Static description of one encoding (vocab + regex + specials).

    Mirrors the per-encoding switch in createByEncoderName
    (tokenizerBuilder.ts:236-263, TokenizerBuilder.cs:109-181).
    """

    name: str
    pattern: str
    vocab_url: str
    special_tokens: Mapping[str, int]
    #: Another encoding whose rank file has identical content (r50k_base is
    #: byte-identical to the vendored gpt2.tiktoken), used for offline asset
    #: resolution.  None if the vocab is unique.
    vocab_alias: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(
            self, "special_tokens", MappingProxyType(dict(self.special_tokens))
        )


#: Special-token tables per encoding.  Reference: getSpecialTokensByEncoder
#: (tokenizerBuilder.ts:128-160); C# TokenizerBuilder.cs:114-176.
_SPECIALS_GPT2 = {ENDOFTEXT: 50256}
_SPECIALS_CL100K = {
    ENDOFTEXT: 100257,
    FIM_PREFIX: 100258,
    FIM_MIDDLE: 100259,
    FIM_SUFFIX: 100260,
    ENDOFPROMPT: 100276,
}
_SPECIALS_O200K = {ENDOFTEXT: 199999, ENDOFPROMPT: 200018}
_SPECIALS_P50K_EDIT = {
    ENDOFTEXT: 50256,
    FIM_PREFIX: 50281,
    FIM_MIDDLE: 50282,
    FIM_SUFFIX: 50283,
}

ENCODINGS: Mapping[str, EncodingSpec] = MappingProxyType(
    {
        "o200k_base": EncodingSpec(
            name="o200k_base",
            pattern=REGEX_PATTERN_3,
            vocab_url=f"{_OPENAI_BLOB}/o200k_base.tiktoken",
            special_tokens=_SPECIALS_O200K,
        ),
        "cl100k_base": EncodingSpec(
            name="cl100k_base",
            pattern=REGEX_PATTERN_2,
            vocab_url=f"{_OPENAI_BLOB}/cl100k_base.tiktoken",
            special_tokens=_SPECIALS_CL100K,
        ),
        "p50k_base": EncodingSpec(
            name="p50k_base",
            pattern=REGEX_PATTERN_1,
            vocab_url=f"{_OPENAI_BLOB}/p50k_base.tiktoken",
            special_tokens=_SPECIALS_GPT2,
        ),
        "p50k_edit": EncodingSpec(
            name="p50k_edit",
            pattern=REGEX_PATTERN_1,
            # p50k_edit shares p50k_base's rank file (tokenizerBuilder.ts:249-252).
            vocab_url=f"{_OPENAI_BLOB}/p50k_base.tiktoken",
            special_tokens=_SPECIALS_P50K_EDIT,
            vocab_alias="p50k_base",
        ),
        "r50k_base": EncodingSpec(
            name="r50k_base",
            pattern=REGEX_PATTERN_1,
            vocab_url=f"{_OPENAI_BLOB}/r50k_base.tiktoken",
            special_tokens=_SPECIALS_GPT2,
            # r50k_base's rank file is byte-identical content to gpt2.tiktoken
            # (both describe the original GPT-2 merges; the reference's gpt2
            # conformance golden equals its r50k golden).
            vocab_alias="gpt2",
        ),
        "gpt2": EncodingSpec(
            name="gpt2",
            pattern=REGEX_PATTERN_1,
            vocab_url="https://raw.githubusercontent.com/microsoft/Tokenizer/main/model/gpt2.tiktoken",
            special_tokens=_SPECIALS_GPT2,
        ),
        # -- framework addition (NOT in the reference registry) ---------
        # cl100k-SCALE stand-in for offline environments: 100,256 ranks
        # (cl100k_base's exact mergeable-rank count) trained offline by
        # tools/train_synth_vocab.py and vendored in vocab/, paired with
        # the REAL cl100k_base pattern + special table so the pattern-2
        # scanner and a 100k-token pair table are exercised end-to-end.
        # Cross-validated bit-exact against Rust tiktoken on the same
        # ranks (tests/test_cl100k_synth.py).  Token IDS differ from the
        # real cl100k_base by construction — this exists for perf work
        # and pattern-2 coverage, not OpenAI-model compatibility.
        "cl100k_synth": EncodingSpec(
            name="cl100k_synth",
            pattern=REGEX_PATTERN_2,
            vocab_url="",  # vendored only; never fetched
            special_tokens=_SPECIALS_CL100K,
        ),
        # o200k-SCALE sibling: 199,998 synthetic ranks (just under the
        # 199,999 endoftext special) + the REAL o200k_base pattern and
        # special table — pattern-3 coverage at real vocabulary scale.
        "o200k_synth": EncodingSpec(
            name="o200k_synth",
            pattern=REGEX_PATTERN_3,
            vocab_url="",  # vendored only; never fetched
            special_tokens=_SPECIALS_O200K,
        ),
    }
)


# ---------------------------------------------------------------------------
# Model name -> encoding maps
# ---------------------------------------------------------------------------

#: Prefix matches, checked in order after the exact map misses.
#: Reference: tokenizerBuilder.ts:6-12 (MODEL_PREFIX_TO_ENCODING);
#: C# TokenizerBuilder.cs:17-24 (without gpt-4o / Azure entries).
MODEL_PREFIX_TO_ENCODING: Tuple[Tuple[str, str], ...] = (
    ("gpt-4o-", "o200k_base"),  # e.g., gpt-4o-2024-05-13
    ("gpt-4-", "cl100k_base"),  # e.g., gpt-4-0314, gpt-4-32k
    ("gpt-3.5-turbo-", "cl100k_base"),  # e.g., gpt-3.5-turbo-0301
    ("gpt-35-turbo-", "cl100k_base"),  # Azure deployment name
)

#: Exact model-name matches.  Reference: tokenizerBuilder.ts:14-55
#: (MODEL_TO_ENCODING); C# TokenizerBuilder.cs:26-66.
MODEL_TO_ENCODING: Mapping[str, str] = MappingProxyType(
    {
        # chat
        "gpt-4o": "o200k_base",
        "gpt-4": "cl100k_base",
        "gpt-3.5-turbo": "cl100k_base",
        # text
        "text-davinci-003": "p50k_base",
        "text-davinci-002": "p50k_base",
        "text-davinci-001": "r50k_base",
        "text-curie-001": "r50k_base",
        "text-babbage-001": "r50k_base",
        "text-ada-001": "r50k_base",
        "davinci": "r50k_base",
        "curie": "r50k_base",
        "babbage": "r50k_base",
        "ada": "r50k_base",
        # code
        "code-davinci-002": "p50k_base",
        "code-davinci-001": "p50k_base",
        "code-cushman-002": "p50k_base",
        "code-cushman-001": "p50k_base",
        "davinci-codex": "p50k_base",
        "cushman-codex": "p50k_base",
        # edit
        "text-davinci-edit-001": "p50k_edit",
        "code-davinci-edit-001": "p50k_edit",
        # embeddings
        "text-embedding-ada-002": "cl100k_base",
        # old embeddings
        "text-similarity-davinci-001": "r50k_base",
        "text-similarity-curie-001": "r50k_base",
        "text-similarity-babbage-001": "r50k_base",
        "text-similarity-ada-001": "r50k_base",
        "text-search-davinci-doc-001": "r50k_base",
        "text-search-curie-doc-001": "r50k_base",
        "text-search-babbage-doc-001": "r50k_base",
        "text-search-ada-doc-001": "r50k_base",
        "code-search-babbage-code-001": "r50k_base",
        "code-search-ada-code-001": "r50k_base",
        # open source
        "gpt2": "gpt2",
    }
)


def encoding_name_for_model(model_name: str) -> str:
    """Resolve a model name to its encoding name (exact map, then prefixes).

    Mirrors getEncoderFromModelName (tokenizerBuilder.ts:91-104) /
    CreateByModelNameAsync lookup (TokenizerBuilder.cs:85-95).  Returns ""
    for unknown models, like the TS reference (the failure then surfaces as
    an unknown-encoder error downstream).
    """
    enc = MODEL_TO_ENCODING.get(model_name)
    if enc is not None:
        return enc
    for prefix, encoding in MODEL_PREFIX_TO_ENCODING:
        if model_name.startswith(prefix):
            return encoding
    return ""


def get_encoding_spec(encoder_name: str) -> EncodingSpec:
    spec = ENCODINGS.get(encoder_name)
    if spec is None:
        # Message mirrors tokenizerBuilder.ts:262 / TokenizerBuilder.cs:178.
        raise ValueError(f"Doesn't support this encoder [{encoder_name}]")
    return spec


def get_regex_by_encoder(encoder_name: str) -> str:
    """Regex pattern for an encoder name (tokenizerBuilder.ts:182-192)."""
    if encoder_name == "o200k_base":
        return REGEX_PATTERN_3
    if encoder_name == "cl100k_base":
        return REGEX_PATTERN_2
    return REGEX_PATTERN_1


def get_regex_by_model(model_name: str) -> str:
    """Regex pattern for a model name (tokenizerBuilder.ts:199-203)."""
    return get_regex_by_encoder(encoding_name_for_model(model_name))


def get_special_tokens_by_encoder(encoder_name: str) -> dict:
    """Special-token table for an encoder name (tokenizerBuilder.ts:128-160).

    Unknown encoders fall back to the gpt2 table, like the TS reference's
    default switch case.
    """
    spec = ENCODINGS.get(encoder_name)
    if spec is None:
        return dict(_SPECIALS_GPT2)
    return dict(spec.special_tokens)


def get_special_tokens_by_model(model_name: str) -> dict:
    """Special-token table for a model name (tokenizerBuilder.ts:167-175)."""
    return get_special_tokens_by_encoder(encoding_name_for_model(model_name))
