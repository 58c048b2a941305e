"""tokenizer_tpu — tiktoken-compatible BPE tokenization with a JAX device path.

A from-scratch reimplementation of the microsoft/Tokenizer capability
set (tiktoken-parity encode / trim-suffix / trim-prefix / decode with
special-token handling for gpt2, r50k/p50k/p50k_edit, cl100k_base and
o200k_base): a native host pre-split and byte packing feed a jitted
XLA merge kernel with the pair table resident on the device,
data-parallel over a `jax.sharding.Mesh`.

Public surface mirrors the reference's (`ITokenizer.cs:7-46`,
`tokenizer_ts/src/index.ts:1-11`): the :class:`TikTokenizer` engine,
builder functions, and registry getters — plus the device bulk pipeline.
"""

from .bpe import byte_pair_encode
from .builder import (
    create_by_encoder_name,
    create_by_model_name,
    create_tokenizer,
)
from .engine import ALL_SPECIAL_TOKENS, TikTokenizer, TrimResult
from .models.registry import (
    MODEL_TO_ENCODING,
    REGEX_PATTERN_1,
    REGEX_PATTERN_2,
    REGEX_PATTERN_3,
    encoding_name_for_model,
    get_regex_by_encoder,
    get_regex_by_model,
    get_special_tokens_by_encoder,
    get_special_tokens_by_model,
)
from .utils.lru import LRUCache
from .vocab import Vocabulary, load_tiktoken_file, parse_tiktoken_data

__version__ = "0.1.0"

__all__ = [
    "TikTokenizer",
    "TrimResult",
    "ALL_SPECIAL_TOKENS",
    "byte_pair_encode",
    "create_by_model_name",
    "create_by_encoder_name",
    "create_tokenizer",
    "encoding_name_for_model",
    "MODEL_TO_ENCODING",
    "get_regex_by_encoder",
    "get_regex_by_model",
    "get_special_tokens_by_encoder",
    "get_special_tokens_by_model",
    "REGEX_PATTERN_1",
    "REGEX_PATTERN_2",
    "REGEX_PATTERN_3",
    "LRUCache",
    "Vocabulary",
    "load_tiktoken_file",
    "parse_tiktoken_data",
    "TpuTokenizer",
]


def __getattr__(name):
    # Lazy: importing TpuTokenizer pulls in jax; the host engine and
    # builders must stay importable on jax-free hosts (and fast
    # everywhere).  `create_*(use_tpu=True)` lazy-imports the same way.
    if name == "TpuTokenizer":
        from .tpu import TpuTokenizer

        return TpuTokenizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
