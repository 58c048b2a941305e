"""Host tokenizer engine: the reference-parity implementation.

This is the framework's semantic core — an exact reimplementation of the
reference engine (`Tokenizer_C#/TokenizerLib/TikTokenizer.cs:20-607`,
`tokenizer_ts/src/tikTokenizer.ts:60-494`): special-token segmentation,
regex pre-split, LRU piece cache, whole-piece encoder hits, the BPE
merge loop, token-budget trims (suffix and prefix), and lossless decode.

Where the two reference implementations diverge, this engine follows the
TS side (the newer superset): ``encode_trim_suffix`` slices mid-piece to
exactly fill the budget (tikTokenizer.ts:246-249,275-281; the C# build
drops the whole piece, TikTokenizer.cs:296-339), and ``encode_trim_prefix``
keeps the TS naive re-encode fallback (tikTokenizer.ts:454-462).

Trim offsets are tracked in UTF-16 code units like the C#/JS strings the
reference operates on (see :mod:`tokenizer_tpu.utils.text`).

The device-accelerated bulk paths (:mod:`tokenizer_tpu.tpu`) reuse this
class for segmentation/trim bookkeeping and must match its output
bit-for-bit; tests enforce that.
"""

from __future__ import annotations

import os
import re
from functools import partial
from typing import (
    IO,
    Collection,
    Dict,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from .bpe import byte_pair_encode
from .models.registry import REGEX_PATTERN_1, REGEX_PATTERN_2, REGEX_PATTERN_3
from .utils.lru import DEFAULT_CACHE_SIZE, LRUCache
from .utils.text import utf16_len, utf16_slice, utf8_bytes
from .vocab import Vocabulary, load_tiktoken_file

__all__ = ["TikTokenizer", "TrimResult", "ALL_SPECIAL_TOKENS"]

#: Sentinel for "allow every special token registered at construction",
#: the behavior of the C# ``applySpecialTokens=true`` overloads
#: (TikTokenizer.cs:193-199).
ALL_SPECIAL_TOKENS = "all"

AllowedSpecial = Union[None, str, Collection[str]]


class TrimResult(NamedTuple):
    """Result of the trim encoders: ids plus the surviving text."""

    token_ids: List[int]
    text: str


#: Registry pattern -> native scanner id (runtime/native/presplit.cpp).
NATIVE_PATTERN_IDS = {REGEX_PATTERN_1: 1, REGEX_PATTERN_2: 2, REGEX_PATTERN_3: 3}


def _piece_splitter(pattern: str):
    """``split(text, start, end) -> pieces of text[start:end]``.

    Where the third-party ``regex`` package is installed, the pattern
    compiles with it: the reference's own engine, matched lazily, so a
    trim that stops early splits no further and the per-call cost on
    short texts stays a few microseconds.  That also keeps this engine,
    the parity oracle, independent of the native scanner that the bulk
    pipeline (:mod:`tokenizer_tpu.tpu`) runs.  Without ``regex`` the
    registry's three patterns pre-split through the native scanner
    (whole segment per call); any other pattern then has no engine
    (stdlib ``re`` has no ``\\p{..}`` classes).
    """
    try:
        import regex
    except ImportError:
        regex = None
    if regex is not None:
        finditer = regex.compile(pattern).finditer
        return lambda text, start, end: (
            m.group(0) for m in finditer(text, start, end)
        )
    pid = NATIVE_PATTERN_IDS.get(pattern)
    if pid is not None:
        from .runtime import native

        if native.available():
            return partial(native.split_text, pattern_id=pid)
    raise ImportError(
        "this pre-split pattern needs the 'regex' package: the native"
        " scanner serves only the registry's patterns, and only where"
        " a C++ compiler can build it"
    )


class TikTokenizer:
    """tiktoken-compatible BPE tokenizer (host reference engine).

    Parameters mirror the reference constructors
    (TikTokenizer.cs:48-72, tikTokenizer.ts:80-89): a rank source (path
    to a ``.tiktoken`` file, a parsed ``bytes -> rank`` mapping, or a
    :class:`~tokenizer_tpu.vocab.Vocabulary`), the special-token
    encoder, the pre-split regex pattern, and the LRU cache size.
    """

    def __init__(
        self,
        ranks_or_path: Union[str, os.PathLike, Mapping[bytes, int], Vocabulary, IO],
        special_tokens: Mapping[str, int],
        pattern: str,
        cache_size: int = DEFAULT_CACHE_SIZE,
    ):
        if isinstance(ranks_or_path, Vocabulary):
            vocab = ranks_or_path
        elif isinstance(ranks_or_path, (str, os.PathLike)):
            vocab = Vocabulary(load_tiktoken_file(ranks_or_path))
        elif hasattr(ranks_or_path, "read"):
            # Stream source — the C# builder's CreateTokenizer(Stream,
            # ...) overload (TokenizerBuilder.cs:210): any binary
            # file-like object with the tiktoken line format.
            from .vocab import parse_tiktoken_data

            data = ranks_or_path.read()
            if isinstance(data, str):
                data = data.encode("utf-8")
            vocab = Vocabulary(parse_tiktoken_data(data))
        else:
            vocab = Vocabulary(ranks_or_path)
        self.vocab = vocab
        self.encoder: Dict[bytes, int] = vocab.encoder
        self.decoder: Dict[int, bytes] = vocab.decoder

        self.pattern = pattern
        self._split = _piece_splitter(pattern)
        self.special_tokens_encoder: Dict[str, int] = dict(special_tokens)
        self.special_tokens_decoder: Dict[int, str] = {
            v: k for k, v in self.special_tokens_encoder.items()
        }
        if self.special_tokens_encoder:
            # escapeRegExp (tikTokenizer.ts:50-52): an alternation of
            # literals, which stdlib ``re`` matches like the reference.
            self._specials_re = re.compile(
                "|".join(re.escape(s) for s in self.special_tokens_encoder)
            )
        else:
            self._specials_re = None
        self.cache: LRUCache[str, List[int]] = LRUCache(cache_size)

    # -- introspection ------------------------------------------------------

    @property
    def num_cache_entries(self) -> int:
        """NumOfCacheEntries (TikTokenizer.cs:38)."""
        return len(self.cache)

    # -- special-token scanning --------------------------------------------

    def _resolve_allowed(self, allowed_special: AllowedSpecial):
        """Normalize the allowed-special argument.

        ``None``/empty → no special handling (TS ``encode(text)`` with
        ``allowedSpecial`` undefined; result is identical to scanning and
        allowing nothing).  ``ALL_SPECIAL_TOKENS`` → every constructor
        special (C# ``applySpecialTokens=true``).  Otherwise a collection
        of literal special-token strings.
        """
        if allowed_special is None:
            return None
        if isinstance(allowed_special, str):
            if allowed_special == ALL_SPECIAL_TOKENS:
                return set(self.special_tokens_encoder)
            raise ValueError(
                "allowed_special must be a collection of special tokens or "
                f"'{ALL_SPECIAL_TOKENS}'"
            )
        allowed = set(allowed_special)
        return allowed if allowed else None

    def _find_next_special(
        self, text: str, start: int, allowed: Optional[set]
    ) -> Tuple[Optional[re.Match], int]:
        """findNextSpecialToken (tikTokenizer.ts:123-144, TikTokenizer.cs:230-241).

        Scans for the next special-token occurrence from ``start``; any
        match not in ``allowed`` is skipped by restarting one position
        past its start.  Returns (match-or-None, segment_end).
        """
        if allowed and self._specials_re is not None:
            pos = start
            while True:
                m = self._specials_re.search(text, pos)
                if m is None:
                    break
                if m.group(0) in allowed:
                    return m, m.start()
                pos = m.start() + 1
        return None, len(text)

    # -- encode -------------------------------------------------------------

    def _encode_piece(self, piece: str) -> List[int]:
        """Cache → whole-piece hit → BPE loop (tikTokenizer.ts:202-220)."""
        cached = self.cache.get(piece)
        if cached is not None:
            return cached
        bts = utf8_bytes(piece)
        tid = self.encoder.get(bts)
        toks = [tid] if tid is not None else byte_pair_encode(bts, self.encoder)
        self.cache.set(piece, toks)
        return toks

    def _encode_segment(
        self, text: str, ids: List[int], start: int, end: int
    ) -> None:
        """encodeByIndex (tikTokenizer.ts:192-223, TikTokenizer.cs:250-274)."""
        for piece in self._split(text, start, end):
            ids.extend(self._encode_piece(piece))

    def encode(
        self, text: str, allowed_special: AllowedSpecial = None
    ) -> List[int]:
        """Encode text; specials in ``allowed_special`` stay atomic.

        Mirrors ``encode`` (tikTokenizer.ts:152-181) / ``Encode``
        (TikTokenizer.cs:141-199).  Pass :data:`ALL_SPECIAL_TOKENS` for
        the C# ``applySpecialTokens=true`` behavior.
        """
        allowed = self._resolve_allowed(allowed_special)
        ids: List[int] = []
        start = 0
        n = len(text)
        while True:
            m, end = self._find_next_special(text, start, allowed)
            if end > start:
                self._encode_segment(text, ids, start, end)
            if m is None:
                break
            ids.append(self.special_tokens_encoder[m.group(0)])
            start = m.end()
            if start >= n:
                break
        return ids

    # -- encode with trim-suffix -------------------------------------------

    def encode_trim_suffix(
        self,
        text: str,
        max_token_count: int,
        allowed_special: AllowedSpecial = None,
        mode: str = "ts",
    ) -> TrimResult:
        """Encode limited to ``max_token_count`` ids by trimming the suffix.

        The two reference implementations diverge here, so both are
        offered (SURVEY.md §3.3):

        * ``mode="ts"`` (default, the newer library): a piece that
          overflows the budget contributes a prefix SLICE of its ids and
          ``text`` still includes the whole piece
          (encodeTrimSuffix, tikTokenizer.ts:246-249,275-281).
        * ``mode="cs"``: the overflowing piece is dropped WHOLE — neither
          its ids nor its characters appear in the result
          (TikTokenizer.cs:289-342 EncodeTrimSuffix piece loop: on
          overflow it breaks without appending and without advancing
          encodeLength).
        """
        if mode not in ("ts", "cs"):
            raise ValueError(f"mode must be 'ts' or 'cs', got {mode!r}")
        segment = (
            self._encode_trim_suffix_segment
            if mode == "ts"
            else self._encode_trim_suffix_segment_cs
        )
        allowed = self._resolve_allowed(allowed_special)
        ids: List[int] = []
        start = 0
        token_count = 0
        encode_length = 0  # UTF-16 units
        n = len(text)
        while True:
            m, end = self._find_next_special(text, start, allowed)
            if end > start:
                token_count, encode_length, full = segment(
                    text, ids, start, end, max_token_count, token_count, encode_length
                )
                if token_count >= max_token_count:
                    break
            if m is None:
                break
            # Special token: counts one (tikTokenizer.ts:340-354).
            token_count += 1
            if token_count <= max_token_count:
                ids.append(self.special_tokens_encoder[m.group(0)])
                encode_length += utf16_len(m.group(0))
                start = m.end()
                if start >= n:
                    break
            if token_count >= max_token_count:
                break

        if encode_length == utf16_len(text):
            trimmed = text
        else:
            trimmed = utf16_slice(text, 0, encode_length)
        return TrimResult(ids, trimmed)

    def _encode_trim_suffix_segment(
        self,
        text: str,
        ids: List[int],
        start: int,
        end: int,
        max_token_count: int,
        token_count: int,
        encode_length: int,
    ) -> Tuple[int, int, bool]:
        """encodeTrimSuffixByIndex (tikTokenizer.ts:225-291)."""
        for piece in self._split(text, start, end):
            cached = self.cache.get(piece)
            if cached is not None:
                if token_count + len(cached) <= max_token_count:
                    token_count += len(cached)
                    encode_length += utf16_len(piece)
                    ids.extend(cached)
                else:
                    remaining = max_token_count - token_count
                    token_count += remaining
                    encode_length += utf16_len(piece)
                    ids.extend(cached[:remaining])
                    return token_count, encode_length, False
            else:
                bts = utf8_bytes(piece)
                tid = self.encoder.get(bts)
                if tid is not None:
                    self.cache.set(piece, [tid])
                    if token_count + 1 <= max_token_count:
                        token_count += 1
                        encode_length += utf16_len(piece)
                        ids.append(tid)
                    else:
                        # REFERENCE QUIRK, reproduced faithfully: an
                        # UNCACHED whole-piece hit that overflows
                        # contributes NO text (plain `break`,
                        # tikTokenizer.ts:262-264), while the cached
                        # and BPE overflow branches count the piece's
                        # whole text — the reference's trim TEXT is
                        # therefore cache-state-dependent.  The bulk
                        # trim paths implement the deterministic
                        # warm-cache behavior; comparisons must warm
                        # the cache first (see docs/parity.md).
                        return token_count, encode_length, False
                else:
                    toks = byte_pair_encode(bts, self.encoder)
                    self.cache.set(piece, toks)
                    if token_count + len(toks) <= max_token_count:
                        token_count += len(toks)
                        encode_length += utf16_len(piece)
                        ids.extend(toks)
                    else:
                        remaining = max_token_count - token_count
                        token_count += remaining
                        encode_length += utf16_len(piece)
                        ids.extend(toks[:remaining])
                        return token_count, encode_length, False
            if token_count >= max_token_count:
                return token_count, encode_length, False
        return token_count, encode_length, True

    def _encode_trim_suffix_segment_cs(
        self,
        text: str,
        ids: List[int],
        start: int,
        end: int,
        max_token_count: int,
        token_count: int,
        encode_length: int,
    ) -> Tuple[int, int, bool]:
        """C# EncodeTrimSuffix piece loop (TikTokenizer.cs:289-342).

        On overflow the whole piece is dropped: the count is advanced
        past the budget (so the caller's ``>= max`` check breaks the
        outer loop) but neither ids nor encode_length include the piece.
        """
        for piece in self._split(text, start, end):
            cached = self.cache.get(piece)
            if cached is not None:
                toks = cached
            else:
                bts = utf8_bytes(piece)
                tid = self.encoder.get(bts)
                if tid is not None:
                    toks = [tid]
                else:
                    toks = byte_pair_encode(bts, self.encoder)
                    self.cache.set(piece, toks)
            token_count += len(toks)
            if token_count <= max_token_count:
                encode_length += utf16_len(piece)
                ids.extend(toks)
            else:
                return token_count, encode_length, False
            if token_count >= max_token_count:
                return token_count, encode_length, False
        return token_count, encode_length, True

    # -- encode with trim-prefix -------------------------------------------

    def encode_trim_prefix(
        self,
        text: str,
        max_token_count: int,
        allowed_special: AllowedSpecial = None,
    ) -> TrimResult:
        """Encode keeping only the LAST ``max_token_count`` ids.

        encodeTrimPrefix (tikTokenizer.ts:370-468, TikTokenizer.cs:437-583):
        encodes the whole text recording cumulative (token count → UTF-16
        length) at every piece boundary, then drops the smallest boundary
        ≥ (total − max).  Keeps the TS naive fallback: if that boundary
        overshoots the budget, re-encode and slice the exact last ``max``
        ids with ``text = decode(ids)``.
        """
        allowed = self._resolve_allowed(allowed_special)
        ids: List[int] = []
        start = 0
        token_count = 0
        encode_length = 0
        # Insertion-ordered cumulative map (JS Map iteration order).
        token_count_map: Dict[int, int] = {0: 0}
        n = len(text)
        while True:
            m, end = self._find_next_special(text, start, allowed)
            if end > start:
                for piece in self._split(text, start, end):
                    cached = self.cache.get(piece)
                    if cached is not None:
                        toks = cached
                    else:
                        bts = utf8_bytes(piece)
                        tid = self.encoder.get(bts)
                        toks = (
                            [tid]
                            if tid is not None
                            else byte_pair_encode(bts, self.encoder)
                        )
                        self.cache.set(piece, toks)
                    token_count += len(toks)
                    encode_length += utf16_len(piece)
                    ids.extend(toks)
                    token_count_map[token_count] = encode_length
            if m is None:
                break
            ids.append(self.special_tokens_encoder[m.group(0)])
            token_count += 1
            encode_length += utf16_len(m.group(0))
            token_count_map[token_count] = encode_length
            start = m.end()
            if start >= n:
                break

        if token_count <= max_token_count:
            return TrimResult(ids, text)

        prefix_token_count = token_count - max_token_count
        actual_prefix_token_count = 0
        actual_prefix_str_length = 0
        for k, v in token_count_map.items():
            if k >= prefix_token_count:
                actual_prefix_token_count = k
                actual_prefix_str_length = v
                break

        # Naive fallback when chunk boundaries overshoot
        # (tikTokenizer.ts:454-462).
        if actual_prefix_token_count > max_token_count:
            all_ids = self.encode(text, allowed_special)
            sliced = all_ids[len(all_ids) - max_token_count :]
            return TrimResult(sliced, self.decode(sliced))

        return TrimResult(
            ids[actual_prefix_token_count:],
            utf16_slice(text, actual_prefix_str_length, utf16_len(text)),
        )

    # -- decode -------------------------------------------------------------

    def decode(self, tokens: Sequence[int]) -> str:
        """Lossy-safe decode (tikTokenizer.ts:475-493, TikTokenizer.cs:586-603).

        Unknown ids are silently skipped; invalid UTF-8 becomes U+FFFD
        (TextDecoder non-fatal mode).
        """
        parts: List[bytes] = []
        decoder = self.decoder
        specials = self.special_tokens_decoder
        for tok in tokens:
            bts = decoder.get(tok)
            if bts is None:
                s = specials.get(tok)
                if s is None:
                    continue
                bts = s.encode("utf-8")
            parts.append(bts)
        return b"".join(parts).decode("utf-8", errors="replace")
