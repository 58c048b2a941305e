"""The main path needs no third-party ``regex`` package.

The registry's patterns pre-split through the native scanner and the
special-token alternation compiles with stdlib ``re``; ``regex`` is
imported only for a custom pattern or a host without the scanner.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import find_testdata, require_vocab

REPO = Path(__file__).resolve().parent.parent
GOLDENS = [
    ("gpt2", "tokens_gpt2.json"),
    ("r50k_base", "tokens_r50k_base.json"),
    ("p50k_base", "tokens_p50k_base.json"),
    ("p50k_edit", "tokens_p50k_edit.json"),
]


@pytest.fixture
def no_regex(monkeypatch):
    """Make ``import regex`` raise ImportError."""
    monkeypatch.setitem(sys.modules, "regex", None)


@pytest.mark.parametrize("encoding,golden", GOLDENS)
def test_goldens_without_regex(no_regex, encoding, golden, lib_rs_text):
    require_vocab(encoding)
    from tokenizer_tpu import create_by_encoder_name

    want = json.loads(find_testdata(golden).read_text())
    tpu = create_by_encoder_name(encoding, allow_fetch=False, use_tpu=True)
    (ids,) = tpu.encode_batch([lib_rs_text])
    assert list(ids) == want
    host = create_by_encoder_name(encoding, allow_fetch=False)
    assert host.encode(lib_rs_text) == want
    assert host.encode_trim_suffix(lib_rs_text, 100).token_ids == want[:100]


def test_import_without_regex():
    """A fresh interpreter with ``regex`` blocked imports the package and
    encodes through the device tokenizer."""
    code = (
        "import sys; sys.modules['regex'] = None\n"
        "import tokenizer_tpu as tt\n"
        "tok = tt.create_by_encoder_name('gpt2', allow_fetch=False, use_tpu=True)\n"
        "print(tok.encode_batch(['Hello World'])[0].tolist())\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[15496, 2159]"


def test_custom_pattern_without_regex_says_why(no_regex, gpt2_vocab):
    from tokenizer_tpu import TikTokenizer

    with pytest.raises(ImportError, match="'regex' package"):
        TikTokenizer(gpt2_vocab, {}, r"\p{L}+|\s+")


def test_regex_fallback_matches_native(monkeypatch, lib_rs_text):
    """The host engine splits with ``regex`` where it is installed and
    with the native scanner where it is not; both give the same pieces,
    and the ``regex`` side never calls the scanner."""
    pytest.importorskip("regex")
    from tokenizer_tpu import engine
    from tokenizer_tpu.models.registry import (
        REGEX_PATTERN_1,
        REGEX_PATTERN_2,
        REGEX_PATTERN_3,
    )
    from tokenizer_tpu.runtime import native

    text = lib_rs_text + " naïve\r\n 東京 \ud800x 123456 \U0001f600!!"
    for pattern in (REGEX_PATTERN_1, REGEX_PATTERN_2, REGEX_PATTERN_3):
        monkeypatch.setattr(native, "split_text", None)
        want = list(engine._piece_splitter(pattern)(text, 3, len(text)))
        monkeypatch.undo()
        monkeypatch.setitem(sys.modules, "regex", None)
        got = list(engine._piece_splitter(pattern)(text, 3, len(text)))
        monkeypatch.undo()
        assert got == want
