"""CPU rehearsal of chip_smoke.py at a tiny size.

The script's phases run here on the virtual CPU mesh with the platform
check pointed at ``cpu``; the script itself must refuse, without printing
``ok``, on a machine with no GPU.  The real run (``python chip_smoke.py``)
needs an NVIDIA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs
from conftest import require_vocab

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def fake_smi(monkeypatch):
    monkeypatch.setattr(cs, "_nvidia_smi", lambda: "FAKE CARD, 1.00 W")


@pytest.fixture(scope="module")
def corpus():
    require_vocab(cs.CORPUS_ENCODING)
    from bench import gen_corpus

    docs = gen_corpus(0.05, seed=cs.CORPUS_SEED)
    return docs, cs._oracle_chunk(cs.CORPUS_ENCODING, cs.TRIM_BUDGET, docs)


def test_script_fails_without_gpu():
    """No accelerator: non-zero exit and no result line."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=str(REPO),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_device_refuses_cpu(fake_smi):
    with pytest.raises(cs.SmokeError, match="not 'gpu'"):
        cs.phase_device()


def test_phase_device_rehearsal(fake_smi, capsys):
    device = cs.phase_device(expect_platform="cpu")
    assert device["platform"] == "cpu" and device["count"] == 8
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "FAKE CARD, 1.00 W"
    assert out[1].startswith("[device] ok ")


def test_phase_kernel_rehearsal(capsys):
    require_vocab("gpt2")
    rows = cs.phase_kernel(
        encodings=("gpt2",), buckets=(16, 64), batch=128, corpus_mb=0.05
    )
    assert [r["L"] for r in rows] == [16, 64]
    assert all(r["parity"] == "exact" for r in rows)
    assert capsys.readouterr().out.startswith("[kernel] ok ")


def test_phases_normal_and_forced_rehearsal(corpus, capsys):
    docs, oracle = corpus
    normal = cs.phase_normal(docs, oracle, expect_platform="cpu")
    assert normal["bytes"] > 0
    forced = cs.phase_forced(docs, oracle, expect_platform="cpu")
    assert forced["stats"]["device_pieces"] > 0
    assert forced["decode"] == len(docs)
    lines = capsys.readouterr().out.splitlines()
    assert [l.split()[0] for l in lines] == ["[normal]", "[forced]"]


def test_phase_mesh_rehearsal(corpus, capsys):
    """The ``--cards N`` phase on the 8-device virtual mesh."""
    docs, oracle = corpus
    res = cs.phase_mesh(8, docs, oracle, expect_platform="cpu")
    assert res["stats"]["device_pieces"] > 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("[mesh] ok ")


def test_forced_parity_check_catches_a_wrong_id(corpus):
    """The corpus check really compares: one wrong oracle id fails it."""
    docs, oracle = corpus
    from tokenizer_tpu import create_by_encoder_name

    bad = list(oracle)
    ids, suf, pre = bad[0]
    bad[0] = ([ids[0] + 1] + ids[1:], suf, pre)
    tok = create_by_encoder_name(
        cs.CORPUS_ENCODING, allow_fetch=False, use_tpu=True
    )
    with pytest.raises(cs.SmokeError, match="doc 0"):
        cs.run_corpus(tok, docs, bad)
