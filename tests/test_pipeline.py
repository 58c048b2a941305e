"""Corpus pipeline: chunking, sharding, resume, and bulk decode."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

from conftest import has_vocab

from tokenizer_tpu.runtime.pipeline import (
    ShardProgress,
    encode_corpus,
    iter_corpus_files,
)

pytestmark = pytest.mark.skipif(
    not has_vocab("gpt2"), reason="gpt2 rank file not available offline"
)


@pytest.fixture(scope="module")
def tok():
    from tokenizer_tpu import create_by_encoder_name

    return create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=True)


DOCS = [f"document {i}: the quick brown fox {i * 37}! " * 20 for i in range(23)]


def _read_all(out_dir, shard, n_chunks):
    ids = []
    for ci in range(n_chunks):
        z = np.load(out_dir / f"tokens_s{shard:05d}_c{ci:06d}.npz")
        offs = z["offsets"]
        flat = z["ids"]
        for d in range(len(offs) - 1):
            ids.append(list(flat[offs[d] : offs[d + 1]]))
    return ids


def test_single_shard_matches_encode(tok, tmp_path):
    prog = encode_corpus(
        DOCS, tok, tmp_path, chunk_bytes=2000, shard=0, n_shards=1
    )
    assert prog.docs == len(DOCS)
    assert prog.tokens_out > 0
    got = _read_all(tmp_path, 0, prog.chunks_done)
    want = [list(x) for x in tok.encode_batch(DOCS)]
    assert got == want


def test_resume_skips_completed_chunks(tok, tmp_path):
    p1 = encode_corpus(
        DOCS, tok, tmp_path, chunk_bytes=2000, shard=0, n_shards=1
    )
    before = json.loads(
        (tmp_path / "manifest_shard00000.json").read_text()
    )
    # Second run: everything already durable -> counters unchanged.
    p2 = encode_corpus(
        DOCS, tok, tmp_path, chunk_bytes=2000, shard=0, n_shards=1
    )
    assert p2.chunks_done == p1.chunks_done
    assert p2.tokens_out == before["tokens_out"]


def test_partial_resume(tok, tmp_path):
    prog = encode_corpus(
        DOCS, tok, tmp_path, chunk_bytes=2000, shard=0, n_shards=1
    )
    full_tokens = prog.tokens_out
    # Rewind the manifest by two chunks: only those should re-run.
    m = tmp_path / "manifest_shard00000.json"
    state = json.loads(m.read_text())
    state["chunks_done"] -= 2
    m.write_text(json.dumps(state))
    p2 = encode_corpus(
        DOCS, tok, tmp_path, chunk_bytes=2000, shard=0, n_shards=1
    )
    assert p2.chunks_done == prog.chunks_done
    got = _read_all(tmp_path, 0, p2.chunks_done)
    want = [list(x) for x in tok.encode_batch(DOCS)]
    assert got == want
    assert full_tokens > 0


def test_two_shards_interleave_and_cover(tok, tmp_path):
    p0 = encode_corpus(
        DOCS, tok, tmp_path, chunk_bytes=1500, shard=0, n_shards=2
    )
    p1 = encode_corpus(
        DOCS, tok, tmp_path, chunk_bytes=1500, shard=1, n_shards=2
    )
    assert p0.docs + p1.docs == len(DOCS)
    got0 = _read_all(tmp_path, 0, p0.chunks_done)
    got1 = _read_all(tmp_path, 1, p1.chunks_done)
    want = [list(x) for x in tok.encode_batch(DOCS)]
    # Order restored by stable (shard, position) interleave.
    assert got0 == want[0::2]
    assert got1 == want[1::2]


def test_shard_mismatch_rejected(tok, tmp_path):
    encode_corpus(DOCS, tok, tmp_path, chunk_bytes=1500, shard=0, n_shards=2)
    with pytest.raises(ValueError, match="was written for shard"):
        encode_corpus(
            DOCS, tok, tmp_path, chunk_bytes=1500, shard=0, n_shards=4
        )


def test_iter_corpus_files(tmp_path):
    (tmp_path / "a.txt").write_text("alpha")
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "b.txt").write_text("beta")
    docs = list(iter_corpus_files([str(tmp_path)]))
    assert docs == ["alpha", "beta"]


def test_iter_corpus_files_unreadable_fails_loud(tmp_path):
    """A vanished/unreadable file must raise, not silently skip.

    Documents map to shards positionally (k % n_shards), so a silent
    skip would re-align every later document's shard assignment.
    """
    (tmp_path / "a.txt").write_text("alpha")
    gone = tmp_path / "b.txt"
    gone.write_text("beta")
    (tmp_path / "c.txt").write_text("gamma")

    def _iter_with_vanish():
        it = iter_corpus_files([str(tmp_path)])
        yield next(it)  # "alpha"
        gone.unlink()  # simulate the file vanishing mid-walk
        yield from it

    with pytest.raises(OSError, match="unreadable corpus file"):
        list(_iter_with_vanish())

    # Opt-in skipping invokes the callback with path + exception.
    gone.write_text("beta")
    skipped = []

    def _vanish_then_collect():
        it = iter_corpus_files(
            [str(tmp_path)], on_skip=lambda p, e: skipped.append(str(p))
        )
        yield next(it)
        gone.unlink()
        yield from it

    docs = list(_vanish_then_collect())
    assert docs == ["alpha", "gamma"]
    assert skipped == [str(gone)]


def test_all_sum_counters():
    from tokenizer_tpu.parallel.multihost import all_sum

    out = all_sum([3.0, 5.0])
    assert list(out) == [3.0, 5.0]


def test_bulk_decode_matches_host(tok):
    from tokenizer_tpu import create_by_encoder_name

    host = create_by_encoder_name("gpt2", allow_fetch=False)
    text = ("bulk decode ⭐ parity 123! " * 40) + "<|endoftext|>"
    ids = host.encode(text, allowed_special=["<|endoftext|>"])
    assert len(ids) >= 64  # exercises the native gather path
    assert tok.decode(ids) == host.decode(ids) == text
    # Unknown ids are skipped identically.
    weird = ids + [987654, -3]
    assert tok.decode(weird) == host.decode(weird)


def test_decode_batch_single_gather(tok):
    """decode_batch == per-text decode, through the flattened gather.

    Includes empty texts, unknown ids, and a lone continuation-byte id
    at a text boundary: U+FFFD replacement must stay per-text."""
    from tokenizer_tpu import create_by_encoder_name

    host = create_by_encoder_name("gpt2", allow_fetch=False)
    texts = [
        "bulk decode ⭐ parity 123! " * 12,
        "",
        "second doc's ids — unicode ✓ and bytes",
        "third " * 50,
    ]
    batch = [host.encode(t) for t in texts]
    batch[0] = batch[0] + [987654]  # unknown id skipped
    # id 447 in gpt2 is a mid-sequence byte piece; appending a bare
    # continuation byte token makes trailing invalid UTF-8.
    bad = host.encode("⭐")[:1]  # first id of a multi-byte char
    batch.insert(2, bad)
    want = [host.decode(ids) for ids in batch]
    got = tok.decode_batch(batch)
    assert got == want
    # Small total falls back to the per-text path; equality still holds.
    small = [[ids[0]] for ids in batch if ids]
    assert tok.decode_batch(small) == [host.decode(i) for i in small]

def test_all_sum_multiprocess_contract(monkeypatch):
    """Shape of the multi-process path: per-process vectors gather to
    [P, K] and sum across P (exercised single-process via monkeypatch;
    the real gather is jax.experimental.multihost_utils.process_allgather)."""
    import jax
    import numpy as np

    import tokenizer_tpu.parallel.multihost as mh
    from jax.experimental import multihost_utils

    monkeypatch.setattr(mh, "in_distributed_job", lambda: True)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(
        multihost_utils,
        "process_allgather",
        lambda arr: np.stack([arr, arr * 2, arr * 3]),
    )
    out = mh.all_sum([3.0, 5.0])
    assert out.tolist() == [18.0, 30.0]


def test_resume_rejects_mutated_corpus(tmp_path, tok):
    """A corpus that changed between runs fails loudly on resume."""
    import pytest

    from tokenizer_tpu.runtime.pipeline import encode_corpus

    docs = [f"document number {i} with words" for i in range(40)]
    encode_corpus(docs, tok, tmp_path, chunk_bytes=200)
    # Unchanged corpus resumes cleanly (no-op).
    p = encode_corpus(docs, tok, tmp_path, chunk_bytes=200)
    assert p.chunks_done > 1
    # Mutate an early document -> loud failure.
    docs[1] = "document number 1 MUTATED"
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        encode_corpus(docs, tok, tmp_path, chunk_bytes=200)


def test_corpus_no_bulk_tokenizer_fallback(tmp_path):
    """encode_corpus works with the plain host engine (corpus --no-tpu)."""
    from tokenizer_tpu import create_by_encoder_name
    from tokenizer_tpu.runtime.pipeline import encode_corpus

    host = create_by_encoder_name("gpt2", allow_fetch=False)
    docs = [f"plain host document {i}" for i in range(10)]
    p = encode_corpus(docs, host, tmp_path, chunk_bytes=100)
    assert p.tokens_out > 0 and p.chunks_done >= 1


def test_resume_tolerates_legacy_manifest_without_digests(tmp_path, tok):
    """A manifest predating the digest sidecar resumes cleanly and does
    not poison later resumes with empty-string digests."""
    import json

    from tokenizer_tpu.runtime.pipeline import encode_corpus

    docs = [f"legacy doc {i} words" for i in range(30)]
    encode_corpus(docs, tok, tmp_path, chunk_bytes=150)
    m = tmp_path / "manifest_shard00000.json"
    # Simulate a legacy layout: drop the sidecar entirely.
    (tmp_path / "manifest_shard00000.digests").unlink()
    p1 = encode_corpus(docs, tok, tmp_path, chunk_bytes=150)  # resume ok
    p2 = encode_corpus(docs, tok, tmp_path, chunk_bytes=150)  # and again
    assert p1.chunks_done == p2.chunks_done
    assert json.loads(m.read_text())["chunks_done"] == p2.chunks_done
