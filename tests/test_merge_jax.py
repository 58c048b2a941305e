"""The XLA merge kernel against its oracles.

``lookup_pairs`` must equal the host ``PairTable.lookup`` probe for probe,
and ``merge_packed_jax`` must equal the ``bpe.py`` merge loop element for
element at every packing bucket, on a real-vocabulary pair table of each
size class.  The CPU cases run a narrow tile; the ``gpu`` case runs the
full B = 2048 tile on the card.
"""

from __future__ import annotations

import numpy as np
import pytest

from conftest import require_vocab
from tokenizer_tpu.ops.packing import BUCKETS


@pytest.fixture(scope="module")
def table():
    require_vocab("gpt2")
    from tokenizer_tpu.vocab import Vocabulary

    return Vocabulary.for_encoding("gpt2", allow_fetch=False).pair_table()


@pytest.fixture(scope="module")
def probes(table):
    """A probe set mixing real pairs (hits), random pairs (mostly
    misses), and invalid (-1) lanes — [8, 128]."""
    rng = np.random.default_rng(42)
    n = 8 * 128
    filled = np.nonzero(table.key_left != -1)[0]
    pick = rng.choice(filled, size=n // 2)
    left = np.empty(n, np.int32)
    right = np.empty(n, np.int32)
    left[: n // 2] = table.key_left[pick]
    right[: n // 2] = table.key_right[pick]
    left[n // 2 :] = rng.integers(0, 50000, n // 2)
    right[n // 2 :] = rng.integers(0, 50000, n // 2)
    left[::37] = -1  # invalid lanes
    return left.reshape(8, 128), right.reshape(8, 128)


def _oracle(table, left, right):
    from tokenizer_tpu.ops.pair_table import MAX_RANK

    out = np.full(left.shape, MAX_RANK, np.int32)
    for idx in np.ndindex(left.shape):
        l, r = int(left[idx]), int(right[idx])
        if l < 0 or r < 0:
            continue
        v = table.lookup(l, r)
        if v is not None:
            out[idx] = v
    return out


def test_xla_baseline_parity(table, probes):
    from tokenizer_tpu.ops.merge_jax import device_table, lookup_pairs

    left, right = probes
    got = np.asarray(
        lookup_pairs(
            device_table(table),
            table.slot_bits,
            table.max_probes,
            left,
            right,
        )
    )
    want = _oracle(table, left, right)
    assert np.array_equal(got, want)


_PIECES: dict = {}


def _bucket_case(encoding: str):
    """(vocab, {L: pieces}) for ``encoding``, built once per module."""
    require_vocab(encoding)
    if encoding not in _PIECES:
        from bench import bucket_pieces, gen_corpus
        from tokenizer_tpu import create_by_encoder_name

        host = create_by_encoder_name(encoding, allow_fetch=False)
        docs = gen_corpus(0.05, seed=3)
        _PIECES[encoding] = (host.vocab, bucket_pieces(host, docs))
    return _PIECES[encoding]


@pytest.mark.parametrize("L", BUCKETS)
@pytest.mark.parametrize("encoding", ["gpt2", "cl100k_synth"])
def test_merge_packed_matches_oracle(encoding, L):
    from chip_smoke import check_kernel_bucket

    vocab, by_bucket = _bucket_case(encoding)
    res = check_kernel_bucket(vocab, by_bucket[L], L, B=128, repeats=1)
    assert res["parity"] == "exact"
    assert 0 <= res["trip_count"] <= L - 1


@pytest.mark.gpu
@pytest.mark.parametrize("encoding", ["gpt2", "cl100k_synth"])
def test_merge_packed_on_gpu(gpu_device, encoding):
    from chip_smoke import check_kernel_bucket

    vocab, by_bucket = _bucket_case(encoding)
    for L in BUCKETS:
        res = check_kernel_bucket(vocab, by_bucket[L], L, B=2048, repeats=1)
        assert res["parity"] == "exact"
