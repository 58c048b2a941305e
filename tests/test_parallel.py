"""Data-parallel sharding on the virtual 8-device CPU mesh (SURVEY.md §4).

Validates: shard_map'd merge over a 1-D ("data",) mesh matches the
single-device kernel bit-for-bit, counters psum-reduce correctly, and
outputs reassemble in stable shard order.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tokenizer_tpu.ops.merge_numpy import merge_packed_numpy
from tokenizer_tpu.ops.pair_table import PairTable
from tokenizer_tpu.vocab import Vocabulary


@pytest.fixture(scope="module")
def toy_table():
    enc = {bytes([b]): b for b in range(256)}
    for i, tok in enumerate([b"ab", b"cd", b"ef", b"abcd", b"cdef", b"abc"]):
        enc[tok] = 256 + i
    v = Vocabulary(enc, name="toy")
    return v, PairTable.build(v, verify_closure=False)


def _pack(pieces, table, L=16, B=None):
    B = B or -(-len(pieces) // 128) * 128
    ids = np.full((L, B), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for c, p in enumerate(pieces):
        ids[: len(p), c] = table.byte_to_id[np.frombuffer(p, np.uint8)]
        lengths[c] = len(p)
    return ids, lengths


def test_eight_device_mesh_available():
    assert len(jax.devices()) >= 8, (
        "conftest must provide 8 virtual CPU devices"
    )


def test_sharded_merge_matches_single_device(toy_table):
    vocab, table = toy_table
    from tokenizer_tpu.parallel import data_mesh, make_sharded_merge_fn
    from tokenizer_tpu.ops.merge_jax import device_table

    mesh = data_mesh(8)
    fn = make_sharded_merge_fn(table, mesh)
    tab = device_table(table)

    rng = np.random.default_rng(3)
    pieces = [
        rng.integers(ord("a"), ord("g"), size=rng.integers(2, 9))
        .astype(np.uint8)
        .tobytes()
        for _ in range(1024)
    ]
    ids, lengths = _pack(pieces, table, B=1024)
    out_ids, out_n, counters = fn(tab, ids, lengths)
    out_ids, out_n = np.asarray(out_ids), np.asarray(out_n)

    ref_ids, ref_n = merge_packed_numpy(ids, lengths, table)
    assert (out_n == ref_n).all()
    for c in range(1024):
        assert (out_ids[: out_n[c], c] == ref_ids[: ref_n[c], c]).all()

    # psum'd counters: global tokens and pieces, identical on all shards.
    assert counters[0] == ref_n.sum()
    assert counters[1] == (lengths > 0).sum() == 1024


def test_sharded_output_sharding_layout(toy_table):
    _, table = toy_table
    from tokenizer_tpu.parallel import data_mesh, make_sharded_merge_fn
    from tokenizer_tpu.ops.merge_jax import device_table

    mesh = data_mesh(8)
    fn = make_sharded_merge_fn(table, mesh)
    ids, lengths = _pack([b"ab"] * 256, table, B=256)
    out_ids, out_n, _ = fn(device_table(table), ids, lengths)
    # Output stays sharded over ("data",) on the batch dim.
    spec = out_ids.sharding.spec
    assert tuple(spec) == (None, "data")
    assert tuple(out_n.sharding.spec) == ("data",)


def test_mesh_divisibility_check():
    from tokenizer_tpu.parallel import data_mesh, local_batch_size

    mesh = data_mesh(8)
    assert local_batch_size(1024, mesh) == 128
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(1001, mesh)


# -- production encode path over the mesh -----------------------------------


@pytest.fixture(scope="module")
def gpt2_specs():
    from conftest import require_vocab

    require_vocab("gpt2")
    from tokenizer_tpu.models.registry import get_encoding_spec

    spec = get_encoding_spec("gpt2")
    v = Vocabulary.for_encoding("gpt2", allow_fetch=False)
    return v, spec


def test_encode_batch_shards_real_vocab(gpt2_specs, lib_rs_text):
    """encode_batch routes merges through the 8-device mesh and matches
    the host oracle byte-for-byte on the real gpt2 table."""
    from tokenizer_tpu.engine import TikTokenizer
    from tokenizer_tpu.parallel import data_mesh
    from tokenizer_tpu.tpu import TpuTokenizer

    vocab, spec = gpt2_specs
    mesh = data_mesh(8)
    tok = TpuTokenizer(vocab, spec.special_tokens, spec.pattern, mesh=mesh)
    host = TikTokenizer(vocab, spec.special_tokens, spec.pattern)

    texts = [lib_rs_text[:4000], lib_rs_text[4000:9000], "⭐ étoile  123"]
    got = tok.encode_batch(texts)
    for g, t in zip(got, texts):
        assert list(g) == host.encode(t)
    assert tok.mesh is mesh
    assert tok.stats.device_pieces > 0
    # Mesh-quantized tiles: every device batch is a multiple of 8*128.
    assert tok._b_quantum == 8 * 128


def test_encode_batch_auto_mesh_detection(gpt2_specs):
    """mesh="auto" picks up the virtual multi-device environment."""
    from tokenizer_tpu.tpu import TpuTokenizer

    vocab, spec = gpt2_specs
    tok = TpuTokenizer(vocab, spec.special_tokens, spec.pattern)
    (ids,) = tok.encode_batch(["hello sharded world"])
    assert tok.mesh is not None and tok.mesh.size == len(jax.devices())
    assert ids.size > 0


def test_encode_batch_mesh_none_single_device(gpt2_specs):
    from tokenizer_tpu.tpu import TpuTokenizer

    vocab, spec = gpt2_specs
    tok = TpuTokenizer(vocab, spec.special_tokens, spec.pattern, mesh=None)
    (ids,) = tok.encode_batch(["hello single device"])
    assert tok.mesh is None
    assert tok._b_quantum == 128


def test_mesh_wave_fusion_multi_tile(gpt2_specs):
    """A wave spanning several buckets runs as ONE fused jit dispatch
    on the sharded path with exact parity."""
    from tokenizer_tpu.engine import TikTokenizer
    from tokenizer_tpu.parallel.mesh import data_mesh
    from tokenizer_tpu.tpu import TpuTokenizer

    vocab, spec = gpt2_specs
    mesh = data_mesh()
    tok = TpuTokenizer(vocab, spec.special_tokens, spec.pattern, mesh=mesh)
    host = TikTokenizer(vocab, spec.special_tokens, spec.pattern)
    # Pieces in three length classes -> >= 2 tiles in one wave: short
    # words (16-bucket), ~40-byte runs (64-bucket), ~150-byte CJK runs
    # (256-bucket).
    words = " ".join(f"w{i}xq" for i in range(200))
    runs = " ".join("a" * (30 + i % 20) for i in range(40))
    cjk = " ".join("好" * 50 for _ in range(8))
    text = " ".join([words, runs, cjk])
    got = tok.encode_batch([text])
    assert list(got[0]) == host.encode(text)
    assert tok.stats.device_pieces > 0
    assert any(
        len(shapes) >= 2 for shapes in tok._mesh_wave_fns
    ), "no multi-tile mesh wave was fused"
