"""Prove the device route on NVIDIA GPUs, through the entry points users call.

    python chip_smoke.py             # one card: phases 1-4
    python chip_smoke.py --cards 4   # only the sharded path, on four cards

Phases, one line each; any failure raises and the exit code is non-zero:

1. device  -- the card's name and power limit (nvidia-smi), JAX's devices
   and version, the native scanner loaded; the platform must be ``gpu``.
2. kernel  -- ``merge_packed_jax`` on the gpt2 and cl100k_synth pair tables
   at every packing bucket, B = 2048, equal element for element to the
   ``bpe.py`` oracle; kernel-only seconds, merge-loop trip count, compile
   seconds and ``memory_analysis()``.
3. normal  -- the committed golden ids through ``encode_batch`` and the
   CLI's ``encode-file --tpu``; an 8 MB seeded cold corpus through
   ``encode_batch_stream`` on cl100k_synth with the router as it stands:
   MB/s, the routing counters, full parity with the host engine.
4. forced  -- a fresh tokenizer with every wave above the router's floor
   sent to the device: stream, both bulk trims and ``decode_batch``, all
   with parity; the device must have merged pieces.
5. mesh (``--cards N`` only) -- ``mesh="auto"`` over N cards: the raw
   sharded step (shard layout, psum counters), goldens, stream, trims and
   decode with parity.

The last line of stdout is ``{"ok": true, "device": {...}}``.  The script
sets ``JAX_PLATFORMS=cuda`` itself, so no CPU backend can stand in for
the card.  One process drives the card(s); the host oracle runs in
spawned worker processes that never import JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDENS = {  # encoding -> committed golden id file (tests/testdata)
    "gpt2": "tokens_gpt2.json",
    "r50k_base": "tokens_r50k_base.json",
    "p50k_base": "tokens_p50k_base.json",
    "p50k_edit": "tokens_p50k_edit.json",
}
KERNEL_ENCODINGS = ("gpt2", "cl100k_synth")
CORPUS_ENCODING = "cl100k_synth"
CORPUS_MB = 8.0
CORPUS_SEED = 5
TRIM_BUDGET = 64


class SmokeError(RuntimeError):
    """A phase's check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def report(phase: str, **fields) -> None:
    print(f"[{phase}] ok {json.dumps(fields, sort_keys=True)}", flush=True)


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()


# -- host oracle (worker processes; no JAX) ---------------------------------


def _oracle_chunk(encoding: str, budget: int, docs: list) -> list:
    """(ids, trim-suffix, trim-prefix) per doc from the host engine.

    Each doc is encoded before its trims: the engine's trim text depends
    on its cache state (docs/parity.md), and the bulk trims implement the
    warm-cache behaviour."""
    from tokenizer_tpu import create_by_encoder_name

    host = create_by_encoder_name(encoding, allow_fetch=False)
    out = []
    for d in docs:
        ids = host.encode(d)
        suf = tuple(host.encode_trim_suffix(d, budget))
        pre = tuple(host.encode_trim_prefix(d, budget))
        out.append((ids, suf, pre))
    return out


def host_oracle(encoding: str, docs: list, budget: int = TRIM_BUDGET) -> list:
    """:func:`_oracle_chunk` over ``docs``, spread over spawned workers."""
    workers = min(os.cpu_count() or 1, 16)
    step = max(1, -(-len(docs) // (4 * workers)))
    chunks = [docs[i : i + step] for i in range(0, len(docs), step)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        parts = pool.map(partial(_oracle_chunk, encoding, budget), chunks)
    return [r for part in parts for r in part]


# -- phase 1: device ---------------------------------------------------------


def phase_device(expect_platform: str = "gpu") -> dict:
    """Print the card(s) and the JAX runtime; fail unless the platform is
    ``expect_platform`` and the native scanner loaded."""
    import jax

    from tokenizer_tpu.runtime import native

    smi = _nvidia_smi()
    print(smi, flush=True)
    devs = jax.devices()
    dev = devs[0]
    check(
        dev.platform == expect_platform,
        f"JAX's first device is {dev.platform!r}, not {expect_platform!r}",
    )
    check(native.available(), "native scanner did not build/load")
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}
    report(
        "device",
        nvidia_smi=smi.splitlines(),
        jax_devices=[str(d) for d in devs],
        jax_version=jax.__version__,
        native_loaded=True,
        **device,
    )
    return device


# -- phase 2: kernel ---------------------------------------------------------


def bucket_tile(pieces: list, byte_to_id: np.ndarray, L: int, B: int):
    """Pack ``pieces`` (cycled to B columns) into an [L, B] tile."""
    ids = np.full((L, B), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for c in range(B):
        p = pieces[c % len(pieces)]
        ids[: len(p), c] = byte_to_id[np.frombuffer(p, np.uint8)]
        lengths[c] = len(p)
    return ids, lengths


def expected_tile(pieces: list, encoder: dict, L: int, B: int):
    """The bpe.py oracle's (out_ids, out_n) for :func:`bucket_tile`."""
    from tokenizer_tpu.bpe import byte_pair_encode

    merged = [byte_pair_encode(p, encoder) for p in pieces]
    out = np.full((L, B), -1, np.int32)
    out_n = np.zeros(B, np.int32)
    for c in range(B):
        toks = merged[c % len(pieces)]
        out[: len(toks), c] = toks
        out_n[c] = len(toks)
    return out, out_n


def check_kernel_bucket(vocab, pieces: list, L: int, B: int, repeats: int = 5) -> dict:
    """Compile and run ``merge_packed_jax`` on one bucket tile, compare it
    with the oracle element for element, and time it kernel-only."""
    import jax

    from tokenizer_tpu.ops.merge_jax import device_table, merge_packed_jax

    table = vocab.pair_table()
    unreachable = set(table.unreachable_tokens)
    pieces = [p for p in pieces if p not in unreachable][:B]
    check(bool(pieces), f"no pieces for bucket L={L}")
    ids, lengths = bucket_tile(pieces, table.byte_to_id, L, B)
    want_ids, want_n = expected_tile(pieces, vocab.encoder, L, B)
    tab = device_table(table)
    di, dl = jax.device_put(ids), jax.device_put(lengths)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    t0 = time.perf_counter()
    compiled = merge_packed_jax.lower(tab, di, dl, **kw).compile()
    compile_s = time.perf_counter() - t0
    out_ids, out_n = jax.block_until_ready(compiled(tab, di, dl))
    out_ids, out_n = np.asarray(out_ids), np.asarray(out_n)
    check(np.array_equal(out_n, want_n), f"L={L}: piece lengths differ from the oracle")
    check(np.array_equal(out_ids, want_ids), f"L={L}: ids differ from the oracle")
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(tab, di, dl))
        best = min(best, time.perf_counter() - t0)
    mem = compiled.memory_analysis()
    mem_fields = (
        "argument_size_in_bytes",
        "output_size_in_bytes",
        "temp_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    return {
        "L": L,
        "B": B,
        "unique_pieces": len(pieces),
        "parity": "exact",
        "kernel_s": best,
        "trip_count": int((lengths - out_n).max()),
        "compile_s": compile_s,
        "memory": None
        if mem is None
        else {f: getattr(mem, f, None) for f in mem_fields},
    }


def phase_kernel(
    encodings=KERNEL_ENCODINGS, buckets=None, batch: int = 2048, corpus_mb: float = 0.5
) -> list:
    from bench import bucket_pieces, gen_corpus
    from tokenizer_tpu import create_by_encoder_name

    docs = gen_corpus(corpus_mb, seed=CORPUS_SEED)
    rows = []
    for enc in encodings:
        host = create_by_encoder_name(enc, allow_fetch=False)
        for L, pieces in bucket_pieces(host, docs, buckets).items():
            rows.append({"encoding": enc, **check_kernel_bucket(host.vocab, pieces, L, batch)})
    report("kernel", buckets=rows)
    return rows


# -- phases 3-5: the tokenizer's entry points --------------------------------


def _read_golden(name: str) -> list:
    return json.loads((REPO / "tests" / "testdata" / name).read_text())


def _settle(tok, expect_platform: str, timeout: float = 300.0) -> None:
    """Wait for the channel probe thread to end, then fail on a recorded
    device error or a device route that resolved to another platform."""
    done = getattr(tok, "_probe_thread_done", None)
    if done is not None:
        check(done.wait(timeout), "channel probe did not finish")
    check(tok.device_error is None, f"device route failed: {tok.device_error}")
    check(
        tok.device_platform == expect_platform,
        f"device route resolved to {tok.device_platform!r}",
    )


def check_goldens(expect_platform: str, encodings=tuple(GOLDENS), **tpu_options) -> dict:
    """Golden ids of lib.rs.txt through ``encode_batch`` + decode round trip."""
    from tokenizer_tpu import create_by_encoder_name

    text = (REPO / "tests" / "testdata" / "lib.rs.txt").read_text(encoding="utf-8")
    counts = {}
    for enc in encodings:
        tok = create_by_encoder_name(enc, allow_fetch=False, use_tpu=True, **tpu_options)
        got = tok.encode_batch([text])[0]
        want = _read_golden(GOLDENS[enc])
        check(list(got) == want, f"{enc}: ids differ from the committed golden")
        check(tok.decode_batch([got]) == [text], f"{enc}: decode round trip failed")
        tok._start_channel_probe()
        _settle(tok, expect_platform)
        counts[enc] = len(want)
    return counts


def check_cli_golden() -> int:
    """``python -m tokenizer_tpu.cli encode-file gpt2 lib.rs.txt --tpu``."""
    from tokenizer_tpu import cli

    path = REPO / "tests" / "testdata" / "lib.rs.txt"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["encode-file", "gpt2", str(path), "--tpu"])
    want = len(_read_golden(GOLDENS["gpt2"]))
    check(rc == 0 and f"tokens: {want}" in buf.getvalue(), "CLI encode-file --tpu")
    return want


def run_corpus(tok, docs, oracle, chunk_docs: int = 512) -> dict:
    """Stream ``docs`` through ``tok``; check every id against ``oracle``."""
    chunks = [docs[i : i + chunk_docs] for i in range(0, len(docs), chunk_docs)]
    before = tok.stats.as_dict()
    t0 = time.perf_counter()
    out = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
    seconds = time.perf_counter() - t0
    stats = {k: v - before[k] for k, v in tok.stats.as_dict().items()}
    check(len(out) == len(docs), "stream lost documents")
    for i, (ids, (want, _s, _p)) in enumerate(zip(out, oracle)):
        check(list(ids) == want, f"doc {i}: ids differ from the host engine")
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    return {
        "bytes": nbytes,
        "seconds": seconds,
        "MBps": nbytes / seconds / 1e6,
        "stats": {
            k: stats[k]
            for k in (
                "unique_pieces",
                "device_pieces",
                "device_waves",
                "device_blocking_s",
                "host_wave_pieces",
                "fused_pieces",
                "host_wave_s",
            )
        },
        "ids": out,
    }


def check_trims_decode(tok, docs, oracle, ids) -> dict:
    """Both bulk trims and ``decode_batch`` once each, with parity."""
    suf = tok.encode_trim_suffix_batch(docs, TRIM_BUDGET)
    pre = tok.encode_trim_prefix_batch(docs, TRIM_BUDGET)
    for i, (s, p, (_ids, want_s, want_p)) in enumerate(zip(suf, pre, oracle)):
        check(tuple(s) == want_s, f"doc {i}: trim-suffix differs from the host engine")
        check(tuple(p) == want_p, f"doc {i}: trim-prefix differs from the host engine")
    check(tok.decode_batch(ids) == list(docs), "decode_batch round trip failed")
    return {"trim_suffix": len(suf), "trim_prefix": len(pre), "decode": len(ids)}


def second_pass(tok, docs, oracle) -> dict:
    """The corpus again with both dedup generations dropped: every piece
    is first-seen again, but compiled code and router state are warm."""
    tok._reset_dedup_full()
    res = run_corpus(tok, docs, oracle)
    res.pop("ids")
    return res


def phase_normal(docs, oracle, expect_platform: str = "gpu") -> dict:
    from tokenizer_tpu import create_by_encoder_name

    goldens = check_goldens(expect_platform)
    cli_tokens = check_cli_golden()
    tok = create_by_encoder_name(CORPUS_ENCODING, allow_fetch=False, use_tpu=True)
    res = run_corpus(tok, docs, oracle)
    res.pop("ids")
    res["second_pass"] = second_pass(tok, docs, oracle)
    _settle(tok, expect_platform)
    report("normal", goldens=goldens, cli_tokens=cli_tokens, encoding=CORPUS_ENCODING, **res)
    return res


def phase_forced(docs, oracle, expect_platform: str = "gpu") -> dict:
    from bench import force_device_route
    from tokenizer_tpu import create_by_encoder_name

    tok = create_by_encoder_name(CORPUS_ENCODING, allow_fetch=False, use_tpu=True)
    force_device_route(tok)
    res = run_corpus(tok, docs, oracle)
    check(res["stats"]["device_pieces"] > 0, "forced run merged no piece on the device")
    check(res["stats"]["device_waves"] > 0, "forced run dispatched no device wave")
    ids = res.pop("ids")
    res.update(check_trims_decode(tok, docs, oracle, ids))
    res["second_pass"] = second_pass(tok, docs, oracle)
    _settle(tok, expect_platform)
    report("forced", encoding=CORPUS_ENCODING, **res)
    return res


def phase_mesh(n_cards: int, docs, oracle, expect_platform: str = "gpu") -> dict:
    """The sharded path over every local device, as ``mesh="auto"`` builds it."""
    import jax

    from __graft_entry__ import dryrun_multichip
    from tokenizer_tpu import create_by_encoder_name

    check(
        len(jax.local_devices()) == n_cards,
        f"{len(jax.local_devices())} local devices, expected {n_cards}",
    )
    # Raw sharded step: shard layout and psum counters, plus the
    # production encode/stream/trims/decode on a small mixed batch.
    dryrun_multichip(n_cards)
    goldens = check_goldens(expect_platform)
    tok = create_by_encoder_name(CORPUS_ENCODING, allow_fetch=False, use_tpu=True)
    res = run_corpus(tok, docs, oracle)
    check(tok.mesh is not None and tok.mesh.size == n_cards, "corpus did not run on the mesh")
    check(res["stats"]["device_pieces"] > 0, "mesh run merged no piece on the device")
    ids = res.pop("ids")
    res.update(check_trims_decode(tok, docs, oracle, ids))
    _settle(tok, expect_platform)
    report("mesh", cards=n_cards, goldens=goldens, encoding=CORPUS_ENCODING, **res)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--cards", type=int, default=1, help="run only the sharded path on this many cards"
    )
    args = parser.parse_args(argv)
    # Before JAX starts: only the CUDA backend, so no CPU can stand in.
    os.environ["JAX_PLATFORMS"] = "cuda"
    sys.path.insert(0, str(REPO))
    from bench import gen_corpus

    device = phase_device()
    docs = gen_corpus(CORPUS_MB, seed=CORPUS_SEED)
    oracle = host_oracle(CORPUS_ENCODING, docs)
    if args.cards > 1:
        phase_mesh(args.cards, docs, oracle)
    else:
        phase_kernel()
        phase_normal(docs, oracle)
        phase_forced(docs, oracle)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
