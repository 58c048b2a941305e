"""REAL two-process `all_sum` integration.

Spawns two OS processes that `jax.distributed.initialize` against a
local coordinator on the CPU backend and asserts `all_sum` returns the
cross-process sum — the multi-process contract exercised for real, not
just via the mocked single-process test (tests/test_pipeline.py).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import json, os, sys
sys.path.insert(0, "@REPO@")
from tokenizer_tpu.parallel import multihost

pid = int(sys.argv[1])
multihost.initialize(
    coordinator_address=sys.argv[2], num_processes=2, process_id=pid
)
idx, count = multihost.process_info()
assert count == 2 and idx == pid, (idx, count, pid)
# Each process contributes a DIFFERENT counter vector.
out = multihost.all_sum([10.0 * (pid + 1), 3.0 + pid])
print("RESULT " + json.dumps({"pid": pid, "sum": list(map(float, out))}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(worker: str, extra_args, timeout: float, attempts: int = 2):
    """Launch the 2-rank job, returning {pid: RESULT dict}.

    The free-port probe is inherently TOCTOU (the coordinator rebinds it
    after we close), and distributed init can also miss its barrier when
    the host is briefly oversubscribed mid-suite — so one retry with a
    fresh port before declaring failure.
    """
    last_err = ""
    for attempt in range(attempts):
        extra = extra_args(attempt) if callable(extra_args) else extra_args
        coord = f"127.0.0.1:{_free_port()}"
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", worker, str(pid), coord, *extra],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                env=env,
                cwd=str(REPO),
            )
            for pid in (0, 1)
        ]
        results, ok = {}, True
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    ok = False
                    last_err = err[-2000:]
                    continue
                for line in out.splitlines():
                    if line.startswith("RESULT "):
                        rec = json.loads(line[len("RESULT ") :])
                        results[rec["pid"]] = rec
        except subprocess.TimeoutExpired:
            ok, last_err = False, "worker pair timed out"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if ok and set(results) == {0, 1}:
            return results, extra
    raise AssertionError(f"worker pair failed twice; last stderr:\n{last_err}")


def test_two_process_all_sum(tmp_path):
    worker = _WORKER.replace("@REPO@", str(REPO))
    results, _ = _run_pair(worker, [], timeout=150)
    # 10*(0+1)+10*(1+1)=30 ; (3+0)+(3+1)=7 — identical on both ranks.
    assert {p: r["sum"] for p, r in results.items()} == {
        0: [30.0, 7.0],
        1: [30.0, 7.0],
    }


_ENCODE_WORKER = r"""
import json, os, sys
sys.path.insert(0, "@REPO@")
from tokenizer_tpu.parallel import multihost

pid = int(sys.argv[1])
out_dir = sys.argv[3]
multihost.initialize(
    coordinator_address=sys.argv[2], num_processes=2, process_id=pid
)
from tokenizer_tpu import create_by_encoder_name
from tokenizer_tpu.runtime.pipeline import encode_corpus

docs = [f"doc {i}: the quick brown fox {i*13} jumps ⭐ {'好'*(i%7)}" for i in range(40)]
tok = create_by_encoder_name("gpt2", allow_fetch=False, use_tpu=True)
progress = encode_corpus(
    iter(docs), tok, out_dir, chunk_bytes=400, shard=pid, n_shards=2
)
totals = multihost.all_sum(
    [progress.docs, progress.bytes_in, progress.tokens_out]
)
print("RESULT " + json.dumps({
    "pid": pid,
    "docs": progress.docs,
    "tokens": progress.tokens_out,
    "global": list(map(float, totals)),
}), flush=True)
"""


def test_two_process_distributed_encode(tmp_path):
    """The full multi-host contract end-to-end: two REAL processes in
    one jax.distributed job each encode their corpus shard through the
    production pipeline, psum/allgather their counters, and the merged
    shard outputs reconstruct the host-oracle encoding of every doc."""
    import glob

    import numpy as np

    worker = _ENCODE_WORKER.replace("@REPO@", str(REPO))
    # Fresh output dir per attempt so a failed try can't leave partial
    # shard files in the one the merge check reads.
    results, (out_dir,) = _run_pair(
        worker, lambda a: [str(tmp_path / f"try{a}")], timeout=240
    )
    out_dir = Path(out_dir)
    # Cross-process counter sums agree on both ranks.
    assert results[0]["global"] == results[1]["global"]
    assert results[0]["docs"] + results[1]["docs"] == 40

    # Merge shard outputs back into document order and compare with the
    # host oracle (shard k holds docs k, k+2, k+4, ... — stable indices).
    from tokenizer_tpu import create_by_encoder_name

    docs = [
        f"doc {i}: the quick brown fox {i*13} jumps ⭐ {'好'*(i%7)}"
        for i in range(40)
    ]
    host = create_by_encoder_name("gpt2", allow_fetch=False)
    per_shard = {0: [], 1: []}
    for shard in (0, 1):
        for f in sorted(
            glob.glob(str(out_dir / f"tokens_s{shard:05d}_c*.npz"))
        ):
            z = np.load(f)
            ids, offs = z["ids"], z["offsets"]
            for k in range(len(offs) - 1):
                per_shard[shard].append(ids[offs[k] : offs[k + 1]])
    merged = {}
    for shard in (0, 1):
        for j, ids in enumerate(per_shard[shard]):
            merged[shard + 2 * j] = ids
    assert len(merged) == 40
    for i, d in enumerate(docs):
        assert list(merged[i]) == host.encode(d), i
