"""Trace merge_packed_jax on the device and summarise what one call runs.

    python tools/trace_wave.py [--encoding cl100k_synth] [--L 64] [--B 2048]
                               [--calls 3] [--out traces/trace_wave]

Compiles the merge kernel for one packing bucket, warms it, and records
``--calls`` block_until_ready-fenced calls under ``jax.profiler.trace``.
Prints one JSON object: the merge-loop trip count and, per trace plane
and line, each event name's count and total device/host time, so a
reader can see how many kernel launches and host<->device copies one
``lax.while_loop`` iteration costs.  The raw trace stays under ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def summarise(xplane: str, top: int = 25) -> dict:
    """{plane: {line: [[event, count, total_ms], ...]}} for a trace file."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xplane).planes:
        lines = {}
        for line in plane.lines:
            agg = collections.defaultdict(lambda: [0, 0.0])
            for ev in line.events:
                agg[ev.name][0] += 1
                agg[ev.name][1] += ev.duration_ns / 1e6
            if agg:
                rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
                lines[line.name] = [[k, c, ms] for k, (c, ms) in rows]
        if lines:
            out[plane.name] = lines
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--encoding", default="cl100k_synth")
    ap.add_argument("--L", type=int, default=64)
    ap.add_argument("--B", type=int, default=2048)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out", default=str(REPO / "traces" / "trace_wave"))
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    from bench import bucket_pieces, gen_corpus
    from chip_smoke import CORPUS_SEED, bucket_tile
    from tokenizer_tpu import create_by_encoder_name
    from tokenizer_tpu.ops.merge_jax import device_table, merge_packed_jax

    host = create_by_encoder_name(args.encoding, allow_fetch=False)
    table = host.vocab.pair_table()
    # The same tile as chip_smoke.py's kernel phase for this bucket.
    pieces = bucket_pieces(host, gen_corpus(0.5, seed=CORPUS_SEED))[args.L][: args.B]
    ids, lengths = bucket_tile(pieces, table.byte_to_id, args.L, args.B)
    tab = device_table(table)
    di, dl = jax.device_put(ids), jax.device_put(lengths)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    compiled = merge_packed_jax.lower(tab, di, dl, **kw).compile()
    _, out_n = jax.block_until_ready(compiled(tab, di, dl))
    trips = int((lengths - np.asarray(out_n)).max())
    Path(args.out).mkdir(parents=True, exist_ok=True)
    with jax.profiler.trace(args.out):
        t0 = time.perf_counter()
        for _ in range(args.calls):
            jax.block_until_ready(compiled(tab, di, dl))
        wall = time.perf_counter() - t0
    xplanes = sorted(glob.glob(f"{args.out}/**/*.xplane.pb", recursive=True))
    print(
        json.dumps(
            {
                "device": str(jax.devices()[0]),
                "kind": jax.devices()[0].device_kind,
                "encoding": args.encoding,
                "tile": [args.L, args.B],
                "calls": args.calls,
                "trip_count": trips,
                "traced_wall_s": wall,
                "trace": summarise(xplanes[-1]),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
