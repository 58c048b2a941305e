"""Multi-host job plumbing (SURVEY.md §2.3 collective backend row).

Thin wrappers over ``jax.distributed`` + collectives for multi-process
jobs: initialize the process group, sum small counter vectors across
processes, and gather per-shard metadata.
Bulk token ids never cross hosts (shards are independent; order is
restored by stable shard indices — SURVEY.md §5 multi-host
determinism).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["initialize", "all_sum", "process_info"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize`` with explicit arguments.

    A GPU job names its coordinator (``host:port``), process count and
    this process's id; nothing in the environment supplies them.  No-op
    when running single-process (the common case), so callers can
    invoke it unconditionally.
    """
    import jax

    if num_processes in (None, 1) and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def in_distributed_job() -> bool:
    """True when this process is part of a multi-process job.

    A multi-process GPU job calls :func:`initialize` explicitly, so
    ``jax.distributed.is_initialized()`` is the only signal.  Checked
    WITHOUT touching the jax backend: ``jax.process_count()`` would
    start the runtime, which single-process callers (the common case,
    and anything under the ``TOKENIZER_TPU_NO_DEVICE`` kill switch)
    must never pay for.
    """
    import jax.distributed

    return jax.distributed.is_initialized()


def process_info() -> tuple:
    if not in_distributed_job():
        return 0, 1
    import jax

    return jax.process_index(), jax.process_count()


def all_sum(values: Sequence[float]) -> np.ndarray:
    """Global sum of a small counter vector: every PROCESS counts once.

    Uses ``jax.experimental.multihost_utils.process_allgather``, the
    supported primitive for combining per-process host values (each
    process holds a DIFFERENT vector, so a replicated-spec psum would be
    undefined behavior in multi-process JAX).  The gather rides the job's own collectives; the tiny
    [P, K] result is summed on the host.
    Single-process: returns the input unchanged (no device round trip).
    """
    arr = np.asarray(values, dtype=np.float64)
    if not in_distributed_job():
        return arr  # single process: no backend init, no round trip
    import jax

    if jax.process_count() == 1:
        return arr
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(arr)  # [P, ...]
    return np.asarray(gathered).sum(axis=0)
