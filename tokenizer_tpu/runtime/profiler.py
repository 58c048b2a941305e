"""Profiling/observability: the JAX-profiler replacement for the
reference's V8 CPU profiles and BenchmarkDotNet (SURVEY.md §5).

* :func:`trace` — context manager around ``jax.profiler.trace``; writes
  an XPlane/Perfetto trace viewable in TensorBoard or ui.perfetto.dev
  (the role `profile.cpuprofile` plays in benchmark-folder.js:38-62).
* :class:`ThroughputMeter` — wall-clock bytes/s / tokens/s meter with
  ``jax.block_until_ready`` fencing for honest device timings.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

__all__ = ["trace", "ThroughputMeter"]


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2):
    import jax

    with jax.profiler.trace(log_dir, create_perfetto_trace=True):
        yield


class ThroughputMeter:
    """Accumulates (bytes, tokens, seconds) across timed sections."""

    def __init__(self):
        self.bytes = 0
        self.tokens = 0
        self.seconds = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        self._t0 = None

    def add(self, nbytes: int = 0, ntokens: int = 0):
        self.bytes += nbytes
        self.tokens += ntokens

    @property
    def mb_per_s(self) -> float:
        return self.bytes / self.seconds / 1e6 if self.seconds else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    def block_until_ready(self, tree):
        """Fence device work into the timed window."""
        import jax

        jax.block_until_ready(tree)
        return tree
