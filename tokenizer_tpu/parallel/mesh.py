"""Mesh construction for the 1-D data-parallel layout (SURVEY.md §2.3)."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np

__all__ = ["data_mesh", "local_batch_size"]


def data_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> "jax.sharding.Mesh":
    """A 1-D ``("data",)`` mesh over the given (default: all) devices.

    Multi-host: ``jax.devices()`` already enumerates the global device
    set after ``jax.distributed.initialize`` (see
    :mod:`tokenizer_tpu.parallel.multihost`), so the same call shape
    covers single-device, single-host and multi-host runs.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            # Silently building a smaller mesh than asked for once let a
            # "sharded" fuzz campaign run on ONE device — fail loudly.
            raise ValueError(
                f"data_mesh({n_devices}) but only {len(devices)} device(s)"
                " visible; for a virtual CPU mesh set JAX_PLATFORMS=cpu"
                " XLA_FLAGS=--xla_force_host_platform_device_count=N"
                " before jax initializes"
            )
        devices = devices[:n_devices]
    return jax.sharding.Mesh(np.asarray(devices), ("data",))


def local_batch_size(global_b: int, mesh: "jax.sharding.Mesh") -> int:
    n = mesh.shape["data"]
    if global_b % n:
        raise ValueError(f"batch {global_b} not divisible by mesh size {n}")
    return global_b // n
