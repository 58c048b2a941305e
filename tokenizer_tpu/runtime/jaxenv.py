"""JAX environment knobs for production runs.

The merge kernels compile a handful of static shapes (one per packing
bucket and batch tier).  The persistent compilation cache makes every
shape a once-per-checkout cost.  ``JAX_COMPILATION_CACHE_DIR``, when
set, names the cache directory and no other is set; otherwise, when the
package runs from a source checkout, the cache lives at one fixed path
inside it, :data:`DEFAULT_CACHE_DIR` (git-ignored).  The path is part of
the cache's key, so it must not move between runs.  An installed
package with no cache directory, or a directory that cannot be written,
compiles without a persistent cache and warns once: the cache is an
optimisation and never fails an encode.  Safe to call unconditionally;
opt out with TOKENIZER_TPU_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Optional

_CHECKOUT = Path(__file__).resolve().parents[2]

#: In-checkout cache directory used when JAX_COMPILATION_CACHE_DIR is unset.
DEFAULT_CACHE_DIR = _CHECKOUT / ".jax_cache"

_done = False


def compile_cache_dir() -> Optional[Path]:
    """The directory the persistent compilation cache uses, or None when
    the env names none and the package does not run from a checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return Path(env)
    if (_CHECKOUT / "pyproject.toml").is_file():
        return DEFAULT_CACHE_DIR
    return None


def ensure_compile_cache() -> None:
    global _done
    if _done or os.environ.get("TOKENIZER_TPU_NO_COMPILE_CACHE"):
        return
    _done = True
    import jax

    cache_dir = compile_cache_dir()
    if cache_dir is None:
        warnings.warn(
            "no JAX_COMPILATION_CACHE_DIR and no source checkout: compiling"
            " without a persistent cache",
            RuntimeWarning,
            stacklevel=2,
        )
        return
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
        if not os.access(cache_dir, os.W_OK):
            raise PermissionError(f"{cache_dir} is not writable")
    except OSError as exc:
        warnings.warn(
            f"compile cache {cache_dir} unusable ({exc}): compiling without"
            " a persistent cache",
            RuntimeWarning,
            stacklevel=2,
        )
        return
    jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
