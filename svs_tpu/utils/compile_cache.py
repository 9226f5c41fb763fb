"""Persistent XLA compilation cache (process-wide, one-time setup).

A cold server at 1M x 1536 pays seconds of jit compilation per (kernel,
batch-shape) first use — ~9 shapes for the serve micro-batcher's bucket
ladder.  XLA's persistent compilation cache makes every later process
hit disk instead of recompiling.

Enabled lazily by the first :class:`RetrievalEngine` construction.  Where
the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set (or a directory already configured
  through ``jax.config``): JAX uses it, and this module sets nothing;
- else ``SVS_TPU_COMPILE_CACHE``: a directory, or ``0``/``off`` to
  disable;
- else :data:`DEFAULT_DIR`, a fixed directory inside the checkout (a
  fixed path, because the path is part of the cache key).

The CPU backend caches only on an explicit ``SVS_TPU_COMPILE_CACHE``:
XLA:CPU entries embed the compiling machine's CPU features, and CPU
compiles are fast anyway.
"""

from __future__ import annotations

import logging
import os
import threading
from pathlib import Path

log = logging.getLogger(__name__)

#: Default cache directory: ``.cache/xla`` at the checkout root
#: (listed in ``.gitignore``).
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".cache" / "xla"

_lock = threading.Lock()
_done = False


def enable_compilation_cache() -> None:
    """Point JAX's persistent compilation cache at its directory
    (idempotent; safe to call from every engine construction)."""
    global _done
    with _lock:
        if _done:
            return
        _done = True
        import jax

        if os.environ.get("JAX_COMPILATION_CACHE_DIR") or getattr(
            jax.config, "jax_compilation_cache_dir", None
        ):
            log.debug("XLA compilation cache configured by JAX; leaving it")
            return
        raw = os.environ.get("SVS_TPU_COMPILE_CACHE", "")
        if raw in ("0", "off"):
            return
        if not raw and jax.default_backend() == "cpu":
            return
        path = Path(raw) if raw else DEFAULT_DIR
        try:
            path.mkdir(parents=True, exist_ok=True)
        except OSError as exc:  # never fail engine startup over a cache
            log.warning("compilation cache disabled: %s", exc)
            return
        jax.config.update("jax_compilation_cache_dir", str(path))
        # cache everything that took meaningful compile time; the
        # default 1 s floor would skip many of the mid-size kernels
        # whose aggregate dominates warmup
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        log.info("XLA compilation cache at %s", path)
