"""Persistent XLA compilation cache for training, serving and CLI starts.

JAX's persistent compilation cache keys executables on (HLO, backend,
compiler flags) and reuses them across processes, so a graph compiled once
on a machine (the decode scan at a large `decode_unroll`, the training step)
is not compiled again by the next process.

No reference counterpart (SURVEY.md §1: the reference has no serving or
process-restart story at all); this is framework infrastructure.

Usage: ``compcache.enable()`` before the first jit dispatch; `train.py`,
`generate.py`, `serve.py`, `score.py` and `chip_smoke.py` do so at start.
Where ``$JAX_COMPILATION_CACHE_DIR`` is set, JAX already caches there and
no other directory is set in code.  Otherwise the cache lives at the fixed
path ``runs/.xla_cache`` inside the checkout (gitignored): the path is part
of what makes a later process find it.
"""

from __future__ import annotations

import os
from typing import Optional

ENV = "JAX_COMPILATION_CACHE_DIR"
_DEFAULT_SUBDIR = os.path.join("runs", ".xla_cache")
_enabled_dir: Optional[str] = None


def default_dir() -> str:
    env = os.environ.get(ENV)
    if env:
        return env
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo_root, _DEFAULT_SUBDIR)


def enable(path: Optional[str] = None,
           min_compile_secs: float = 1.0) -> str:
    """Turn the persistent cache on and return its directory.  Idempotent;
    safe to call before or after backend init (the cache is consulted per
    compile, not at backend creation).

    path: an explicit directory; None means $JAX_COMPILATION_CACHE_DIR when
      set (which JAX reads itself, so no directory is set here) and the
      fixed checkout path otherwise.
    min_compile_secs: only compilations at least this slow are persisted —
      keeps the cache from filling with trivial sub-second kernels while
      still catching every graph a restart would actually wait on.
    """
    global _enabled_dir
    import jax

    from_env = path is None and bool(os.environ.get(ENV))
    d = os.path.abspath(path or default_dir())
    os.makedirs(d, exist_ok=True)
    if not from_env and jax.config.jax_compilation_cache_dir != d:
        jax.config.update("jax_compilation_cache_dir", d)
        # JAX opens its cache at the first compile and keeps that handle;
        # drop it so a directory changed in-process takes effect
        from jax._src import compilation_cache
        compilation_cache.reset_cache()
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    _enabled_dir = d
    return d


def enabled_dir() -> Optional[str]:
    """The active cache directory, or None when not enabled here."""
    return _enabled_dir
