"""Numerics debugging / sanitizer subsystem (SURVEY.md §5.2).

The reference is single-threaded Python with no sanitizers; the
equivalents here are compiler-level: NaN trapping (jax_debug_nans), finite-ness
assertions compiled into the step (jax.debug + error checking), and a debug
context that turns them all on for a scoped run.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def debug_numerics(nans: bool = True, disable_jit: bool = False) -> Iterator[None]:
    """Scoped numerics-debug mode: NaN trapping + optional op-by-op eval."""
    prev_nans = jax.config.jax_debug_nans
    prev_jit = jax.config.jax_disable_jit
    jax.config.update("jax_debug_nans", nans)
    if disable_jit:
        jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nans)
        jax.config.update("jax_disable_jit", prev_jit)


def assert_tree_finite(tree, name: str = "tree") -> None:
    """Host-side finite check over a pytree (use in tests / debug runs)."""
    import numpy as np
    bad = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            bad.append(jax.tree_util.keystr(path))
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def checked_loss(loss: jax.Array) -> jax.Array:
    """In-graph guard: replaces the loss with +inf if non-finite appeared,
    making divergence visible in metrics instead of silently training on."""
    return jnp.where(jnp.isfinite(loss), loss, jnp.inf)
