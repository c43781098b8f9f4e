"""Causal time-shift primitives.

A kernel-2 dilated causal conv (WaveNet paper §2.1, Figs 2-3) needs, at every
position t, the pair (x[t-d], x[t]).  We realize this not as a conv op but
as a *shift + two matmuls* so all FLOPs are matmuls over [B*T, C] operands
(SURVEY.md §7.1).  The shift is a static-shape dynamic_slice over a
left-padded buffer, which makes the dilation a *traced* value — allowing one
`lax.scan` over layers with a per-layer dilation array.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def shift_right(x: jax.Array, d: jax.Array | int, left_ctx: jax.Array) -> jax.Array:
    """Return y with y[:, t] = x[:, t-d], reading from `left_ctx` for t < d.

    Args:
      x:        [B, T, C] layer input.
      d:        dilation (python int or traced int32 scalar), 1 <= d <= maxd.
      left_ctx: [B, maxd, C] the maxd samples *preceding* x along time.  Zeros
                at sequence start; the previous shard's tail under sequence
                parallelism (halo exchange, SURVEY.md §5.7).
    Returns:
      [B, T, C] shifted sequence.
    """
    B, T, C = x.shape
    maxd = left_ctx.shape[1]
    padded = jnp.concatenate([left_ctx, x], axis=1)        # [B, maxd+T, C]
    start = maxd - d
    return jax.lax.dynamic_slice(padded, (0, start, 0), (B, T, C))
