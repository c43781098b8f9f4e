"""Counter-based sampling RNG shared by EVERY sampled decode path.

One hash, one keying, three consumers:

  * the whole-loop GPU decode kernel (ops/pallas/decode_gpu.py) — runs this
    exact code inside the kernel (plain uint32 arithmetic, which the
    interpreter runs too);
  * the distributed collective decoder (parallel/distdecode.py) — jnp on
    the sharded logits;
  * the XLA scan decoder's counter-sampling mode
    (models/wavenet.decode_sample_chunk(seeds=...)).

Keying: noise for (row, step t, class q) = f(row_seed, t, q) where
row_seed is a PER-ROW (per-request) seed.  Nothing else enters the hash —
not the batch size, not the row's position in the batch, not the mesh
layout.  Consequences, all tested:

  * the same request seed replays the same audio regardless of what other
    requests are co-batched with it (serving replay contract);
  * data-parallel fan-out, model-sharded collective decode, and the
    single-device kernel all sample IDENTICAL tokens at the same seeds
    (they add identical Gumbel noise to bit-identical logits);
  * batch tiles inside the kernel draw the same noise as an untiled run.

Step keying uses the GLOBAL decode step (priming steps count), so chunked
/ streaming decode is bit-identical to one-shot.

The reference samples with NumPy's stateful RNG on the host per sample
(SURVEY.md §3.2 [MEM:med]); a decoder that samples inside the
compiled loop, which demands a stateless counter RNG.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _mix(h):
    """murmur3 finalizer: full avalanche on 32-bit lanes."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def derive_row_seeds(seed, batch: int) -> jax.Array:
    """Scalar seed -> [batch] int32 per-row seeds, hashed from the GLOBAL
    row index — so a data-sharded consumer slicing this vector draws the
    same noise as a single-device run over the full batch."""
    rows = jnp.arange(batch, dtype=jnp.uint32)
    h = (jnp.asarray(seed).astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
         + rows * jnp.uint32(0x85EBCA77))
    return _mix(_mix(h) + rows).astype(jnp.int32)


def as_row_seeds(seed, batch: int) -> jax.Array:
    """Normalize a seed argument: an int/scalar derives per-row seeds; a
    [batch] vector (per-request seeds from the server) passes through."""
    arr = jnp.asarray(seed, jnp.int32)
    if arr.ndim == 0:
        return derive_row_seeds(arr, batch)
    if arr.shape != (batch,):
        raise ValueError(f"row seeds shape {arr.shape} != ({batch},)")
    return arr


def counter_uniform(seeds, t, class0, shape, class_axis: int):
    """Uniform f32 in (0, 1), shape `shape`, keyed by (row_seed, t, class).

    seeds: per-row seeds already broadcastable to `shape` with rows on the
      non-class axis (e.g. [B, 1] against (B, Qlocal), or [1, Bt] against
      (Q, Bt) in a transposed layout).
    t: scalar GLOBAL decode step.
    class0: global class index of this tile's first class column (0 when
      the class axis is unsharded).

    Everything is cast to uint32 BEFORE the mix: int32 arithmetic would run
    ARITHMETIC right-shifts in the murmur mix and clear the sign bit,
    squeezing the output into (0, 0.5) and truncating the Gumbel right tail
    (regression test in tests/test_distributed_decode.py).

    (bits >> 8) fits in 24 bits, so the int32 round-trip before the f32
    cast is exact."""
    cls = (jnp.asarray(class0).astype(jnp.uint32)
           + jax.lax.broadcasted_iota(jnp.uint32, shape, class_axis))
    h = (jnp.asarray(seeds).astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
         + jnp.asarray(t).astype(jnp.uint32) * jnp.uint32(0x7F4A7C15)
         + cls)
    bits = _mix(_mix(h) + cls)
    return ((bits >> 8).astype(jnp.int32).astype(jnp.float32)
            * (1.0 / (1 << 24)) + 1e-12)


def counter_gumbel(seeds, t, class0, shape, class_axis: int):
    """Gumbel(0,1) noise for the Gumbel-max categorical trick."""
    return -jnp.log(-jnp.log(counter_uniform(seeds, t, class0, shape,
                                             class_axis)))
