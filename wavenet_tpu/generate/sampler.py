"""Generation drivers (reference `generate.py` equivalents, SURVEY.md §2
#10-11 and §3.2-3.3).

Two samplers, both fully compiled (zero per-sample Python dispatch):

  * `generate_naive` — the reference's O(receptive_field) per-sample
    algorithm: re-run the full-window forward for every sample, inside one
    lax.scan over a sliding token window.  Kept for equivalence testing and
    as the honest "reference algorithm" baseline for benchmarks.
  * `wavenet_tpu.models.wavenet.generate` — the fast cached-queue decoder
    (O(layers)/sample), re-exported here as `generate_fast`.

Plus waveform-level helpers that close the loop to audio files.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from wavenet_tpu import route
from wavenet_tpu.audio import mulaw
from wavenet_tpu.audio.io import write_wav
from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.ops.pallas import decode_gpu

generate_fast = wn.generate


def generate_auto(params: wn.Params, cfg: WaveNetConfig, key: jax.Array,
                  num_samples: int, batch: int = 1,
                  prime_tokens: Optional[jax.Array] = None,
                  cond: Optional[jax.Array] = None,
                  y: Optional[jax.Array] = None,
                  speaker: Optional[jax.Array] = None,
                  temperature: float = 1.0,
                  seeds=None, interpret: bool = False) -> jax.Array:
    """One-shot decode on the route `wavenet_tpu.route.decode` picks: the
    whole-loop GPU kernel or the XLA scan.

    y: [B, T, M] UPSAMPLED conditioning features (sample rate), projected
       per step by either route.  `cond` is the pre-projected
       [B, T, L, 2, R] form, which only the scan consumes; pass one or the
       other, not both.
    speaker: [B] int32 global-conditioning ids (cfg.global_classes set).
    seeds: optional per-row (per-request) counter-RNG seeds (ops/rng.py) —
       both routes then sample with the SAME hash, so each row's audio is
       independent of co-batched rows.  Without seeds the kernel derives
       them from `key` and the scan samples with `key` itself.
    interpret: run the kernel in the Pallas interpreter (tests).
    """
    if cond is not None and y is not None:
        raise ValueError("pass either y (features) or cond (projections)")
    if cond is None and route.decode(cfg, interpret=interpret) == route.KERNEL:
        return decode_gpu.generate(params, cfg, key, num_samples, batch=batch,
                                   prime_tokens=prime_tokens, y=y,
                                   speaker=speaker, temperature=temperature,
                                   seeds=seeds, interpret=interpret)
    if y is not None:
        from wavenet_tpu.models.conditioning import project_cond
        cond = project_cond(params, y)
    if seeds is not None:
        from wavenet_tpu.ops import rng
        seeds = rng.as_row_seeds(seeds, batch)
    return wn.generate(params, cfg, key, num_samples, batch=batch,
                       prime_tokens=prime_tokens, cond=cond, speaker=speaker,
                       temperature=temperature, seeds=seeds)


def generate_stream(params: wn.Params, cfg: WaveNetConfig, key: jax.Array,
                    num_samples: int, chunk_samples: int = 16000,
                    batch: int = 1,
                    prime_tokens: Optional[jax.Array] = None,
                    y: Optional[jax.Array] = None,
                    speaker: Optional[jax.Array] = None,
                    temperature: float = 1.0,
                    interpret: bool = False,
                    seeds=None):
    """Streaming generation: yields [B, <=chunk_samples] int32 token chunks.

    Long-form / serving entry point: memory is bounded by one chunk (the
    decode state carries between chunks), and the chunks concatenate to
    exactly the one-shot generate_auto tokens on the same route: the
    kernel's RNG and the scan's are keyed by the global step.

    y: [B, T, M] upsampled mel features covering max(P-1,0)+num_samples
    steps; speaker: [B] int32 ids (cfg.global_classes).
    seeds: optional per-row (per-request) counter-RNG seeds (ops/rng.py).
    """
    if route.stream(cfg, interpret=interpret) == route.KERNEL:
        yield from decode_gpu.stream(params, cfg, key, num_samples,
                                     chunk_samples, batch, prime_tokens, y,
                                     speaker, temperature, seeds, interpret)
        return
    yield from _stream_scan(params, cfg, key, num_samples, chunk_samples,
                            batch, prime_tokens, y, speaker, temperature,
                            seeds=seeds)


def generate_distributed(params: wn.Params, cfg: WaveNetConfig, mesh,
                         seed: int, num_samples: int, batch: int,
                         prime_tokens: Optional[jax.Array] = None,
                         y: Optional[jax.Array] = None,
                         speaker: Optional[jax.Array] = None,
                         temperature: float = 1.0) -> jax.Array:
    """Multi-device AR generation over a (data, model) mesh (SURVEY.md P3).

    seed: int scalar or [batch] per-row (per-request) seeds.  Routing
    (`wavenet_tpu.route.dp_decode`): data-parallel-only meshes fan the
    whole-loop kernel out over `data` (distdecode.generate_pallas_dp);
    model-sharded meshes run the collective loop (generate_sharded:
    per-layer psum conv-state exchange, token broadcast).  Both sample from
    the same counter RNG keyed by each row's own seed, so a row's tokens do
    not depend on the mesh layout beyond the rounding of its logits.
    """
    from wavenet_tpu.parallel import distdecode
    if route.dp_decode(cfg, mesh, batch) == route.KERNEL:
        return distdecode.generate_pallas_dp(params, cfg, mesh, seed,
                                             num_samples, batch,
                                             prime_tokens=prime_tokens,
                                             speaker=speaker, y=y,
                                             temperature=temperature)
    return distdecode.generate_sharded(params, cfg, mesh, seed, num_samples,
                                       batch, prime_tokens=prime_tokens,
                                       speaker=speaker, y=y,
                                       temperature=temperature)


def stream_distributed(params: wn.Params, cfg: WaveNetConfig, mesh,
                       seed, num_samples: int, batch: int,
                       chunk_samples: int = 16000,
                       prime_tokens: Optional[jax.Array] = None,
                       y: Optional[jax.Array] = None,
                       speaker: Optional[jax.Array] = None,
                       temperature: float = 1.0):
    """STREAMING multi-device AR generation: yields [batch, <=chunk] int32
    token chunks, identical to the one-shot generate_distributed at the
    same seeds (both route on the same rule and both key sampling by the
    global step)."""
    from wavenet_tpu.parallel import distdecode
    if route.dp_decode(cfg, mesh, batch) == route.KERNEL:
        yield from distdecode.generate_pallas_dp_stream(
            params, cfg, mesh, seed, num_samples, batch,
            chunk_samples=chunk_samples, prime_tokens=prime_tokens,
            speaker=speaker, y=y, temperature=temperature)
        return
    yield from distdecode.generate_sharded_stream(
        params, cfg, mesh, seed, num_samples, batch,
        chunk_samples=chunk_samples, prime_tokens=prime_tokens,
        speaker=speaker, y=y, temperature=temperature)


@functools.partial(jax.jit, static_argnames=("cfg", "n", "temperature"))
def _scan_chunk(params, cfg, state, first, key, i0, n, cond, gcond,
                temperature, seeds, cond_t0):
    """decode_sample_chunk jitted once per (cfg, n, temperature): a fresh
    jit wrapper per stream would retrace and recompile the layer scan for
    every request the server streams."""
    return wn.decode_sample_chunk(params, cfg, state, first, key, i0, n,
                                  cond=cond, gcond=gcond,
                                  temperature=temperature, cond_t0=cond_t0,
                                  seeds=seeds)


def _stream_scan(params: wn.Params, cfg: WaveNetConfig, key: jax.Array,
                 num_samples: int, chunk_samples: int, batch: int,
                 prime_tokens, y, speaker, temperature: float, seeds=None):
    """XLA streaming route: chunked decode_step scans with the DecodeState
    carried between chunks.  Built on the same decode_prime +
    decode_sample_chunk primitives as wn.generate, with absolute-index
    per-step RNG — so the concatenated chunks are bit-identical to the
    one-shot XLA generate() (tested in tests/test_pallas_decode.py's
    scan-route cases).  Conditioning features are projected PER CHUNK (cond is
    [.., L, 2, R] — projecting the whole timeline up front would be ~L*2*R/M
    times the size of y and defeat streaming's bounded-memory contract)."""
    if seeds is not None:
        from wavenet_tpu.ops import rng
        seeds = rng.as_row_seeds(seeds, batch)
    P0 = 0 if prime_tokens is None else prime_tokens.shape[1]
    skip = max(P0 - 1, 0)                        # priming decode steps
    project = None
    if y is not None:
        from wavenet_tpu.models.conditioning import project_cond
        if y.shape[1] < skip + num_samples:
            raise ValueError(f"y covers {y.shape[1]} < "
                             f"{skip + num_samples} steps (priming included)")
        project = functools.partial(project_cond, params)
    cond_prime = project(y[:, :skip]) if (project and skip) else None
    state, first, gcond = wn.decode_prime(params, cfg, batch, prime_tokens,
                                          cond=cond_prime, speaker=speaker,
                                          num_samples=0)
    t0 = 0
    while t0 < num_samples:
        n = min(chunk_samples, num_samples - t0)
        cond_c = project(y[:, skip + t0:skip + t0 + n]) if project else None
        state, first, toks = _scan_chunk(params, cfg, state, first, key,
                                         jnp.int32(t0), n, cond_c, gcond,
                                         temperature, seeds,
                                         jnp.int32(skip + t0))
        yield toks
        t0 += n


def generate_naive(params: wn.Params, cfg: WaveNetConfig, key: jax.Array,
                   num_samples: int, batch: int = 1,
                   prime_tokens: Optional[jax.Array] = None,
                   speaker: Optional[jax.Array] = None,
                   y: Optional[jax.Array] = None,
                   temperature: float = 1.0) -> jax.Array:
    """Naive AR sampling: full receptive-field forward per sample.

    This is the slow ORACLE the cached-queue decoder is validated against,
    so it reproduces the fast path's boundary semantics exactly:

    - The window is RF+1 wide: positions [1:] feed the model, [:-1] are the
      true previous tokens (logits at t depend on tokens t-RF+1..t via
      E_cur and t-RF..t-1 via E_prev — RF+1 trailing tokens total), so the
      oldest model position never sees forward_logits' default zero-token
      prev once the window has rolled past the sequence start.
    - While the history is shorter than the window, a validity mask makes
      the missing positions contribute exactly the zero left-padding the
      fast path's empty rings see (forward_logits valid_mask docstring),
      instead of hallucinating a window full of silence tokens.
    - Mel conditioning (`y`: [B, T, M] UPSAMPLED features covering
      max(P-1, 0) + num_samples steps, the fast decoders' timeline) slides
      a matching feature window alongside the tokens: model position t'
      sees y at its ABSOLUTE decode step, zero features before sequence
      start (harmless — the validity mask re-zeroes the residual stream at
      those positions before every dilated read).  This closes the oracle
      gap on the vocoder product path (round-3 verdict #5).

    The whole loop compiles to one scan with static shapes.
    """
    rf = cfg.receptive_field
    Km1 = cfg.kernel_size - 1                  # leading history positions:
    W = rf + Km1                               # every embed tap of the
    Q = cfg.quantization_channels              # oldest model position is real
    if prime_tokens is None:
        # left-fill with token 0: masked positions are zeroed anyway, and
        # the first valid position's prev then embeds the zero-token —
        # matching forward_logits' sequence-start convention
        window = jnp.zeros((batch, W), jnp.int32).at[:, -1].set(Q // 2)
        c0 = 1                                 # valid tokens in the window
    else:
        P = prime_tokens.shape[1]
        if P >= W:
            window = prime_tokens[:, -W:].astype(jnp.int32)
            c0 = W
        else:
            window = jnp.concatenate([
                jnp.zeros((batch, W - P), jnp.int32),
                prime_tokens.astype(jnp.int32)], axis=1)
            c0 = P
    pos = jnp.arange(rf)[None, :]                              # [1, RF]

    y_pad = None
    base = 0
    if y is not None:
        if cfg.mel is None:
            raise ValueError("y passed but cfg.mel is None")
        P0 = 0 if prime_tokens is None else prime_tokens.shape[1]
        base = max(P0 - 1, 0)
        if y.shape[1] < base + num_samples:
            raise ValueError(f"y covers {y.shape[1]} < {base + num_samples} "
                             f"steps (priming included)")
        # left-pad rf-1 zero-feature steps so a window ending at absolute
        # step s reads y_pad[:, s : s + rf] (zeros before sequence start)
        y_pad = jnp.pad(y.astype(jnp.float32),
                        ((0, 0), (rf - 1, 0), (0, 0)))

    def body(carry, i):
        window, c = carry
        nvalid = jnp.minimum(c, rf)            # valid MODEL positions
        mask = (pos >= rf - nvalid).astype(jnp.float32)        # [1, RF]
        mask = jnp.broadcast_to(mask, (batch, rf))
        y_win = None
        if y_pad is not None:
            y_win = jax.lax.dynamic_slice(
                y_pad, (0, base + i, 0),
                (batch, rf, y_pad.shape[2]))
        prev_extra = None                      # wider kernels: taps t-2..
        if Km1 > 1:                            # t-(K-1) from the window's
            prev_extra = jnp.stack(            # true history
                [window[:, Km1 - j:-j] for j in range(2, Km1 + 1)])
        logits = wn.forward_logits(params, cfg, window[:, Km1:],
                                   prev_tokens=window[:, Km1 - 1:-1],
                                   prev_tokens_extra=prev_extra,
                                   speaker=speaker,
                                   upsampled_cond=y_win,
                                   valid_mask=mask)[:, -1]     # [B, Q]
        k = jax.random.fold_in(key, i)
        # static-0 => greedy; traced temperatures keep the division path
        if isinstance(temperature, (int, float)) and temperature <= 0:
            nxt = jnp.argmax(logits, axis=-1)                  # greedy
        else:
            nxt = jax.random.categorical(k, logits / temperature, axis=-1)
        nxt = nxt.astype(jnp.int32)
        window = jnp.concatenate([window[:, 1:], nxt[:, None]], axis=1)
        return (window, jnp.minimum(c + 1, W)), nxt

    # the reference path: float32 matmuls at full precision on every
    # backend (a GPU would otherwise run them in TF32)
    with jax.default_matmul_precision("highest"):
        (_, _), samples = jax.lax.scan(body, (window, jnp.int32(c0)),
                                       jnp.arange(num_samples))
    return jnp.moveaxis(samples, 0, 1)


def tokens_to_waveform(tokens: jax.Array, cfg: WaveNetConfig) -> np.ndarray:
    return np.asarray(mulaw.decode(tokens, cfg.quantization_channels))


def batch_paths(out_path: str, batch: int):
    """out.wav -> [out_0.wav, ...] for batch > 1; robust to extensionless
    paths.  THE naming rule for batched wav output — the CLI and the
    library facade both use it so their filenames cannot diverge."""
    if batch == 1:
        return [out_path]
    import os
    root, ext = os.path.splitext(out_path)
    ext = ext or ".wav"
    return [f"{root}_{i}{ext}" for i in range(batch)]


def generate_wav(params: wn.Params, cfg: WaveNetConfig, out_path: str,
                 seconds: float, key: Optional[jax.Array] = None,
                 batch: int = 1, temperature: float = 1.0,
                 cond: Optional[jax.Array] = None,
                 **decode_kw) -> np.ndarray:
    """Sample `seconds` of audio with the fast decoder and write wav file(s).
    decode_kw (prime_tokens=, y=, speaker=, ...) pass through to
    generate_auto so conditioned models have a working wav entry point."""
    key = jax.random.PRNGKey(0) if key is None else key
    n = int(seconds * cfg.sample_rate)
    toks = generate_auto(params, cfg, key, num_samples=n, batch=batch,
                         cond=cond, temperature=temperature, **decode_kw)
    wave = tokens_to_waveform(toks, cfg)
    for i, path in enumerate(batch_paths(out_path, batch)):
        write_wav(path, wave[i], cfg.sample_rate)
    return wave
