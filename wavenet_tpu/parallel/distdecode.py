"""Distributed autoregressive generation — component P3.

BASELINE north_star: "generation exchanges cached conv states and sampled
tokens via collectives".  This is that mechanism, explicitly scheduled with
`jax.shard_map` over the (data, model) mesh axes (SURVEY.md §3.3):

  * ring buffers (the per-layer conv caches of arXiv:1611.09482) shard their
    BATCH axis over `data`; with `shard_rings_model=True` they additionally
    shard the CHANNEL axis over `model`, and every per-layer read
    reconstitutes the cached state with an `all_gather` over `model` — the
    cached-conv-state exchange;
  * the gated layers run Megatron-style (parallel/sharding.py): filter/gate
    columns are `model`-local, and the row-parallel residual update ends in
    ONE `psum` over `model` per layer — the second state-exchange collective;
  * skip partial-sums accumulate locally and take a single `psum` at the
    head;
  * the head's Q (class) dim stays column-sharded; sampling is a
    DISTRIBUTED Gumbel-argmax: each shard draws noise for its own class
    columns from the shared counter RNG (ops/rng.py) keyed by (per-ROW
    seed, global step, global class) — shard-layout independent — takes
    its local argmax, and the winning token is exchanged with a `pmax` +
    `pmin` pair over `model`.  No logits all_gather is ever materialized.

Token equality across mesh layouts: because the sampling noise is keyed by
the row's OWN seed and global class coordinate, a (1,1,1)-mesh run, a
data-sharded run, and a model-sharded run all sample identical tokens
(tested in tests/test_distributed_decode.py), up to float-associativity of
the psum.  The SAME hash drives the whole-loop decode kernel
(ops/pallas/decode_gpu.py) and the XLA scan's counter-sampling mode
(models/wavenet.decode_sample_chunk(seeds=...)), so sampled decode is
token-identical across the decoders whenever their logits agree bit for
bit (as they do on the CPU).

The whole loop is one `lax.scan` inside one `shard_map` inside one jit —
zero per-sample dispatch, matching SURVEY.md §7.4.
"""

from __future__ import annotations

import functools
from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.ops import rng
from wavenet_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from wavenet_tpu.parallel import sharding as shd


# ---------------------------------------------------------------------------
# The per-sample sharded decode step (runs INSIDE shard_map)
# ---------------------------------------------------------------------------

def _layer_scan_local(cfg: WaveNetConfig, params_local, x, old_all,
                      use_psum: bool, gcond=None, cond=None):
    """All gated layers on the local shard.  x, old_all carry FULL channel
    width (replicated over `model`); weights are the local Megatron slices,
    so z/h have model-local columns and the row-parallel res product ends in
    a psum over `model` per layer (the conv-state exchange).

    gcond: None or [L, B, 2, R/mp] f32 global-conditioning gate offsets —
    v_global is COLUMN-sharded like w_cur (parallel/sharding.py), so the
    locally-computed offsets align with the local z columns; no collective.
    cond: None or [L, B, 2, R/mp] f32 local-conditioning contribution at
    THIS step (y_t @ v_cond with the local column slice — same alignment)."""
    cdt = jnp.dtype(cfg.compute_dtype)
    stacked = {k: params_local[k] for k in
               ("w_cur", "w_prev", "b", "w_res", "b_res", "w_skip", "b_skip")}
    B = x.shape[0]
    S_local = params_local["w_skip"].shape[-1]

    def body(carry, lp):
        x, skip = carry
        x_prev = lp["old"].astype(cdt)
        z = (wn._dot(x, lp["w_cur"].astype(cdt))
             + wn._dot(x_prev, lp["w_prev"].astype(cdt))
             + lp["b"].astype(jnp.float32))       # [B, 2, R/mp] f32
        if "gcond" in lp:
            z = z + lp["gcond"]
        if "cond" in lp:
            z = z + lp["cond"]                    # [B, 2, R/mp] f32
        h = (jnp.tanh(z[..., 0, :]) * jax.nn.sigmoid(z[..., 1, :])).astype(cdt)
        # partial sums over the local R/mp rows of the row-parallel weights
        skip = skip + wn._dot(h, lp["w_skip"].astype(cdt))
        res = wn._dot(h, lp["w_res"].astype(cdt))      # [B, R] partial
        if use_psum:
            res = jax.lax.psum(res, MODEL_AXIS)        # state exchange
        # single-round residual update (see wn._layer_step)
        x_out = (x.astype(jnp.float32) + res
                 + lp["b_res"].astype(jnp.float32)).astype(cdt)
        return (x_out, skip), x                        # ys: layer INPUT

    skip0 = jnp.zeros((B, S_local), jnp.float32)
    xs = dict(stacked)
    xs["old"] = old_all
    if gcond is not None:
        xs["gcond"] = gcond
    if cond is not None:
        xs["cond"] = cond
    (x, skip), layer_inputs = jax.lax.scan(body, (x, skip0), xs)
    return x, skip, layer_inputs


def _sample_distributed(cfg: WaveNetConfig, logits_local, seeds, t,
                        col0, temperature: float, use_psum: bool):
    """Distributed Gumbel-argmax over the column-sharded class dim.

    logits_local: [B, Q/mp] — each shard holds class columns
    [col0, col0 + Q/mp).  seeds: [B] per-row seeds (ops/rng.py keying);
    t: scalar GLOBAL decode step (priming steps counted), matching the
    decode kernel's step.  Token exchange: pmax of the local best score,
    then a pmin of the winning global class id."""
    B, Qloc = logits_local.shape
    if temperature > 0:
        g = rng.counter_gumbel(seeds[:, None], t, col0, (B, Qloc),
                               class_axis=1)
        scores = logits_local * (1.0 / temperature) + g
    else:
        scores = logits_local
    local_best = jnp.max(scores, axis=-1)                       # [B]
    local_tok = col0 + jnp.argmax(scores, axis=-1).astype(jnp.int32)
    if not use_psum:
        return local_tok
    global_best = jax.lax.pmax(local_best, MODEL_AXIS)
    mine = (local_best == global_best)
    # ties across shards are measure-zero with continuous noise; guard by
    # keeping the lowest winning class id
    cand = jnp.where(mine, local_tok, jnp.int32(2 ** 30))
    return jax.lax.pmin(cand, MODEL_AXIS)


def decode_step_sharded(params_local, cfg: WaveNetConfig,
                        state: wn.DecodeState, token, *,
                        shard_rings_model: bool,
                        use_collectives: bool = True,
                        cond_t=None, gcond=None):
    """One sharded decode step (must run inside the (data, model) shard_map).

    state.queues: [sum_d, B/dp, Rq] where Rq = R/mp when shard_rings_model
    (reads reconstitute full R by all_gather over `model`) else R.
    cond_t: None or [L, B/dp, 2, R/mp] f32 — this step's local-conditioning
    contribution computed from the LOCAL v_cond column slice.
    Returns (new_state, logits_local [B/dp, Q/mp]).
    """
    cdt = jnp.dtype(cfg.compute_dtype)
    R = cfg.residual_channels
    x = wn.embed_tokens(params_local, cfg, token, state.prev_token)  # [B, R]

    offs = jnp.asarray(wn.ring_offsets(cfg)[0], jnp.int32)
    dils = wn.dilation_array(cfg)
    slots = offs + jnp.mod(state.t, dils)
    old_all = state.queues[slots]                       # [L, B, Rq]
    if shard_rings_model and use_collectives:
        # cached conv-state exchange: reconstitute full channels
        old_all = jax.lax.all_gather(old_all, MODEL_AXIS, axis=2,
                                     tiled=True)        # [L, B, R]
    x, skip_partial, layer_inputs = _layer_scan_local(
        cfg, params_local, x, old_all, use_psum=use_collectives,
        gcond=gcond, cond=cond_t)

    if shard_rings_model:
        mp_idx = (jax.lax.axis_index(MODEL_AXIS) if use_collectives
                  else jnp.int32(0))
        Rq = state.queues.shape[-1]
        store = jax.lax.dynamic_slice_in_dim(layer_inputs, mp_idx * Rq, Rq,
                                             axis=2)
    else:
        store = layer_inputs
    new_queues = state.queues.at[slots].set(store.astype(state.queues.dtype))

    skip = skip_partial
    if use_collectives:
        skip = jax.lax.psum(skip, MODEL_AXIS)           # [B, S] full
    skip = skip + jnp.sum(params_local["b_skip"].astype(jnp.float32), axis=0)

    # head: w1 replicated, w2 column-sharded over Q — the local slices flow
    # through the canonical head unchanged (logits come out model-local)
    logits_local = wn.head_logits(params_local, cfg, skip)
    new_state = wn.DecodeState(queues=new_queues, prev_token=token,
                               t=state.t + 1)
    return new_state, logits_local


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def generate_sharded(params, cfg: WaveNetConfig, mesh: Mesh, seed,
                     num_samples: int, batch: int,
                     prime_tokens: Optional[jax.Array] = None,
                     speaker: Optional[jax.Array] = None,
                     y: Optional[jax.Array] = None,
                     temperature: float = 1.0,
                     shard_rings_model: bool = False) -> jax.Array:
    """Distributed fast AR generation over the (data, model) mesh.

    seed: int scalar OR [batch] int32 per-row (per-request) seeds — sampling
    noise comes from the shared counter RNG (ops/rng.py): identical tokens
    for any mesh layout, incl. single-device (see module docstring), and a
    row's draws depend only on ITS seed, never on co-batched rows.
    speaker: optional [batch] int32 global-conditioning ids (data-sharded).
    y: optional [batch, T, M] UPSAMPLED mel features (data-sharded; T must
    cover max(P-1,0)+num_samples) — each shard projects its step's features
    with the LOCAL v_cond column slice, aligned with the local z columns.
    Returns [batch, num_samples] int32 tokens (data-sharded).
    """
    dp = mesh.shape[DATA_AXIS]
    mp = mesh.shape[MODEL_AXIS]
    if cfg.kernel_size != 2:
        raise ValueError("the distributed decoder's ring exchange is "
                         "width-2 only; decode kernel_size > 2 models "
                         "single-device (wn.generate / generate_auto)")
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by data={dp}")
    Q = cfg.quantization_channels
    if Q % mp:
        raise ValueError(f"Q={Q} not divisible by model={mp}")

    Pn = 0 if prime_tokens is None else prime_tokens.shape[1]
    if prime_tokens is None:
        prime_tokens = jnp.zeros((batch, 0), jnp.int32)
    if cfg.global_classes is not None and speaker is None:
        raise ValueError("cfg.global_classes set but no speaker ids passed")
    if speaker is not None and cfg.global_classes is None:
        raise ValueError("speaker ids passed but cfg.global_classes unset")
    has_sp = speaker is not None
    if not has_sp:
        speaker = jnp.zeros((batch,), jnp.int32)     # placeholder operand
    has_cond = y is not None
    total_steps = max(Pn - 1, 0) + num_samples
    if has_cond and y.shape[1] < total_steps:
        raise ValueError(f"y covers {y.shape[1]} < {total_steps} steps "
                         f"(priming included)")
    if not has_cond:
        y = jnp.zeros((batch, 1, 1))                 # placeholder operand
    seeds = rng.as_row_seeds(seed, batch)
    params = _place_params(params, cfg, mesh)
    np_ = max(Pn - 1, 0)
    state, first = _sharded_prime_fn(
        cfg, mesh, batch, Pn, bool(shard_rings_model), has_sp, has_cond)(
        params, prime_tokens, speaker, y[:, :max(np_, 1)])
    _, _, out = _sharded_chunk_fn(
        cfg, mesh, batch, num_samples, float(temperature),
        bool(shard_rings_model), has_sp, has_cond)(
        params, state, first, speaker,
        y[:, np_:np_ + num_samples] if has_cond else y, seeds)
    return _unreplicate_tokens(out, mesh, batch, num_samples)


def generate_sharded_stream(params, cfg: WaveNetConfig, mesh: Mesh, seed,
                            num_samples: int, batch: int,
                            chunk_samples: int = 16000,
                            prime_tokens: Optional[jax.Array] = None,
                            speaker: Optional[jax.Array] = None,
                            y: Optional[jax.Array] = None,
                            temperature: float = 1.0,
                            shard_rings_model: bool = False):
    """STREAMING distributed AR generation: yields [batch, <=chunk_samples]
    int32 token chunks as they decode, bit-identical to the one-shot
    generate_sharded (the sharded DecodeState carries between shard_map'd
    scans, and the counter RNG is keyed by the state's GLOBAL step — the
    same continuation contract as the single-device decode_sample_chunk).
    Mesh serving clients hear first audio after one chunk's decode instead
    of the whole utterance's (round-2 verdict #3); memory for conditioning
    projections is bounded by one chunk."""
    dp = mesh.shape[DATA_AXIS]
    mp = mesh.shape[MODEL_AXIS]
    if cfg.kernel_size != 2:
        raise ValueError("the distributed decoder's ring exchange is "
                         "width-2 only; decode kernel_size > 2 models "
                         "single-device (wn.generate / generate_stream)")
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by data={dp}")
    if cfg.quantization_channels % mp:
        raise ValueError(f"Q={cfg.quantization_channels} not divisible by "
                         f"model={mp}")
    Pn = 0 if prime_tokens is None else prime_tokens.shape[1]
    if prime_tokens is None:
        prime_tokens = jnp.zeros((batch, 0), jnp.int32)
    if cfg.global_classes is not None and speaker is None:
        raise ValueError("cfg.global_classes set but no speaker ids passed")
    if speaker is not None and cfg.global_classes is None:
        raise ValueError("speaker ids passed but cfg.global_classes unset")
    has_sp = speaker is not None
    if not has_sp:
        speaker = jnp.zeros((batch,), jnp.int32)
    has_cond = y is not None
    np_ = max(Pn - 1, 0)
    if has_cond and y.shape[1] < np_ + num_samples:
        raise ValueError(f"y covers {y.shape[1]} < {np_ + num_samples} "
                         f"steps (priming included)")
    if not has_cond:
        y = jnp.zeros((batch, 1, 1))
    seeds = rng.as_row_seeds(seed, batch)
    params = _place_params(params, cfg, mesh)
    state, first = _sharded_prime_fn(
        cfg, mesh, batch, Pn, bool(shard_rings_model), has_sp, has_cond)(
        params, prime_tokens, speaker, y[:, :max(np_, 1)])
    t0 = 0
    while t0 < num_samples:
        n = min(chunk_samples, num_samples - t0)
        y_c = (y[:, np_ + t0:np_ + t0 + n] if has_cond else y)
        state, first, out = _sharded_chunk_fn(
            cfg, mesh, batch, n, float(temperature),
            bool(shard_rings_model), has_sp, has_cond)(
            params, state, first, speaker, y_c, seeds)
        yield _unreplicate_tokens(out, mesh, batch, n)
        t0 += n


def _place_params(params, cfg: WaveNetConfig, mesh: Mesh):
    """Params restored from a checkpoint arrive COMMITTED to one device; a
    jit over the mesh rejects mixed placements.  Re-place to the
    shard_map's ACTUAL input specs (Megatron column/row sharding) — a
    replicated put would materialize the full model per device, defeating
    the memory scaling model parallelism exists for.  No-op when params
    are already placed per the specs."""
    return jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), shd.param_pspecs(cfg),
        is_leaf=lambda s: isinstance(s, P)))


def _unreplicate_tokens(out, mesh: Mesh, batch: int, n: int):
    dp = mesh.shape[DATA_AXIS]
    mp = mesh.shape[MODEL_AXIS]
    if dp * mp * mesh.shape.get("seq", 1) == 1:
        return out[0]
    # model shards produced identical token blocks; keep the first
    return out.reshape(dp, mp, batch // dp, n)[:, 0].reshape(batch, n)


def _state_specs(shard_rings_model: bool):
    """PartitionSpecs of the sharded DecodeState: queues [sum_d, B, Rq]
    shard batch over `data` (and channels over `model` when
    shard_rings_model); the step counter is replicated."""
    return wn.DecodeState(
        queues=P(None, DATA_AXIS,
                 MODEL_AXIS if shard_rings_model else None),
        prev_token=P(DATA_AXIS), t=P())


@functools.lru_cache(maxsize=64)
def _sharded_prime_fn(cfg: WaveNetConfig, mesh: Mesh, batch: int, Pn: int,
                      shard_rings_model: bool, has_sp: bool,
                      has_cond: bool):
    """Jitted sharded priming program: builds the decode state and teacher-
    forces all but the last prime token.  Returns (state, first) with the
    state SHARDED on the mesh (_state_specs) so chunk programs can carry
    it without gathering.  lru_cached per static signature — a fresh
    jax.jit wrapper per call would miss jit's function-identity cache and
    recompile."""
    dp = mesh.shape[DATA_AXIS]
    mp = mesh.shape[MODEL_AXIS]
    Q = cfg.quantization_channels
    use_coll = dp * mp * mesh.shape.get("seq", 1) > 1
    _, sum_d = wn.ring_offsets(cfg)
    Rq = cfg.residual_channels // (mp if shard_rings_model else 1)
    np_ = max(Pn - 1, 0)

    def run(params_local, prime, speaker_local, y_local):
        B_loc = batch // dp
        gcond = (wn.global_cond_offsets(params_local, cfg, speaker_local)
                 if has_sp else None)
        state = wn.DecodeState(
            queues=jnp.zeros((sum_d, B_loc, Rq), jnp.dtype(cfg.compute_dtype)),
            prev_token=jnp.zeros((B_loc,), jnp.int32),
            t=jnp.zeros((), jnp.int32))
        step = partial(decode_step_sharded, params_local, cfg,
                       shard_rings_model=shard_rings_model,
                       use_collectives=use_coll, gcond=gcond)
        if Pn == 0:
            return state, jnp.full((B_loc,), Q // 2, jnp.int32)
        prime_t = jnp.moveaxis(prime[:, :Pn - 1], 1, 0)
        if has_cond:
            cond_all = _project_cond_local(cfg, params_local, y_local, np_)
            st, _ = jax.lax.scan(
                lambda st, xs: (step(st, xs[0], cond_t=xs[1])[0], None),
                state, (prime_t, cond_all))
        else:
            st, _ = jax.lax.scan(
                lambda st, t: (step(st, t)[0], None), state, prime_t)
        return st, prime[:, Pn - 1]

    sspec = _state_specs(shard_rings_model)
    if not use_coll:
        return jax.jit(run)
    sharded = jax.shard_map(
        run, mesh=mesh,
        in_specs=(shd.param_pspecs(cfg), P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS, None, None)),
        out_specs=(sspec, P(DATA_AXIS)),
        axis_names=frozenset({DATA_AXIS, MODEL_AXIS}),
        check_vma=False,
    )
    # partial-manual shard_map (axis_names a mesh subset) only dispatches
    # under jit in jax 0.9 — same constraint as parallel/seqpar.py
    return jax.jit(sharded)


def _project_cond_local(cfg, params_local, y_local, n: int):
    """[T>=n, ...] local conditioning features -> [n, L, B_loc, 2, R/mp]
    per-step gate contributions from the LOCAL v_cond column slice —
    aligned with the model-local z columns by construction (sharding.py)."""
    cdt = jnp.dtype(cfg.compute_dtype)
    return jnp.einsum(
        "btm,lmwr->tlbwr", y_local[:, :n].astype(cdt),
        params_local["v_cond"].astype(cdt),
        preferred_element_type=jnp.float32)


@functools.lru_cache(maxsize=64)
def _sharded_chunk_fn(cfg: WaveNetConfig, mesh: Mesh, batch: int, n: int,
                      temperature: float, shard_rings_model: bool,
                      has_sp: bool, has_cond: bool):
    """Jitted sharded free-running chunk: n sampling steps continuing from
    a carried (state, first).  The counter RNG keys by the state's GLOBAL
    step, so splitting a decode into chunks cannot change the sample path
    (streaming == one-shot, tested).  lru_cached like _sharded_prime_fn."""
    dp = mesh.shape[DATA_AXIS]
    mp = mesh.shape[MODEL_AXIS]
    Q = cfg.quantization_channels
    use_coll = dp * mp * mesh.shape.get("seq", 1) > 1

    def run(params_local, state, first, speaker_local, y_local, seeds_local):
        gcond = (wn.global_cond_offsets(params_local, cfg, speaker_local)
                 if has_sp else None)
        mp_idx = (jax.lax.axis_index(MODEL_AXIS) if use_coll
                  else jnp.int32(0))
        col0 = mp_idx * (Q // mp)
        step = partial(decode_step_sharded, params_local, cfg,
                       shard_rings_model=shard_rings_model,
                       use_collectives=use_coll, gcond=gcond)

        def body(carry, cond_t):
            st, tok = carry
            tkey = st.t          # GLOBAL step consuming `tok`
            st, logits_local = step(st, tok, cond_t=cond_t)
            nxt = _sample_distributed(cfg, logits_local, seeds_local, tkey,
                                      col0, temperature, use_coll)
            return (st, nxt), nxt

        if has_cond:
            cond_all = _project_cond_local(cfg, params_local, y_local, n)
            (st, nxt), samples = jax.lax.scan(body, (state, first), cond_all)
        else:
            (st, nxt), samples = jax.lax.scan(
                lambda c, _: body(c, None), (state, first), None, length=n)
        return st, nxt, jnp.moveaxis(samples, 0, 1)[None]  # [1, B_loc, n]

    sspec = _state_specs(shard_rings_model)
    if not use_coll:
        return jax.jit(run)
    sharded = jax.shard_map(
        run, mesh=mesh,
        in_specs=(shd.param_pspecs(cfg), sspec, P(DATA_AXIS), P(DATA_AXIS),
                  P(DATA_AXIS, None, None), P(DATA_AXIS)),
        out_specs=(sspec, P(DATA_AXIS),
                   P((DATA_AXIS, MODEL_AXIS), None, None)),
        axis_names=frozenset({DATA_AXIS, MODEL_AXIS}),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=64)
def _dp_chunk_fn(cfg: WaveNetConfig, mesh: Mesh, n: int, temperature: float,
                 interpret: bool, has_forced: bool, has_y: bool, has_g: bool):
    """Jitted shard_map fanning ONE whole-loop kernel chunk
    (ops/pallas/decode_gpu.decode_chunk) out over the `data` axis: the
    decode state, seeds and conditioning shard with the batch, the model is
    replicated.  lru_cached per static signature, like _sharded_chunk_fn."""
    from wavenet_tpu.ops.pallas import decode_gpu

    def run(params, state, token, seeds, *opt):
        opt = list(opt)
        kw = {k: (opt.pop(0) if has else None) for k, has in
              (("forced", has_forced), ("y", has_y), ("g", has_g))}
        return decode_gpu.decode_chunk(params, cfg, state, token, seeds, n,
                                       temperature, interpret=interpret, **kw)

    sspec = _state_specs(False)
    in_specs = [P(), sspec, P(DATA_AXIS), P(DATA_AXIS)]
    if has_forced:
        in_specs.append(P(DATA_AXIS, None))
    if has_y:
        in_specs.append(P(DATA_AXIS, None, None))
    if has_g:
        in_specs.append(P(None, DATA_AXIS, None, None))
    sharded = jax.shard_map(run, mesh=mesh, in_specs=tuple(in_specs),
                            out_specs=(sspec, P(DATA_AXIS), P(DATA_AXIS, None)),
                            axis_names=frozenset({DATA_AXIS}),
                            check_vma=False)
    return jax.jit(sharded)


def generate_pallas_dp_stream(params, cfg: WaveNetConfig, mesh: Mesh, seed,
                              num_samples: int, batch: int,
                              chunk_samples: int = 16000,
                              prime_tokens: Optional[jax.Array] = None,
                              speaker: Optional[jax.Array] = None,
                              y: Optional[jax.Array] = None,
                              temperature: float = 1.0,
                              interpret: bool = False):
    """STREAMING data-parallel kernel decode: yields [batch, <=chunk] int32
    token chunks.  The single-device kernel driver (decode_gpu.stream) with
    every chunk fanned over the `data` axis: each device decodes its
    batch/dp rows with the full (replicated) model, and the counter RNG
    keyed by each row's own seed makes the tokens those of one device
    decoding the whole batch."""
    from wavenet_tpu.ops.pallas import decode_gpu
    dp = mesh.shape[DATA_AXIS]
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by data={dp}")
    seeds = rng.as_row_seeds(seed, batch)
    chunk_fn = None
    if dp > 1:
        # checkpoint-restored params are committed to one device (see
        # generate_sharded) — re-place replicated on the mesh
        params = jax.device_put(params, NamedSharding(mesh, P()))

        def chunk_fn(params, cfg, state, token, seeds, n, temperature,
                     forced=None, y=None, g=None, interpret=False):
            fn = _dp_chunk_fn(cfg, mesh, n, float(temperature),
                              bool(interpret), forced is not None,
                              y is not None, g is not None)
            return fn(params, state, token, seeds,
                      *[o for o in (forced, y, g) if o is not None])
    yield from decode_gpu.stream(params, cfg, None, num_samples,
                                 chunk_samples, batch, prime_tokens, y,
                                 speaker, temperature, seeds, interpret,
                                 chunk_fn=chunk_fn)


def generate_pallas_dp(params, cfg: WaveNetConfig, mesh: Mesh, seed,
                       num_samples: int, batch: int,
                       prime_tokens: Optional[jax.Array] = None,
                       speaker: Optional[jax.Array] = None,
                       y: Optional[jax.Array] = None,
                       temperature: float = 1.0,
                       interpret: bool = False) -> jax.Array:
    """Data-parallel fan-out of the whole-loop decode kernel, one-shot:
    [batch, num_samples] tokens, equal to one device's kernel decode of the
    whole batch at the same seeds."""
    (toks,) = generate_pallas_dp_stream(
        params, cfg, mesh, seed, num_samples, batch,
        chunk_samples=num_samples, prime_tokens=prime_tokens,
        speaker=speaker, y=y, temperature=temperature, interpret=interpret)
    return toks
