"""Whole-loop autoregressive decoder for NVIDIA GPUs (Pallas, Triton route).

One `pallas_call` runs a whole chunk of decode steps: embed, every gated
residual layer (arXiv:1609.03499 eq.2-3), the ring reads and writes, the
head and Gumbel-max sampling.  The XLA scan decoder
(`models.wavenet.decode_sample_chunk`) launches several kernels per layer
per sample; here a sample costs no launch at all.

Design for the card:

  * State is the scan's own `DecodeState`: compact rings `[sum_d, B, R]`
    (bf16), the previous token and the global step, plus the token to
    consume next.  Kernel and scan are interchangeable chunk by chunk.
  * The grid runs over batch tiles of `BT` = 16 rows (Triton's `dot` wants
    at least 16 on every dimension; the wrapper pads the rows).  Inside a
    program a `fori_loop` runs over the chunk's steps, and a loop over
    layers inside it reads each layer's ring offset and dilation from a
    small int table.
  * Weights and rings stay in device memory and are read at every layer
    step.  The `full` stack (about 9.2 MB in bf16) fits the 50 MB L2, not
    the 227 KB of shared memory a block may use.
  * The ring slot read at step t is the slot written at step t; a block
    barrier orders the read before the write across the program's threads.
  * The embedding is a row gather from the float32 tables, summed once and
    rounded once: the scan's `embed_tokens` bit for bit.  (A one-hot
    `[16, Q] @ [Q, R]` product at IEEE f32 precision is also exact, but
    cost 10x the whole step at `full` on an H100.)
  * Mel features `y` stream per step (mels padded to a power of two), the
    speaker offsets are added per layer, and priming steps consume forced
    tokens.  Sampling uses the counter hash of `ops/rng.py`.

Known limit: one program runs on one SM, so at B <= 16 the whole stack runs
on one SM and rereads every weight from L2 at every step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.ops import rng

BT = 16                     # rows per program
CH = 128                    # widest weight block read at once
NUM_WARPS = 4


def _pow2(n: int) -> bool:
    return n >= 16 and n & (n - 1) == 0


def supported(cfg: WaveNetConfig) -> bool:
    """Kernel width 2, bf16 compute, no embed projection, and channel
    widths that are powers of two (Triton's block shapes)."""
    return (cfg.kernel_size == 2 and cfg.compute_dtype == "bfloat16"
            and cfg.embed_channels == cfg.residual_channels
            and _pow2(cfg.residual_channels) and _pow2(cfg.skip_channels)
            and _pow2(cfg.quantization_channels))


def padded_rows(batch: int) -> int:
    return -(-batch // BT) * BT


def padded_mels(num_mels: int) -> int:
    m = 16
    while m < num_mels:
        m *= 2
    return m


def _parts(n: int):
    """(offset, width) column blocks of at most CH: weight tiles wider than
    CH are read and multiplied block by block to bound registers."""
    return [(o, min(CH, n - o)) for o in range(0, n, CH)]


def _kernel(cfg: WaveNetConfig, n: int, nf: int, temperature: float,
            has_cond: bool, has_gc: bool, emit_logits: bool, interpret: bool,
            *refs):
    refs = list(refs)
    (seeds_ref, t0_ref, tok_ref, prev_ref, forced_ref, offs_ref, dils_ref,
     ecur_ref, eprev_ref, wcur_ref, wprev_ref, b_ref, wres_ref, bres_ref,
     wskip_ref, bskip_ref, hw1_ref, hb1_ref, hw2_ref, hb2_ref) = refs[:20]
    refs = refs[20:]
    y_ref = refs.pop(0) if has_cond else None        # [n, Bp, Mp] bf16
    vc_ref = refs.pop(0) if has_cond else None       # [L, Mp, 2, R] bf16
    g_ref = refs.pop(0) if has_gc else None          # [L, Bp, 2, R] f32
    refs.pop(0)                                      # rings in (aliased)
    toks_out, rings, tok_out, prev_out = refs[:4]
    logits_out = refs[4] if emit_logits else None

    S, Q = cfg.skip_channels, cfg.quantization_channels
    L = cfg.num_layers
    rows = pl.ds(pl.program_id(0) * BT, BT)
    seeds = seeds_ref[rows]
    t0 = t0_ref[0]
    sparts = _parts(S)

    def barrier():
        if not interpret:               # the interpreter runs one thread
            plgpu.debug_barrier()

    def dot(a, b):
        return jnp.dot(a, b, preferred_element_type=jnp.float32)

    def head(skip):                     # [BT, S] f32 blocks -> [BT, Q] f32
        s = [jnp.maximum(p, 0.0).astype(jnp.bfloat16) for p in skip]
        h = []
        for o, w in sparts:
            acc = hb1_ref[pl.ds(o, w)][None, :]
            for (k, kw), sk in zip(sparts, s):
                acc = acc + dot(sk, hw1_ref[pl.ds(k, kw), pl.ds(o, w)])
            h.append(jnp.maximum(acc, 0.0).astype(jnp.bfloat16))
        logits = hb2_ref[...][None, :]
        for (k, kw), hk in zip(sparts, h):
            logits = logits + dot(hk, hw2_ref[pl.ds(k, kw), :])
        return logits

    def step(i, carry):
        token, prev = carry
        t = t0 + i
        # row gather from the float32 tables, one add, one rounding: the
        # scan's embed_tokens exactly
        x = (ecur_ref[token, :] + eprev_ref[prev, :]).astype(jnp.bfloat16)
        y_t = y_ref[i, rows, :] if has_cond else None    # [BT, Mp]

        def layer(l, lc):
            x, skip = lc
            slot = offs_ref[l] + jax.lax.rem(t, dils_ref[l])
            old = rings[slot, rows, :]                   # input from t - d
            barrier()
            rings[slot, rows, :] = x                     # read at t + d
            z = []
            for gate in (0, 1):
                zz = (dot(x, wcur_ref[l, :, gate, :])
                      + dot(old, wprev_ref[l, :, gate, :])
                      + b_ref[l, gate, :][None, :])
                if has_cond:
                    zz = zz + dot(y_t, vc_ref[l, :, gate, :])
                if has_gc:
                    zz = zz + g_ref[l, rows, gate, :]
                z.append(zz)
            h = (jnp.tanh(z[0]) * jax.nn.sigmoid(z[1])).astype(jnp.bfloat16)
            skip = tuple(
                sk + dot(h, wskip_ref[l, :, pl.ds(o, w)])
                + bskip_ref[l, pl.ds(o, w)][None, :]
                for sk, (o, w) in zip(skip, sparts))
            x = (x.astype(jnp.float32) + dot(h, wres_ref[l])
                 + bres_ref[l, :][None, :]).astype(jnp.bfloat16)
            return x, skip

        skip0 = tuple(jnp.zeros((BT, w), jnp.float32) for _, w in sparts)
        _, skip = jax.lax.fori_loop(0, L, layer, (x, skip0))
        logits = head(skip)
        if emit_logits:
            logits_out[i, rows, :] = logits
        if temperature > 0:
            logits = logits * (1.0 / temperature) + rng.counter_gumbel(
                seeds[:, None], t, 0, (BT, Q), class_axis=1)
        nxt = jnp.argmax(logits, axis=1).astype(jnp.int32)
        toks_out[i, rows] = nxt
        if nf:                          # priming: consume the forced token
            j = jnp.minimum(i + 1, nf - 1)
            nxt = jnp.where(i + 1 < nf, forced_ref[j, rows], nxt)
        return nxt, token

    token, prev = jax.lax.fori_loop(0, n, step, (tok_ref[rows], prev_ref[rows]))
    tok_out[rows] = token
    prev_out[rows] = prev


def _pad_rows(a, Bp: int, axis: int = 0):
    extra = Bp - a.shape[axis]
    if not extra:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, extra)
    return jnp.pad(a, pad)


@functools.partial(jax.jit, static_argnames=("cfg", "n", "temperature",
                                             "interpret", "emit_logits"))
def decode_chunk(params, cfg: WaveNetConfig, state: wn.DecodeState,
                 token: jax.Array, seeds: jax.Array, n: int,
                 temperature: float = 1.0, forced=None, y=None, g=None,
                 interpret: bool = False, emit_logits: bool = False):
    """Run `n` decode steps from `state`, consuming `token` first.

    seeds: [B] int32 per-row counter-RNG seeds (ops/rng.py).
    forced: optional [B, F] tokens; step i >= 1 consumes forced[:, i] while
      i < F (teacher-forced priming), else the token sampled at step i-1.
    y: optional [B, n, M] upsampled mel features for these steps.
    g: optional [L, B, 2, R] f32 speaker gate offsets.
    Returns (state', next token [B], samples [B, n]) and, with emit_logits,
    the per-step logits [B, n, Q] f32 as a fourth result.  samples[:, i] is
    the argmax of step i's (noised) logits, forced or not.
    """
    if not supported(cfg):
        raise ValueError("config not supported by the GPU decode kernel; "
                         "use models.wavenet.decode_sample_chunk")
    B = token.shape[0]
    Bp = padded_rows(B)
    L, R, Q = cfg.num_layers, cfg.residual_channels, cfg.quantization_channels
    bf, f32 = jnp.bfloat16, jnp.float32
    offs, sum_d = wn.ring_offsets(cfg)
    nf = 0 if forced is None else forced.shape[1]
    has_cond, has_gc = y is not None, g is not None
    if has_cond and cfg.mel is None:
        raise ValueError("y passed but cfg.mel is None")

    i32 = lambda a: jnp.asarray(a, jnp.int32)
    ops = [
        _pad_rows(rng.as_row_seeds(seeds, B), Bp),
        i32(state.t).reshape(1),
        _pad_rows(i32(token), Bp),
        _pad_rows(i32(state.prev_token), Bp),
        (jnp.zeros((1, Bp), jnp.int32) if forced is None
         else _pad_rows(i32(forced).T, Bp, axis=1)),
        jnp.asarray(offs, jnp.int32), wn.dilation_array(cfg),
        params["embed_cur"].astype(f32), params["embed_prev"].astype(f32),
        params["w_cur"].astype(bf), params["w_prev"].astype(bf),
        params["b"].astype(f32),
        params["w_res"].astype(bf), params["b_res"].astype(f32),
        params["w_skip"].astype(bf), params["b_skip"].astype(f32),
        params["head_w1"].astype(bf), params["head_b1"].astype(f32),
        params["head_w2"].astype(bf), params["head_b2"].astype(f32),
    ]
    if has_cond:
        M = cfg.mel.num_mels
        Mp = padded_mels(M)
        yk = jnp.pad(jnp.moveaxis(y[:, :n], 1, 0).astype(bf),
                     ((0, 0), (0, Bp - B), (0, Mp - M)))
        vc = jnp.pad(params["v_cond"].astype(bf),
                     ((0, 0), (0, Mp - M), (0, 0), (0, 0)))
        ops += [yk, vc]
    if has_gc:
        ops.append(_pad_rows(g.astype(f32), Bp, axis=1))
    ops.append(_pad_rows(state.queues.astype(bf), Bp, axis=1))

    out_shape = [jax.ShapeDtypeStruct((n, Bp), jnp.int32),
                 jax.ShapeDtypeStruct((sum_d, Bp, R), bf),
                 jax.ShapeDtypeStruct((Bp,), jnp.int32),
                 jax.ShapeDtypeStruct((Bp,), jnp.int32)]
    if emit_logits:
        out_shape.append(jax.ShapeDtypeStruct((n, Bp, Q), f32))
    kernel = functools.partial(_kernel, cfg, n, nf, float(temperature),
                               has_cond, has_gc, emit_logits, interpret)
    outs = pl.pallas_call(
        kernel,
        grid=(Bp // BT,),
        out_shape=tuple(out_shape),
        input_output_aliases={len(ops) - 1: 1},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="wavenet_decode",
    )(*ops)
    toks, rings, tok, prev = outs[:4]
    new_state = wn.DecodeState(queues=rings[:, :B], prev_token=prev[:B],
                               t=state.t + n)
    nxt = tok[:B]
    samples = toks[:, :B].T
    if emit_logits:
        return new_state, nxt, samples, jnp.moveaxis(outs[4][:, :B], 0, 1)
    return new_state, nxt, samples


# Kernel vs scan on the card.  The two sum bf16 products in different
# orders (Triton's MMA tiles vs cuBLAS) and take tanh/sigmoid from different
# libraries, so a bf16 rounding of the residual stream occasionally flips;
# the flip persists in the rings and spreads.  H100 readings over 2,048
# teacher-forced steps at `full`, `full_vocoder` (mel) and `fastgen_bench`,
# three weight seeds each, against planted faults (one layer's ring read one
# step late, every ring one step late, the mel term dropped or one step
# late); details in PERF.md:
#   mean |d logits|: sound 0.0027-0.030, faults 0.155-0.99
#   max |d logits|:  sound 0.024-0.26,   faults 1.4-7.2
#   greedy margin:   sound 0.012-0.17,   faults 1.0-7.2
# Each bound sits above every sound reading and at least 2.8x below the
# weakest fault.  With mel the first steps already differ by up to 0.076:
# reordering the scan's own mel sum moves step-0 logits by 0.021, so no
# separate first-steps bound is kept; a mel fault reads 3.1-4.3 there.
LOGITS_MEAN_TOL = 0.05     # mean |d logits| over the whole run
LOGITS_MAX_TOL = 0.5       # max |d logits| over the whole run
MARGIN_TOL = 0.5           # scan's top-1 margin where argmaxes differ


def greedy_margins(params, cfg: WaveNetConfig, token, tokens, y=None, g=None,
                   logits=None):
    """Teacher-force the scan reference along a greedy trajectory `tokens`
    [B, n] (consuming `token` first) from an empty state.  Returns a dict:
    the reference's top-1 margin over each chosen token (0 where they agree)
    and, given the trajectory's own `logits` [B, n, Q], their distance
    from the reference's."""
    from wavenet_tpu.models.conditioning import project_cond
    B = tokens.shape[0]
    consumed = jnp.concatenate([token[:, None], tokens[:, :-1]], axis=1)
    cond = None
    if y is not None:
        # the kernel's recipe for the mel term: bf16 inputs, f32 sums
        cond = project_cond(
            {"v_cond": params["v_cond"].astype(jnp.bfloat16)},
            y[:, :tokens.shape[1]].astype(jnp.bfloat16))
    ref = jax.jit(wn.decode_logits, static_argnums=1)(
        params, cfg, wn.decode_init(cfg, B), consumed, cond, g)
    top = jnp.max(ref, axis=-1)
    chosen = jnp.take_along_axis(ref, tokens[..., None], axis=-1)[..., 0]
    out = {"max_margin": float(jnp.max(top - chosen)),
           "argmax_mismatches": int(jnp.sum(jnp.argmax(ref, -1) != tokens)),
           "steps": int(tokens.size)}
    if logits is not None:
        d = jnp.abs(ref - logits)
        out.update(max_abs=float(d.max()), mean_abs=float(d.mean()),
                   first_steps_max_abs=float(d[:, :2].max()))
    return out


def compare_with_scan(params, cfg: WaveNetConfig, batch: int, n: int,
                      y=None, speaker=None) -> dict:
    """Greedy kernel decode of n steps against the scan reference: per-step
    logits and greedy choices (greedy_margins), plus `ok` under the module's
    tolerances."""
    g = None if speaker is None else wn.global_cond_offsets(params, cfg,
                                                            speaker)
    token = jnp.full((batch,), cfg.quantization_channels // 2, jnp.int32)
    _, _, toks, logits = decode_chunk(
        params, cfg, wn.decode_init(cfg, batch), token,
        jnp.zeros((batch,), jnp.int32), n, 0.0, y=y, g=g, emit_logits=True)
    out = greedy_margins(params, cfg, token, toks, y=y, g=g, logits=logits)
    out["finite"] = bool(jnp.isfinite(logits).all())
    out["ok"] = (out["finite"]
                 and out["mean_abs"] <= LOGITS_MEAN_TOL
                 and out["max_abs"] <= LOGITS_MAX_TOL
                 and out["max_margin"] <= MARGIN_TOL)
    return out


def init(params, cfg: WaveNetConfig, key, batch: int, prime_tokens=None,
         speaker=None, seeds=None):
    """Kernel-route prolog: empty state, the first token to consume, row
    seeds and speaker offsets.  Returns (state, token, seeds, g, skip) where
    skip = max(P-1, 0) leading outputs are priming steps."""
    g = None
    if cfg.global_classes is not None:
        if speaker is None:
            raise ValueError("cfg.global_classes set but no speaker ids passed")
        g = wn.global_cond_offsets(params, cfg, speaker)
    if prime_tokens is None:
        token = jnp.full((batch,), cfg.quantization_channels // 2, jnp.int32)
        P = 0
    else:
        token = prime_tokens[:, 0].astype(jnp.int32)
        P = prime_tokens.shape[1]
    if seeds is None:
        seeds = jax.random.randint(key, (), 0, 2 ** 31 - 1)
    seeds = rng.as_row_seeds(seeds, batch)
    return wn.decode_init(cfg, batch), token, seeds, g, max(P - 1, 0)


def stream(params, cfg: WaveNetConfig, key, num_samples: int,
           chunk_samples: int, batch: int = 1, prime_tokens=None, y=None,
           speaker=None, temperature: float = 1.0, seeds=None,
           interpret: bool = False, chunk_fn=None):
    """Yield [B, <=chunk_samples] token chunks; the concatenation equals
    one call over all steps (the RNG is keyed by the global step).

    y: [B, T, M] upsampled features covering max(P-1, 0) + num_samples.
    chunk_fn: decode_chunk's stand-in (the data-parallel fan-out passes its
    shard_map'd wrapper); None runs decode_chunk itself."""
    chunk_fn = chunk_fn or decode_chunk
    state, token, seeds, g, skip = init(params, cfg, key, batch,
                                        prime_tokens, speaker, seeds)
    total = skip + num_samples
    if y is not None and y.shape[1] < total:
        raise ValueError(f"y covers {y.shape[1]} < {total} steps "
                         f"(priming included)")
    t0 = 0
    while t0 < total:
        # the first chunk also runs the priming steps, whose outputs drop
        n = min((skip if t0 == 0 else 0) + chunk_samples, total - t0)
        forced = prime_tokens[:, :n] if (t0 == 0 and skip) else None
        y_c = None if y is None else y[:, t0:t0 + n]
        state, token, toks = chunk_fn(
            params, cfg, state, token, seeds, n, temperature,
            forced=forced, y=y_c, g=g, interpret=interpret)
        yield toks[:, skip:] if t0 == 0 else toks
        t0 += n


def generate(params, cfg: WaveNetConfig, key, num_samples: int,
             batch: int = 1, prime_tokens=None, y=None, speaker=None,
             temperature: float = 1.0, seeds=None,
             interpret: bool = False) -> jax.Array:
    """One-shot generation through the kernel: [B, num_samples] tokens."""
    (toks,) = stream(params, cfg, key, num_samples, num_samples, batch,
                     prime_tokens, y, speaker, temperature, seeds, interpret)
    return toks
