"""WaveNet model core.

Implements the architecture of WaveNet (arXiv:1609.03499 §2.1-2.5):
causal embed -> N x (dilated causal conv -> gated tanh (*) sigmoid -> 1x1
residual + 1x1 skip) -> skip-sum -> ReLU -> 1x1 -> ReLU -> 1x1 -> Q-way logits,
with optional mel local conditioning entering the gate (paper eq.3).

Design (NOT a port of the Chainer reference; see SURVEY.md §7):
  * Layout is [B, T, C] (channels-last).  The k=2 dilated conv is
    two matmuls: x[t] @ W_cur + x[t-d] @ W_prev, with the shift done by a
    static-shape dynamic_slice (ops/shift.py).  Filter and gate are fused into
    one matmul of output width 2R.
  * The causal k=2 "embedding conv" over one-hot inputs is algebraically an
    embedding-table lookup: E_cur[x[t]] + E_prev[x[t-1]].  We implement it as
    two gathers — mathematically identical, far cheaper than a conv on a
    one-hot [B, Q, T] tensor.
  * All layers share channel widths, so per-layer params are STACKED along a
    leading L axis and the stack runs as one `lax.scan` (fast compiles, clean
    rematerialisation via jax.checkpoint when cfg.remat).
  * Fast AR decode (arXiv:1611.09482 §2; 1704.06001 §3) keeps a ring buffer
    per layer holding that layer's input from t-d; one sample = one scan step
    over layers, the whole generation loop is a single compiled `lax.scan`.

Params are a plain pytree (dict) — trivially shardable with NamedSharding and
saveable as .npz (utils/pytree_io.py).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.ops.shift import shift_right

Params = Dict[str, Any]


def _dtype(cfg: WaveNetConfig):
    return jnp.dtype(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: WaveNetConfig, key: jax.Array) -> Params:
    """Initialize the parameter pytree.

    Shapes (L = num_layers, R = residual, S = skip, Q = quantization, E = embed):
      embed_cur, embed_prev: [Q, E]
      w_cur, w_prev: [L, R, 2, R]  (filter/gate on a separate axis of size 2,
          NOT fused as [R, 2R]: with a distinct gate axis, tensor-parallel
          sharding of the last dim keeps tanh(z_f) * sigmoid(z_g) shard-local,
          since z_f and z_g shard with identical boundaries)
      b:            [L, 2, R]
      w_res: [L, R, R]   b_res: [L, R]
      w_skip:[L, R, S]   b_skip:[L, S]
      head: w1 [S, S], b1 [S], w2 [S, Q], b2 [Q]
      (conditional) v_cond: [L, M, 2, R]; upsampler convs.
      (kernel_size K > 2) w_prevk: [L, K-2, R, 2, R] — extra conv taps at
          distances 2d..(K-1)d (tap j at index j-2); embed_prevk:
          [K-2, Q, E] — extra embed-conv taps at t-2..t-(K-1).  Absent for
          K == 2, so existing checkpoints load unchanged.
    """
    L = cfg.num_layers
    R = cfg.residual_channels
    S = cfg.skip_channels
    Q = cfg.quantization_channels
    E = cfg.embed_channels
    pdt = jnp.dtype(cfg.param_dtype)

    ks = jax.random.split(key, 16)
    glorot = jax.nn.initializers.glorot_uniform()

    def ginit(k, shape):
        # stacked glorot: leading L (and the gate axis) are batch dims;
        # fan-in/out from the first/last dims
        fan_in, fan_out = shape[-2], shape[-1]
        if len(shape) == 4:                    # [L, R, 2, R]
            fan_in = shape[1]
        elif len(shape) == 5:                  # [L, K-2, R, 2, R]
            fan_in = shape[2]
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        return jax.random.uniform(k, shape, pdt, -limit, limit)

    params: Params = {
        "embed_cur": jax.random.normal(ks[0], (Q, E), pdt) * 0.05,
        "embed_prev": jax.random.normal(ks[1], (Q, E), pdt) * 0.05,
        "w_cur": ginit(ks[2], (L, R, 2, R)),
        "w_prev": ginit(ks[3], (L, R, 2, R)),
        "b": jnp.zeros((L, 2, R), pdt),
        "w_res": ginit(ks[4], (L, R, R)),
        "b_res": jnp.zeros((L, R), pdt),
        "w_skip": ginit(ks[5], (L, R, S)),
        "b_skip": jnp.zeros((L, S), pdt),
        "head_w1": ginit(ks[6], (S, S)),
        "head_b1": jnp.zeros((S,), pdt),
        "head_w2": ginit(ks[7], (S, Q)),
        "head_b2": jnp.zeros((Q,), pdt),
    }
    if cfg.kernel_size > 2:
        K = cfg.kernel_size
        params["w_prevk"] = ginit(ks[13], (L, K - 2, R, 2, R))
        params["embed_prevk"] = (
            jax.random.normal(ks[14], (K - 2, Q, E), pdt) * 0.05)
    if E != R:
        params["w_embed_proj"] = ginit(ks[8], (E, R))
    if cfg.mel is not None:
        M = cfg.mel.num_mels
        params["v_cond"] = ginit(ks[9], (L, M, 2, R))
        # head conditioning is not in the paper; gate-only per eq.3.
        from wavenet_tpu.models.conditioning import init_upsampler_params
        params["upsampler"] = init_upsampler_params(cfg.mel, ks[10], pdt)
    if cfg.global_classes is not None:
        G = cfg.global_channels
        params["g_embed"] = jax.random.normal(
            ks[11], (cfg.global_classes, G), pdt) * 0.05
        params["v_global"] = ginit(ks[12], (L, G, 2, R))
    return params


def global_cond_offsets(params: Params, cfg: WaveNetConfig,
                        speaker: jax.Array) -> jax.Array:
    """Per-utterance class ids [B] -> per-layer gate offsets [L, B, 2, R] f32.

    Paper §2.5 eq.2: z gains V^T h with h the (time-constant) global
    conditioning vector — per layer that is ONE [B, 2R] offset, computed once
    and broadcast over time, never materialized at [B, T, .]."""
    cdt = _dtype(cfg)
    gvec = params["g_embed"][speaker].astype(cdt)            # [B, G]
    return jnp.einsum("bg,lgwr->lbwr", gvec,
                      params["v_global"].astype(cdt),
                      preferred_element_type=jnp.float32)


def dilation_array(cfg: WaveNetConfig) -> jax.Array:
    return jnp.asarray(cfg.dilations, dtype=jnp.int32)


def _stacked_layer_params(params: Params):
    keys = ["w_cur", "w_prev", "b", "w_res", "b_res", "w_skip", "b_skip"]
    if "w_prevk" in params:                       # kernel_size > 2 taps
        keys.append("w_prevk")
    return {k: params[k] for k in keys}


def _dot(a, b, out_dtype=jnp.float32):
    """Matmul; accumulation dtype selectable (f32 default)."""
    return jax.lax.dot_general(
        a, b, (((a.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=out_dtype)


# ---------------------------------------------------------------------------
# Embedding (the causal k=2 "embed conv")
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, cfg: WaveNetConfig,
                 tokens: jax.Array, prev_tokens: jax.Array,
                 prev_extra: Optional[jax.Array] = None) -> jax.Array:
    """E_cur[tokens] + E_prev[prev_tokens] -> residual stream [.., R].

    Deliberately a GATHER, not a one-hot matmul: a matmul at DEFAULT
    precision rounds the f32 tables (to bf16 or TF32), so the embedding
    would depend on the backend's lowering; the gather selects exactly.

    prev_extra: for kernel_size K > 2, the [K-2, *tokens.shape] int32 tokens
    at t-2..t-(K-1) (the extra taps of the width-K embed conv); all taps sum
    in the f32 table dtype with ONE rounding to compute dtype, keeping the
    numerics recipe of the K=2 path."""
    cdt = _dtype(cfg)
    x = (params["embed_cur"][tokens] + params["embed_prev"][prev_tokens])
    ek = params.get("embed_prevk")
    if ek is not None:
        if prev_extra is None:
            raise ValueError("kernel_size > 2 model: embed_tokens needs the "
                             "prev_extra taps (tokens at t-2..t-(K-1))")
        for j in range(ek.shape[0]):
            x = x + ek[j][prev_extra[j]]
    x = x.astype(cdt)
    if "w_embed_proj" in params:
        x = _dot(x, params["w_embed_proj"].astype(cdt)).astype(cdt)
    return x


def _shifted_tokens(tokens: jax.Array) -> jax.Array:
    """prev_tokens[t] = tokens[t-1], with a leading zero-token."""
    return jnp.pad(tokens[:, :-1], ((0, 0), (1, 0)))


def _shifted_tokens_extra(tokens: jax.Array, K: int) -> jax.Array:
    """[K-2, B, T] with entry j-2 holding tokens[t-j], zero-token filled
    before sequence start — the extra embed-conv taps for kernel_size K > 2
    (matches the zero left-fill convention of _shifted_tokens and the
    decode state's zero-initialized prev history).  Pad-then-slice keeps
    the width at T even when T <= j (tokens[:, :-j] would under-slice)."""
    T = tokens.shape[1]
    return jnp.stack([jnp.pad(tokens, ((0, 0), (j, 0)))[:, :T]
                      for j in range(2, K)])


# ---------------------------------------------------------------------------
# Full-sequence forward (training / naive generation)
# ---------------------------------------------------------------------------

def _layer_step(cfg: WaveNetConfig, x, skip, lp, d, left_ctx, cond,
                gcond=None):
    """One gated residual block over a full sequence.

    x: [B, T, R] (compute dtype);  skip: [B, T, S] (f32 accumulator)
    lp: per-layer params;  d: traced dilation;  left_ctx: [B, maxd, R]
    cond: None or [B, T, 2R] precomputed conditioning contribution (f32).
    gcond: None or [B, 2, R] global-conditioning gate offset (f32),
      broadcast over time (paper §2.5 eq.2).
    """
    cdt = _dtype(cfg)
    x_prev = shift_right(x, d, left_ctx)
    # Gate math in f32: matmul inputs are bf16 but z, the activations, and
    # the skip accumulator stay f32 — the same recipe as the decode kernel
    # (ops/pallas/decode_gpu.py), so scan and kernel stay numerically
    # aligned.
    z = (_dot(x, lp["w_cur"].astype(cdt))
         + _dot(x_prev, lp["w_prev"].astype(cdt)))
    wk = lp.get("w_prevk")                       # kernel_size K > 2 taps
    if wk is not None:                           # at distances 2d..(K-1)d;
        for j in range(wk.shape[0]):             # addition order mirrors
            z = z + _dot(shift_right(x, (j + 2) * d, left_ctx),  # decode_step
                         wk[j].astype(cdt))      # so fast == naive holds
    z = z + lp["b"].astype(jnp.float32)          # [B, T, 2, R] f32
    if cond is not None:
        z = z + cond
    if gcond is not None:
        z = z + gcond[:, None]                   # broadcast over T
    h = (jnp.tanh(z[..., 0, :]) * jax.nn.sigmoid(z[..., 1, :])).astype(cdt)
    skip = skip + _dot(h, lp["w_skip"].astype(cdt)) + lp["b_skip"].astype(jnp.float32)
    # residual update with ONE explicit f32 accumulate + ONE rounding: a
    # bf16 + bf16 formulation is backend-dependent (a compiler may elide
    # the intermediate round through excess precision), so the single-round
    # form is the recipe shared by the scan path and the decode kernel
    x = (x.astype(jnp.float32)
         + _dot(h, lp["w_res"].astype(cdt))
         + lp["b_res"].astype(jnp.float32)).astype(cdt)
    return x, skip


def forward_logits(params: Params, cfg: WaveNetConfig, tokens: jax.Array,
                   mel: Optional[jax.Array] = None,
                   prev_tokens: Optional[jax.Array] = None,
                   halo_fn=None,
                   upsampled_cond: Optional[jax.Array] = None,
                   speaker: Optional[jax.Array] = None,
                   valid_mask: Optional[jax.Array] = None,
                   prev_tokens_extra: Optional[jax.Array] = None) -> jax.Array:
    """Logits for next-sample prediction at every position.

    Args:
      tokens: [B, T] int32 mu-law ids (model input; logits[t] predicts t+1).
      mel:    [B, F, M] mel frames when cfg.mel (F*hop >= T), else None.
      speaker: [B] int32 global-conditioning class ids when
        cfg.global_classes, else None.
      valid_mask: optional [B, T] 0/1 mask marking which positions EXIST.
        Zeroing the residual stream at masked positions before every layer
        makes each dilated read of a masked position return exactly the
        zero left-padding a shorter sequence would have seen — so logits at
        valid positions are bit-identical to running forward_logits on just
        the valid suffix.  Used by generate_naive's fixed-width sliding
        window while its history is still shorter than the window (the
        window must not hallucinate tokens before the sequence start).
        Callers must put the zero-token in prev_tokens at the first valid
        position (a left-fill of token 0 does this).  None => all valid.
      prev_tokens: optional [B, T] tokens at t-1; defaults to tokens shifted
        right with a zero at t=0.  Sequence-parallel callers pass the halo'd
        version (last token of the previous time-shard at position 0).
      halo_fn: optional fn [B, maxd, R]-producing the left context of a layer
        input x ([B, T, R]).  None => zeros (sequence start).  The
        seq-parallel path passes a ppermute of x[:, -maxd:, :]
        (parallel/seqpar.py), which keeps the math bit-identical to the
        unsharded forward — the halo IS the missing left context.
      upsampled_cond: optional [B, T, M] pre-upsampled conditioning features
        (used by the seq-parallel path where upsampling happens before the
        time axis is sharded); mutually exclusive with `mel`.
      prev_tokens_extra: kernel_size K > 2 only — optional [K-2, B, T]
        tokens at t-2..t-(K-1) (defaults to zero-filled shifts of `tokens`,
        the sequence-start convention); the naive oracle passes its sliding
        window's true history here, like prev_tokens.
    Returns:
      [B, T, Q] float32 logits.
    """
    cdt = _dtype(cfg)
    B, T = tokens.shape
    R = cfg.residual_channels
    maxd = cfg.max_dilation
    K = cfg.kernel_size

    prev = _shifted_tokens(tokens) if prev_tokens is None else prev_tokens
    prev_extra = None
    if K > 2:
        prev_extra = (_shifted_tokens_extra(tokens, K)
                      if prev_tokens_extra is None else prev_tokens_extra)
    x = embed_tokens(params, cfg, tokens, prev, prev_extra)  # [B, T, R]
    skip = jnp.zeros((B, T, cfg.skip_channels), jnp.float32)

    cond_all = None
    if cfg.mel is not None:
        if upsampled_cond is not None:
            y = upsampled_cond
        elif mel is not None:
            from wavenet_tpu.models.conditioning import upsample_mel
            y = upsample_mel(params["upsampler"], cfg.mel, mel, T)  # [B, T, M]
        else:
            raise ValueError("cfg.mel set but no mel features passed")
        # Per-layer conditioning projections, stacked: [L, B, T, 2, R]
        cond_all = jnp.einsum(
            "btm,lmgr->lbtgr", y.astype(cdt), params["v_cond"].astype(cdt),
            preferred_element_type=jnp.float32)

    dils = dilation_array(cfg)
    # left context spans the deepest tap's reach: (K-1)*maxd (== maxd for
    # the paper's K=2; shift_right slices from the context's tail)
    zeros_ctx = jnp.zeros((B, (K - 1) * maxd, R), cdt)

    # Per-layer scanned inputs as a dict pytree; optional entries only present
    # when used, so the common path carries no dead weight.
    xs: Dict[str, Any] = {"lp": _stacked_layer_params(params), "d": dils}
    if cond_all is not None:
        xs["cond"] = cond_all
    if cfg.global_classes is not None:
        if speaker is None:
            raise ValueError("cfg.global_classes set but no speaker ids passed")
        xs["gcond"] = global_cond_offsets(params, cfg, speaker)  # [L, B, 2, R]

    vmask = None
    if valid_mask is not None:
        vmask = valid_mask.astype(cdt)[:, :, None]            # [B, T, 1]

    def body(carry, per_layer):
        x, skip = carry
        # masking the CARRY (not just the embed) re-zeroes masked positions
        # after each residual update, so every layer's dilated reads see the
        # zero padding of the equivalent shorter sequence
        if vmask is not None:
            x = x * vmask
        ctx = zeros_ctx if halo_fn is None else halo_fn(x)
        x, skip = _layer_step(cfg, x, skip, per_layer["lp"], per_layer["d"],
                              ctx, per_layer.get("cond"),
                              gcond=per_layer.get("gcond"))
        return (x, skip), None

    body_fn = jax.checkpoint(body) if cfg.remat else body
    (x, skip), _ = jax.lax.scan(body_fn, (x, skip), xs)

    return head_logits(params, cfg, skip)


def head_logits(params: Params, cfg: WaveNetConfig, skip: jax.Array) -> jax.Array:
    """skip-sum -> ReLU -> 1x1 -> ReLU -> 1x1 (paper §2.4 Fig 4)."""
    h = jax.nn.relu(skip)
    h = jax.nn.relu(_dot(h.astype(_dtype(cfg)), params["head_w1"].astype(_dtype(cfg)))
                    + params["head_b1"].astype(jnp.float32))
    logits = (_dot(h.astype(_dtype(cfg)), params["head_w2"].astype(_dtype(cfg)))
              + params["head_b2"].astype(jnp.float32))
    return logits


def loss_fn(params: Params, cfg: WaveNetConfig, tokens: jax.Array,
            mel: Optional[jax.Array] = None,
            speaker: Optional[jax.Array] = None,
            ) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Next-sample softmax cross-entropy over a [B, W] token window.

    Inputs are tokens[:, :-1], targets tokens[:, 1:] — matching the
    reference's training objective (SURVEY.md §3.1).
    """
    inputs = tokens[:, :-1]
    targets = tokens[:, 1:]
    logits = forward_logits(params, cfg, inputs, mel=mel, speaker=speaker)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    loss = jnp.mean(nll)
    aux = {
        "loss": loss,
        "bits_per_sample": loss / jnp.log(2.0),
        "accuracy": jnp.mean(
            (jnp.argmax(logits, -1) == targets).astype(jnp.float32)),
    }
    return loss, aux


def reference_loss_fn(params: Params, cfg: WaveNetConfig, tokens: jax.Array,
                      mel: Optional[jax.Array] = None,
                      speaker: Optional[jax.Array] = None
                      ) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """The float32 reference of loss_fn: activations in float32 and every
    matmul at `highest` precision (no bf16, no TF32 on a GPU).  The timed
    bf16 path is compared with it within a stated tolerance."""
    with jax.default_matmul_precision("highest"):
        return loss_fn(params, cfg.replace(compute_dtype="float32"), tokens,
                       mel=mel, speaker=speaker)


def score_fn(params: Params, cfg: WaveNetConfig, tokens: jax.Array,
             mel: Optional[jax.Array] = None,
             speaker: Optional[jax.Array] = None) -> jax.Array:
    """Per-utterance teacher-forced score: mean next-sample negative
    log-likelihood in BITS per sample, shape [B] — the quantity loss_fn
    averages over the batch, exposed per clip for evaluation / model
    comparison.  tokens: [B, T+1] mu-law ids."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = forward_logits(params, cfg, inputs, mel=mel, speaker=speaker)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll, axis=-1) / jnp.log(2.0)


# ---------------------------------------------------------------------------
# Fast AR decode (cached ring-buffer queues)
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Carried state of the fast decoder (arXiv:1611.09482 Fig 2).

    Ring buffers use the COMPACT layout [sum(dilations), B, R]: layer l's
    ring occupies rows [offset_l, offset_l + d_l) and its slot at step t is
    offset_l + (t mod d_l) — the row holds layer l's *input* from step
    t - d_l, is read at step t, then overwritten with the current input to
    be consumed at step t + d_l.  Compact rings cost sum(d) rows instead of
    L * max(d) (5x smaller for the full preset) and make per-step access one
    leading-axis gather + one scatter (see decode_step).
    """
    queues: jax.Array          # [sum_d, B, R] compute-dtype ring buffers
    prev_token: jax.Array      # [B] int32 token at t-1 (kernel_size 2);
                               # [B, K-1] token history for wider kernels
    t: jax.Array               # scalar int32 step counter


def ring_offsets(cfg: WaveNetConfig):
    """Static per-layer ring offsets and the total ring length.

    Layer l's ring is d_l*(kernel_size-1) rows long — exactly the history a
    width-K dilated conv must hold (K-1 taps at distances d..(K-1)d); for
    the paper's K=2 that is the familiar length-d FIFO."""
    offs, acc = [], 0
    taps = cfg.kernel_size - 1
    for d in cfg.dilations:
        offs.append(acc)
        acc += d * taps
    return tuple(offs), acc


def decode_init(cfg: WaveNetConfig, batch: int) -> DecodeState:
    _, sum_d = ring_offsets(cfg)
    K = cfg.kernel_size
    # prev_token: [B] for K == 2 (the shipped presets / kernel contract);
    # [B, K-1] for wider kernels — column j-1 holds the token at t-j,
    # zero-token before sequence start (the naive oracle's left-fill)
    prev = (jnp.zeros((batch,), jnp.int32) if K == 2
            else jnp.zeros((batch, K - 1), jnp.int32))
    return DecodeState(
        queues=jnp.zeros((sum_d, batch, cfg.residual_channels), _dtype(cfg)),
        prev_token=prev,
        t=jnp.zeros((), jnp.int32),
    )


def decode_step(params: Params, cfg: WaveNetConfig, state: DecodeState,
                token: jax.Array,
                cond_t: Optional[jax.Array] = None,
                gcond: Optional[jax.Array] = None,
                ) -> Tuple[DecodeState, jax.Array]:
    """Advance one sample: consume `token` ([B] int32), return logits [B, Q]
    for the *next* sample plus updated state.  O(layers) work — the fast
    generation algorithm of arXiv:1611.09482 §2 / 1704.06001 §3.

    cond_t: optional [B, L, 2, R] f32 conditioning contribution at this step
    (precomputed einsum of upsampled mel with v_cond).
    gcond: optional [L, B, 2, R] f32 global-conditioning gate offsets
    (global_cond_offsets; time-constant, so one array serves every step).
    """
    cdt = _dtype(cfg)
    R = cfg.residual_channels
    B = token.shape[0]
    K = cfg.kernel_size
    if K == 2:
        x = embed_tokens(params, cfg, token, state.prev_token)   # [B, R]
    else:
        x = embed_tokens(params, cfg, token, state.prev_token[:, 0],
                         jnp.moveaxis(state.prev_token[:, 1:], 1, 0))
    skip = jnp.zeros((B, cfg.skip_channels), jnp.float32)
    dils = dilation_array(cfg)
    stacked = _stacked_layer_params(params)
    t = state.t

    # Ring-buffer access is hoisted OUT of the layer scan: one gather of all
    # layers' reads and one scatter of all writes per sample, each touching
    # only [L, B, R] rows of the compact [sum_d, B, R] buffer.  (Passing the
    # queues through the scan as xs/ys makes XLA materialise a full queue
    # copy every sample — measured HBM-bandwidth-bound on the fastgen preset
    # before this restructure.  The scatter updates the donated carry in
    # place.)
    offs = jnp.asarray(ring_offsets(cfg)[0], jnp.int32)
    if K == 2:
        slots = offs + jnp.mod(t, dils)                      # [L]
        old_all = state.queues[slots]                        # [L, B, R]
    else:
        # width-K rings (length d*(K-1)): write at t mod len; tap j reads the
        # input from step t-j*d at (t-j*d) mod len — at t < j*d that slot is
        # provably unwritten and holds the zero left-padding (ring_offsets
        # docstring); the deepest tap (j = K-1) aliases the write slot,
        # which is exactly the read-before-overwrite FIFO semantics
        ring_len = dils * (K - 1)                            # [L]
        slots = offs + jnp.mod(t, ring_len)                  # write slots
        taps = jnp.arange(1, K, dtype=jnp.int32)[:, None]    # [K-1, 1]
        read = offs + jnp.mod(t - taps * dils, ring_len)     # [K-1, L]
        old_all = jnp.moveaxis(state.queues[read], 0, 1)     # [L, K-1, B, R]

    def body(carry, per_layer):
        x, skip = carry
        lp = per_layer["lp"]
        if K == 2:
            x_prev = per_layer["old"].astype(cdt)
            # identical dtype path to _layer_step so fast == naive per-step
            z = (_dot(x, lp["w_cur"].astype(cdt))
                 + _dot(x_prev, lp["w_prev"].astype(cdt))
                 + lp["b"].astype(jnp.float32))  # [B, 2, R] f32
        else:
            old = per_layer["old"]               # [K-1, B, R]
            z = (_dot(x, lp["w_cur"].astype(cdt))
                 + _dot(old[0].astype(cdt), lp["w_prev"].astype(cdt)))
            for j in range(K - 2):               # taps at 2d..(K-1)d, same
                z = z + _dot(old[j + 1].astype(cdt),   # order as _layer_step
                             lp["w_prevk"][j].astype(cdt))
            z = z + lp["b"].astype(jnp.float32)  # [B, 2, R] f32
        if "cond" in per_layer:
            z = z + per_layer["cond"]
        if "gcond" in per_layer:
            z = z + per_layer["gcond"]
        h = (jnp.tanh(z[..., 0, :]) * jax.nn.sigmoid(z[..., 1, :])).astype(cdt)
        skip = skip + _dot(h, lp["w_skip"].astype(cdt)) + lp["b_skip"].astype(jnp.float32)
        # single-round residual update — see _layer_step for why
        x_out = (x.astype(jnp.float32)
                 + _dot(h, lp["w_res"].astype(cdt))
                 + lp["b_res"].astype(jnp.float32)).astype(cdt)
        return (x_out, skip), x            # ys: this layer's INPUT -> queue

    xs: Dict[str, Any] = {"lp": stacked, "old": old_all}
    if cond_t is not None:
        xs["cond"] = jnp.moveaxis(cond_t, 0, 1)   # [L, B, 2, R]
    if gcond is not None:
        xs["gcond"] = gcond                       # already [L, B, 2, R]
    # decode_unroll > 1 shortens the serialized-layer critical path this
    # scan compiles to (the measured bound on wide configs — see the
    # config.py field comment); clamp to L so tiny test configs stay valid
    (x, skip), layer_inputs = jax.lax.scan(
        body, (x, skip), xs,
        unroll=min(cfg.decode_unroll, len(dils)))

    # one scatter for all layers' rows
    new_queues = state.queues.at[slots].set(
        layer_inputs.astype(state.queues.dtype))

    logits = head_logits(params, cfg, skip)                  # [B, Q]
    new_prev = (token if K == 2 else
                jnp.concatenate([token[:, None], state.prev_token[:, :-1]],
                                axis=1))                     # push history
    new_state = DecodeState(queues=new_queues, prev_token=new_prev, t=t + 1)
    return new_state, logits


def decode_logits(params: Params, cfg: WaveNetConfig, state: DecodeState,
                  tokens: jax.Array, cond: Optional[jax.Array] = None,
                  gcond: Optional[jax.Array] = None) -> jax.Array:
    """Teacher-forced decode: consume tokens [B, n] one step at a time from
    `state` and return each step's logits [B, n, Q] — the scan reference a
    decode kernel's per-step logits are compared with.  cond: optional
    [B, n, L, 2, R] per-step conditioning for these steps."""
    def body(state, xs):
        tok, cond_t = xs
        return decode_step(params, cfg, state, tok, cond_t=cond_t,
                           gcond=gcond)

    cond_steps = None if cond is None else jnp.moveaxis(cond, 1, 0)
    _, logits = jax.lax.scan(body, state, (tokens.T, cond_steps))
    return jnp.moveaxis(logits, 0, 1)


def generate(params: Params, cfg: WaveNetConfig, key: jax.Array,
             num_samples: int, batch: int = 1,
             prime_tokens: Optional[jax.Array] = None,
             cond: Optional[jax.Array] = None,
             speaker: Optional[jax.Array] = None,
             temperature: float = 1.0,
             seeds: Optional[jax.Array] = None) -> jax.Array:
    """Autoregressively sample `num_samples` mu-law tokens.

    The entire loop — priming and sampling — is ONE compiled lax.scan; no
    per-sample host dispatch (SURVEY.md §7.4 "Dispatch-bound decode").

    Args:
      prime_tokens: optional [B, P] context to condition on (teacher-forced
        through the queues before free-running).
      cond: optional [B, total_T, L, 2, R] per-step conditioning
        contributions, where total_T must cover ALL decode steps:
        max(P-1, 0) + num_samples (the conditioning timeline spans the
        priming context too — queues built without it would be wrong).
      speaker: optional [B] int32 global-conditioning ids (cfg.global_classes).
      seeds: optional per-row counter-RNG seeds (decode_sample_chunk);
        overrides `key`-based sampling with the shared ops/rng.py hash.
    Returns:
      [B, num_samples] int32 sampled tokens.
    """
    state, first, gcond = decode_prime(params, cfg, batch, prime_tokens,
                                       cond=cond, speaker=speaker,
                                       num_samples=num_samples)
    _, _, samples = decode_sample_chunk(params, cfg, state, first, key, 0,
                                        num_samples, cond=cond, gcond=gcond,
                                        temperature=temperature, seeds=seeds)
    return samples                                           # [B, num_samples]


def decode_prime(params: Params, cfg: WaveNetConfig, batch: int,
                 prime_tokens: Optional[jax.Array],
                 cond: Optional[jax.Array] = None,
                 speaker: Optional[jax.Array] = None,
                 num_samples: int = 0):
    """Build the decode state ready to free-run: teacher-force all but the
    last priming token (the last one seeds sampling), or seed with the
    mid-scale silence token.  Returns (state, seed_token [B], gcond).

    `generate` == decode_prime + one decode_sample_chunk; the streaming
    fallback (generate/sampler.py) calls decode_sample_chunk repeatedly —
    the shared primitive is what makes chunked == one-shot exact."""
    state = decode_init(cfg, batch)
    gcond = None
    if cfg.global_classes is not None:
        if speaker is None:
            raise ValueError("cfg.global_classes set but no speaker ids passed")
        gcond = global_cond_offsets(params, cfg, speaker)    # [L, B, 2, R]
    P = 0 if prime_tokens is None else prime_tokens.shape[1]
    total_steps = max(P - 1, 0) + num_samples
    if cond is not None and cond.shape[1] < total_steps:
        raise ValueError(
            f"cond covers {cond.shape[1]} steps < required {total_steps} "
            f"(= max(P-1,0) + num_samples with P={P} priming tokens); size "
            f"the conditioning to the full timeline including priming")

    def prime_body(carry, tok_t):
        state = carry
        cond_t = None if cond is None else cond[:, state.t]
        state, _ = decode_step(params, cfg, state, tok_t, cond_t=cond_t,
                               gcond=gcond)
        return state, None

    if P > 0:
        # feed all but the last priming token; the last one seeds sampling
        state, _ = jax.lax.scan(prime_body, state,
                                jnp.moveaxis(prime_tokens[:, :-1], 1, 0))
        first = prime_tokens[:, -1]
    else:
        first = jnp.zeros((batch,), jnp.int32) + cfg.quantization_channels // 2
    return state, first, gcond


def decode_sample_chunk(params: Params, cfg: WaveNetConfig,
                        state: "DecodeState", first: jax.Array,
                        key: jax.Array, i0: int, n: int,
                        cond: Optional[jax.Array] = None,
                        gcond: Optional[jax.Array] = None,
                        temperature: float = 1.0,
                        cond_t0=0,
                        seeds: Optional[jax.Array] = None):
    """Scan `n` free-running sampling steps whose ABSOLUTE sample indices are
    i0..i0+n-1 (the per-step RNG is fold_in(key, absolute_i), so splitting a
    run into chunks cannot change the sample path).  cond is indexed by the
    state's own step counter minus cond_t0 — a chunked caller passes just
    this chunk's cond slice with cond_t0 = the absolute decode step of its
    first row, keeping streaming memory bounded by one chunk.

    seeds: optional [B] int32 per-row seeds switching sampling to the
    COUNTER RNG (ops/rng.py) keyed by (row seed, global step, class) — the
    same hash the decode kernel and the collective decoder draw from, so
    this path samples token-identical trajectories whenever the logits
    bit-match (bfloat16 compute), and each row's draws are independent of
    co-batched rows.  `key` is ignored in that mode (chunking stays exact:
    state.t is the global step).
    Returns (state, next_seed_token, samples [B, n])."""
    from wavenet_tpu.ops import rng as _rng

    def sample_body(carry, i):
        state, token = carry
        tkey = state.t      # GLOBAL step consuming `token`
        cond_t = None if cond is None else cond[:, state.t - cond_t0]
        state, logits = decode_step(params, cfg, state, token, cond_t=cond_t,
                                    gcond=gcond)
        # greedy only for a STATIC temperature == 0: a traced temperature
        # (e.g. jitted sweep argument) must keep taking the division path
        # Python control flow cannot branch on
        if isinstance(temperature, (int, float)) and temperature <= 0:
            nxt = jnp.argmax(logits, axis=-1)    # greedy — matches the
        elif seeds is not None:                  # decode kernel's greedy mode
            g = _rng.counter_gumbel(seeds[:, None], tkey, 0, logits.shape,
                                    class_axis=1)
            nxt = jnp.argmax(logits * (1.0 / temperature) + g, axis=-1)
        else:
            k = jax.random.fold_in(key, i)
            nxt = jax.random.categorical(k, logits / temperature, axis=-1)
        return (state, nxt.astype(jnp.int32)), nxt.astype(jnp.int32)

    (state, nxt), samples = jax.lax.scan(sample_body, (state, first),
                                         i0 + jnp.arange(n))
    return state, nxt, jnp.moveaxis(samples, 0, 1)           # [B, n]
