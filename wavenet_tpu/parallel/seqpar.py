"""Sequence (time-axis) parallelism via halo exchange — component P6.

The convolutional analogue of context parallelism (SURVEY.md §5.7): there is
no attention in WaveNet, so ring-attention/Ulysses do not apply.  Instead the
time axis is sharded across the `seq` mesh axis and each layer's causal shift
reads its left context from the previous shard's tail — ONE `ppermute` of
[B, maxd, R] per layer per step.  Activation memory per device is
O(T / seq_shards); the math is bit-identical to the unsharded forward because
the halo IS the exact missing left context (asserted in tests, per SURVEY.md
§7.4 "Causal alignment under sharding").

Implemented with `jax.shard_map` over ('data', 'seq'), with the `model` axis
left to GSPMD (auto) so tensor parallelism composes with halo exchange.

NOTE: partial-manual shard_map (axis_names a strict subset of the mesh) must
run under `jax.jit` in jax 0.9 — the eager dispatch path (`_shard_map_impl`
-> `_unmatch_spec`) constructs an internal PartitionSpec over ALL mesh axes
and fails its own manual-axes validation.  Every public function here is
therefore intended to be called inside a jitted computation (as the Trainer
does); tests document the same.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS


def _right_halo_fn(maxd: int):
    """Per-layer halo: shard i sends its last maxd samples to shard i+1.
    Shard 0 receives zeros (jax.lax.ppermute's unpaired-target semantics),
    which is exactly the causal zero left-padding at sequence start."""
    def halo(x):
        sp = jax.lax.axis_size(SEQ_AXIS)
        tail = x[:, -maxd:, :]
        return jax.lax.ppermute(
            tail, SEQ_AXIS, [(i, i + 1) for i in range(sp - 1)])
    return halo


def _prev_tokens_sp(tokens: jax.Array) -> jax.Array:
    """tokens[t-1] with the shard boundary value fetched from the left
    neighbor (shard 0 gets the zero token)."""
    sp = jax.lax.axis_size(SEQ_AXIS)
    boundary = jax.lax.ppermute(
        tokens[:, -1:], SEQ_AXIS, [(i, i + 1) for i in range(sp - 1)])
    return jnp.concatenate([boundary, tokens[:, :-1]], axis=1)


def check_seq_shardable(cfg: WaveNetConfig, mesh: Mesh, T: int) -> int:
    sp = mesh.shape[SEQ_AXIS]
    if cfg.kernel_size != 2:
        # refuse at ANY sp (incl. 1): the seq-parallel forward wires a
        # maxd-wide halo context, and a K>2 tap's (K-1)*maxd shift through
        # it would CLAMP in shift_right and silently miscompute
        raise ValueError("the sequence-parallel path is width-2 only (the "
                         "halo carries maxd samples and one prev token); "
                         "run kernel_size > 2 models through the plain "
                         "forward / data-parallel paths instead")
    if T % sp:
        raise ValueError(f"sequence length {T} not divisible by seq={sp}")
    local = T // sp
    if sp > 1 and local < cfg.max_dilation:
        raise ValueError(
            f"T/seq = {local} < max_dilation = {cfg.max_dilation}: halo would "
            f"span more than one neighbor; use fewer seq shards")
    return local


def forward_logits_sp(params: wn.Params, cfg: WaveNetConfig, mesh: Mesh,
                      tokens: jax.Array,
                      mel: Optional[jax.Array] = None,
                      speaker: Optional[jax.Array] = None) -> jax.Array:
    """Sequence-parallel forward: tokens [B, T] sharded (data, seq) ->
    logits [B, T, Q] sharded the same way.  speaker: [B] int32 class ids
    (required iff cfg.global_classes is set — time-constant, so the seq
    shards need no halo treatment for it)."""
    check_seq_shardable(cfg, mesh, tokens.shape[1])

    # Upsample conditioning BEFORE sharding time (frame->sample alignment
    # does not shard cleanly); the per-sample features then shard like tokens.
    y = None
    if cfg.mel is not None:
        from wavenet_tpu.models.conditioning import upsample_mel
        y = upsample_mel(params["upsampler"], cfg.mel, mel, tokens.shape[1])
    has_sp = speaker is not None
    if has_sp and cfg.global_classes is None:
        raise ValueError("speaker ids passed but cfg.global_classes unset")

    def fwd(params, tokens, y, speaker):
        return wn.forward_logits(
            params, cfg, tokens,
            prev_tokens=_prev_tokens_sp(tokens),
            halo_fn=_right_halo_fn(cfg.max_dilation),
            upsampled_cond=y,
            speaker=speaker if has_sp else None)

    in_specs = (P(), P(DATA_AXIS, SEQ_AXIS),
                P(DATA_AXIS, SEQ_AXIS, None) if y is not None else P(),
                P(DATA_AXIS) if has_sp else P())
    out_specs = P(DATA_AXIS, SEQ_AXIS, None)
    if not has_sp:
        speaker = jnp.zeros((tokens.shape[0],), jnp.int32)  # placeholder
    return jax.shard_map(
        fwd, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        axis_names=frozenset({DATA_AXIS, SEQ_AXIS}),   # `model` stays GSPMD
        check_vma=False,
    )(params, tokens, y, speaker)


def _loss_sums(logits, targets):
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    correct = (jnp.argmax(logits, -1) == targets).astype(jnp.float32)
    return jnp.stack([jnp.sum(nll), jnp.sum(correct)])[None]       # [1, 2]


def _metrics(sums, n_tokens):
    total = jnp.sum(sums, axis=0)
    n = jnp.asarray(n_tokens, jnp.float32)
    loss = total[0] / n
    return loss, {"loss": loss, "bits_per_sample": loss / jnp.log(2.0),
                  "accuracy": total[1] / n}


def loss_fn_sp(params: wn.Params, cfg: WaveNetConfig, mesh: Mesh,
               inputs: jax.Array, targets: jax.Array,
               mel: Optional[jax.Array] = None,
               speaker: Optional[jax.Array] = None,
               ) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Sequence-parallel training loss.

    Takes pre-split (inputs, targets) = (window[:, :-1], window[:, 1:]) both
    [B, W] so each shards evenly on (data, seq) — the +1 overlap of the
    training window does not shard, so the host supplies both views.
    """
    check_seq_shardable(cfg, mesh, inputs.shape[1])
    y = None
    if cfg.mel is not None:
        from wavenet_tpu.models.conditioning import upsample_mel
        y = upsample_mel(params["upsampler"], cfg.mel, mel, inputs.shape[1])

    def local_sums(params, inputs, targets, y, speaker):
        """Per-shard partial sums; reduced OUTSIDE the shard_map because
        jax 0.9 partial-manual shard_map rejects outputs replicated over the
        manual axes (out_specs P() errors with "refers to <auto axis>")."""
        logits = wn.forward_logits(
            params, cfg, inputs,
            prev_tokens=_prev_tokens_sp(inputs),
            halo_fn=_right_halo_fn(cfg.max_dilation),
            upsampled_cond=y,
            speaker=speaker)
        return _loss_sums(logits, targets)

    in_specs = (P(), P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, SEQ_AXIS),
                P(DATA_AXIS, SEQ_AXIS, None) if y is not None else P(),
                P(DATA_AXIS) if speaker is not None else P())
    sums = jax.shard_map(
        local_sums, mesh=mesh, in_specs=in_specs,
        out_specs=P((DATA_AXIS, SEQ_AXIS), None),      # [dp*sp, 2] sharded
        axis_names=frozenset({DATA_AXIS, SEQ_AXIS}),   # `model` stays GSPMD
        check_vma=False,
    )(params, inputs, targets, y, speaker)
    return _metrics(sums, inputs.size)
