"""Mel-spectrogram local conditioning (WaveNet paper arXiv:1609.03499 §2.5).

The conditioning signal y (mel frames at sample_rate/hop frame rate) is
upsampled to sample rate and enters every gate as V_f*y, V_g*y (paper eq.3).
This subsystem is NEW relative to the reference (musyoku/wavenet is
unconditional; BASELINE.json config 5 mandates a Tacotron-style vocoder).

Upsampler: a chain of (nearest-repeat by f, then time-conv k=2f+1, M->M
channels) stages whose factors multiply to hop_length.  Nearest-repeat +
small convs keeps everything static-shape — no transposed-conv scatter
patterns.
"""

from __future__ import annotations

from typing import Any, Dict, List

import jax
import jax.numpy as jnp

from wavenet_tpu.config import MelConfig


def init_upsampler_params(mel: MelConfig, key: jax.Array, dtype) -> Dict[str, Any]:
    M = mel.num_mels
    params: Dict[str, Any] = {}
    ks = jax.random.split(key, len(mel.upsample_factors))
    for i, f in enumerate(mel.upsample_factors):
        k = 2 * f + 1
        # near-identity init: smoothing average on the center tap diagonal
        w = jnp.zeros((k, M, M), dtype) + (
            jnp.eye(M, dtype=dtype)[None, :, :] / k)
        w = w + 0.01 * jax.random.normal(ks[i], (k, M, M), dtype) / (k * M) ** 0.5
        params[f"w{i}"] = w
        params[f"b{i}"] = jnp.zeros((M,), dtype)
    return params


def upsample_mel(params: Dict[str, Any], mel_cfg: MelConfig,
                 mel: jax.Array, target_len: int) -> jax.Array:
    """[B, F, M] mel frames -> [B, target_len, M] sample-rate features."""
    y = mel.astype(jnp.float32)
    for i, f in enumerate(mel_cfg.upsample_factors):
        y = jnp.repeat(y, f, axis=1)
        w = params[f"w{i}"].astype(jnp.float32)
        y = jax.lax.conv_general_dilated(
            y, w,
            window_strides=(1,),
            padding="SAME",
            dimension_numbers=("NWC", "WIO", "NWC"),
        ) + params[f"b{i}"]
    if y.shape[1] < target_len:
        raise ValueError(
            f"upsampled mel length {y.shape[1]} < target {target_len}")
    return y[:, :target_len, :]


def project_cond(params, y: jax.Array) -> jax.Array:
    """Upsampled features [B, T, M] -> per-step gate contributions
    [B, T, L, 2, R] via every layer's v_cond (the single definition of this
    contraction; decode paths slice cond[:, t] per step)."""
    return jnp.einsum("btm,lmgr->btlgr", y, params["v_cond"],
                      preferred_element_type=jnp.float32)


def prepare_decode_cond(params, cfg, mel: jax.Array,
                        total_len: int) -> jax.Array:
    """Precompute per-step conditioning contributions for AR decode.

    [B, F, M] mel -> [B, total_len, L, 2, R]: the upsampled features
    projected through every layer's v_cond, ready to be sliced per step by
    models.wavenet.generate (cond_t = cond[:, t])."""
    y = upsample_mel(params["upsampler"], cfg.mel, mel, total_len)
    return project_cond(params, y)
