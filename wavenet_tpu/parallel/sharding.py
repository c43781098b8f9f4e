"""Sharding rules for params, optimizer state, activations, and decode state.

Megatron-style tensor parallelism mapped onto the gated residual block
(BASELINE P2), expressed declaratively with NamedSharding — XLA/GSPMD inserts
the collectives (SURVEY.md §5.8, "the runtime IS the backend"):

  w_cur/w_prev [L, R, 2, R]: COLUMN-sharded on the LAST dim -> z [.., 2, R/mp]
      and the gate h = tanh(z[..,0,:]) * sigmoid(z[..,1,:]) are shard-local
      (the separate gate axis exists precisely so both gate halves shard with
      identical boundaries; see models/wavenet.py init_params docstring).
  w_res [L, R, R], w_skip [L, R, S]: ROW-sharded on the contracting dim, so
      h @ w_res / h @ w_skip each end in one psum over `model` per layer —
      the canonical column->row pair that keeps per-layer comms to a single
      reduce.  (R % mp == 0 and S % mp == 0 validated below.)

Batch activations shard as [data, seq, None]; decode queues shard the channel
axis on `model` and batch on `data`.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

Params = Dict[str, Any]


def validate(cfg: WaveNetConfig, mesh: Mesh) -> None:
    mp = mesh.shape[MODEL_AXIS]
    if cfg.residual_channels % mp:
        raise ValueError(f"residual_channels={cfg.residual_channels} "
                         f"not divisible by model_parallel={mp}")
    if cfg.skip_channels % mp:
        raise ValueError(f"skip_channels={cfg.skip_channels} "
                         f"not divisible by model_parallel={mp}")


def param_pspecs(cfg: WaveNetConfig) -> Params:
    """PartitionSpec pytree matching init_params' structure."""
    M = MODEL_AXIS
    specs: Params = {
        "embed_cur": P(None, None),
        "embed_prev": P(None, None),
        # column-parallel filter/gate (gate axis separate; see module doc)
        "w_cur": P(None, None, None, M),
        "w_prev": P(None, None, None, M),
        "b": P(None, None, M),
        # row-parallel: contract over sharded R, psum once per layer
        "w_res": P(None, M, None),
        "b_res": P(None, None),
        "w_skip": P(None, M, None),
        "b_skip": P(None, None),
        # head: skip width S is modest; shard the wide Q output dim
        "head_w1": P(None, None),
        "head_b1": P(None),
        "head_w2": P(None, M),
        "head_b2": P(M),
    }
    if cfg.kernel_size > 2:
        # extra conv taps: column-parallel like w_prev; embed taps replicate
        specs["w_prevk"] = P(None, None, None, None, M)
        specs["embed_prevk"] = P(None, None, None)
    if cfg.embed_channels != cfg.residual_channels:
        specs["w_embed_proj"] = P(None, None)
    if cfg.mel is not None:
        specs["v_cond"] = P(None, None, None, M)
        ups: Params = {}
        for i in range(len(cfg.mel.upsample_factors)):
            ups[f"w{i}"] = P(None, None, None)
            ups[f"b{i}"] = P(None)
        specs["upsampler"] = ups
    if cfg.global_classes is not None:
        # column-parallel like w_cur/b: the global offset joins the sharded z
        specs["g_embed"] = P(None, None)
        specs["v_global"] = P(None, None, None, M)
    return specs


def param_shardings(cfg: WaveNetConfig, mesh: Mesh) -> Params:
    return jax.tree.map(lambda s: NamedSharding(mesh, s), param_pspecs(cfg),
                        is_leaf=lambda x: isinstance(x, P))


def batch_pspec(seq_sharded: bool = False) -> Dict[str, P]:
    t = P(DATA_AXIS, SEQ_AXIS) if seq_sharded else P(DATA_AXIS, None)
    return {"tokens": t, "mel": P(DATA_AXIS, None, None),
            "speaker": P(DATA_AXIS)}


def batch_shardings(mesh: Mesh, with_mel: bool,
                    seq_sharded: bool = False,
                    with_speaker: bool = False) -> Dict[str, NamedSharding]:
    spec = batch_pspec(seq_sharded)
    out = {"tokens": NamedSharding(mesh, spec["tokens"])}
    if with_mel:
        out["mel"] = NamedSharding(mesh, spec["mel"])
    if with_speaker:
        out["speaker"] = NamedSharding(mesh, spec["speaker"])
    return out


def decode_state_pspecs() -> Any:
    """PartitionSpecs for models.wavenet.DecodeState (compact queues
    [sum_d, B, R]: batch on data, channels on model)."""
    from wavenet_tpu.models.wavenet import DecodeState
    return DecodeState(
        queues=P(None, DATA_AXIS, MODEL_AXIS),
        prev_token=P(DATA_AXIS),
        t=P(),
    )


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
