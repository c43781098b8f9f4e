"""Device mesh construction.

All data movement between devices is XLA collectives (SURVEY.md §5.8; on
NVIDIA GPUs XLA hands them to NCCL), expressed through a `jax.sharding.Mesh`
with axes:

  data  — utterance-batch data parallelism (BASELINE P1)
  model — channel sharding of the conv stack (Megatron-style, P2)
  seq   — time-axis halo sharding for long clips (P6)

The cards of one host are joined all to all by NVLink, so every pair of
devices is as close as any other: the axis order follows the algorithm
alone.  `model` (a psum every layer) is the fastest-varying axis and `data`
(one gradient psum per step) the slowest, which keeps each model group on
consecutive devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from wavenet_tpu.config import WaveNetConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


def make_mesh(cfg: WaveNetConfig,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build the (data, seq, model) mesh from cfg axis sizes.

    data_parallel=0 means "absorb all remaining devices on the data axis".
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    mp, sp = cfg.model_parallel, cfg.seq_parallel
    dp = cfg.data_parallel
    if dp == 0:
        if n % (mp * sp):
            raise ValueError(f"{n} devices not divisible by model*seq={mp*sp}")
        dp = n // (mp * sp)
    need = dp * mp * sp
    if need > n:
        raise ValueError(f"mesh {dp}x{sp}x{mp} needs {need} > {n} devices")
    arr = np.asarray(devices[:need]).reshape(dp, sp, mp)
    return Mesh(arr, AXES)


def single_device_mesh() -> Mesh:
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), AXES)
