"""Which implementation runs each hot path, decided in one place.

Every route is chosen by a positive platform test: "gpu" (NVIDIA) and "cpu"
have routes, and any other platform raises with its name.  The Pallas
interpreter runs only when a caller passes `interpret=True` (the tests do);
no route falls into it on its own.

  * Training loss: XLA's plain path on both platforms (the halo-exchange
    shard_map when the time axis is sharded).
  * Single-device decode, one-shot and streaming: on the GPU the whole-loop
    decoder (`ops/pallas/decode_gpu.py`) for every config it supports.  On
    an H100 it beat the XLA scan (`models.wavenet.decode_sample_chunk`) at
    the scan's best `decode_unroll` at `full` (1.14x), `conditional` (2.3x)
    and `fastgen_bench` (2.9x), and stayed within the scan's own spread at
    `full_vocoder` (PERF.md).  Configs it does not support take the scan.
    `interpret=True` asks for the kernel itself, in the Pallas interpreter.
  * Mesh decode: the same kernel fanned over the `data` axis when the mesh
    has no model axis, else the collective scan decoder
    (`parallel/distdecode.generate_sharded`).
"""

from __future__ import annotations

from typing import Optional

import jax

from wavenet_tpu.config import WaveNetConfig

SCAN = "scan"
KERNEL = "kernel"
PLATFORMS = ("gpu", "cpu")


def current_platform() -> str:
    return jax.devices()[0].platform


def _checked(platform: Optional[str]) -> str:
    platform = platform or current_platform()
    if platform not in PLATFORMS:
        raise ValueError(f"no route for platform {platform!r}; this program "
                         f"runs on {' or '.join(PLATFORMS)}")
    return platform


def train_loss(cfg: WaveNetConfig, mesh=None, platform: Optional[str] = None):
    """The training loss as f(params, batch) -> (loss, aux)."""
    _checked(platform)
    from wavenet_tpu.models import wavenet as wn
    if cfg.seq_parallel > 1:
        if mesh is None:
            raise ValueError("seq_parallel > 1 requires the mesh")
        from wavenet_tpu.parallel import seqpar

        def loss(params, batch):
            toks = batch["tokens"]
            return seqpar.loss_fn_sp(params, cfg, mesh, toks[:, :-1],
                                     toks[:, 1:], mel=batch.get("mel"),
                                     speaker=batch.get("speaker"))
        return loss

    def loss(params, batch):
        return wn.loss_fn(params, cfg, batch["tokens"], mel=batch.get("mel"),
                          speaker=batch.get("speaker"))
    return loss


def decode(cfg: WaveNetConfig, platform: Optional[str] = None,
           interpret: bool = False) -> str:
    """One-shot single-device decode: KERNEL or SCAN."""
    platform = _checked(platform)
    from wavenet_tpu.ops.pallas import decode_gpu
    if not decode_gpu.supported(cfg):
        return SCAN
    if interpret or platform == "gpu":
        return KERNEL
    return SCAN


def stream(cfg: WaveNetConfig, platform: Optional[str] = None,
           interpret: bool = False) -> str:
    """Streaming single-device decode: chunks of the one-shot route, so the
    concatenated stream equals the one-shot tokens."""
    return decode(cfg, platform, interpret)


def dp_decode(cfg: WaveNetConfig, mesh, batch: int,
              platform: Optional[str] = None,
              interpret: bool = False) -> str:
    """Mesh decode: KERNEL fans the whole-loop decoder over `data` (rows
    split evenly, no model axis); SCAN runs the collective decoder."""
    from wavenet_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    dp = mesh.shape.get(DATA_AXIS, 1)
    if mesh.shape.get(MODEL_AXIS, 1) > 1 or batch % dp:
        _checked(platform)
        return SCAN
    return decode(cfg, platform, interpret)
