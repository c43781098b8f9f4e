"""Typed configuration for the WaveNet framework.

Mirrors the role of the reference's params-JSON-next-to-checkpoints idea
(musyoku/wavenet keeps a params JSON serialized beside HDF5 weights; see
SURVEY.md §1 "Hyperparameter/config" row) but as a typed, versioned dataclass
with the preset configs mandated by BASELINE.json `configs`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Local-conditioning (mel spectrogram) config for the vocoder preset.

    WaveNet paper §2.5 eq.3: conditioning enters the gate as V_f*y and V_g*y
    where y is the upsampled conditioning signal.
    """

    num_mels: int = 80
    hop_length: int = 256          # audio samples per mel frame
    win_length: int = 1024
    fmin: float = 0.0
    fmax: float = 8000.0
    # Upsampling from mel frame-rate to sample-rate: product must equal
    # hop_length. Done with repeat + conv smoothing.
    upsample_factors: Tuple[int, ...] = (4, 8, 8)

    def __post_init__(self):
        prod = 1
        for f in self.upsample_factors:
            prod *= f
        if prod != self.hop_length:
            raise ValueError(
                f"prod(upsample_factors)={prod} must equal hop_length="
                f"{self.hop_length}")


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    """Full model + training hyperparameters.

    Dilation schedule follows WaveNet paper §2.1 Fig 3: within a block the
    dilation doubles per layer (1, 2, 4, ..., max_dilation), and the block is
    repeated `num_blocks` times.
    """

    # --- quantization (paper §2.2) ---
    quantization_channels: int = 256   # mu-law classes
    sample_rate: int = 16000

    # --- conv stack (paper §2.1-2.4) ---
    num_blocks: int = 1
    max_dilation: int = 128            # dilations 1..max_dilation doubling
    # Causal conv width (reference: configurable filter width, SURVEY.md §2
    # #3).  Applies uniformly to the embed conv and every dilated conv (the
    # RF formula below).  kernel_size == 2 (the paper's and every preset's
    # value) is served by the GPU decode kernel; kernel_size > 2 runs on the
    # XLA scan paths — training single-device or data-parallel, decode
    # single-device (one-shot, streaming, naive oracle, serving engine).
    # The width-2-only subsystems — sequence parallelism and the
    # distributed (mesh) decoder — refuse other widths at routing time.
    kernel_size: int = 2
    residual_channels: int = 32
    skip_channels: int = 16
    # channels of the initial causal embedding conv; defaults to residual
    causal_channels: Optional[int] = None

    # --- conditioning (None => unconditional) ---
    mel: Optional[MelConfig] = None
    # global conditioning (paper §2.5 eq.2): a per-utterance class id (e.g.
    # speaker) embedded to global_channels and projected into every gate.
    # None => no global conditioning.
    global_classes: Optional[int] = None
    global_channels: int = 16

    # --- numerics ---
    compute_dtype: str = "bfloat16"    # activations/matmul inputs
    param_dtype: str = "float32"       # master weights
    remat: bool = False                # jax.checkpoint over the layer scan
    # Unroll factor of the XLA scan decoder's per-layer scan
    # (models/wavenet.py decode_step).  The scan decoder is bound by its
    # serialized layer critical path; a larger unroll shortens it at the
    # cost of a longer compile per shape (PERF.md has the H100 numbers).
    # Perf knob only: same math per layer, but XLA may reassociate
    # differently, so a sampled near-tie trajectory can differ between
    # unroll settings — the unroll value is part of a config's
    # reproducibility key (docs/ARCHITECTURE.md §5).  Kernel-served configs
    # ignore it.
    decode_unroll: int = 1

    # --- training ---
    batch_size: int = 8
    train_window: int = 4096           # samples per training crop (incl. RF)
    learning_rate: float = 2e-4
    lr_schedule: str = "constant"      # constant | cosine | exponential
    lr_decay_steps: int = 200_000      # horizon for cosine/exponential
    lr_min_ratio: float = 0.1          # floor as fraction of peak lr
    warmup_steps: int = 0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    grad_clip_norm: Optional[float] = None
    # Gradient accumulation: each optimizer update averages the grads of
    # this many consecutive microbatches (optax.MultiSteps), so the
    # effective batch is grad_accum * batch_size while device memory holds
    # one microbatch's activations.  Composes with every parallel path —
    # the jitted step function is unchanged, only the optimizer wraps.
    grad_accum: int = 1
    # Polyak/EMA averaging of params (standard vocoder practice: sample from
    # the average, train on the raw weights).  None disables; typical 0.9999.
    ema_decay: Optional[float] = None
    seed: int = 0

    # --- parallelism (mesh axis sizes; 1 = disabled) ---
    data_parallel: int = 1
    # model sharding of the conv stack: channel (Megatron) sharding
    model_parallel: int = 1
    seq_parallel: int = 1              # time-axis halo sharding

    def __post_init__(self):
        if self.max_dilation & (self.max_dilation - 1):
            raise ValueError("max_dilation must be a power of two")
        if self.kernel_size < 2:
            raise ValueError("kernel_size must be >= 2")
        if self.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        if self.decode_unroll < 1:
            raise ValueError("decode_unroll must be >= 1")

    # ---- derived quantities ----

    @property
    def dilations(self) -> Tuple[int, ...]:
        """Per-layer dilation list: num_blocks repetitions of 1..max_dilation."""
        ladder = []
        d = 1
        while d <= self.max_dilation:
            ladder.append(d)
            d *= 2
        return tuple(ladder) * self.num_blocks

    @property
    def num_layers(self) -> int:
        return len(self.dilations)

    @property
    def receptive_field(self) -> int:
        """RF = sum((k-1)*d) + 1 over all layers, + (k-1) for the causal embed
        conv (paper §2.1; SURVEY.md §4 RF formula)."""
        return (self.kernel_size - 1) * (sum(self.dilations) + 1) + 1

    @property
    def embed_channels(self) -> int:
        return self.causal_channels or self.residual_channels

    # ---- serialization (params-JSON parity with the reference) ----

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "WaveNetConfig":
        d = json.loads(s)
        for k in _RETIRED_FIELDS:          # written by older versions
            d.pop(k, None)
        mel = d.pop("mel", None)
        if mel is not None:
            mel["upsample_factors"] = tuple(mel["upsample_factors"])
            mel = MelConfig(**mel)
        return cls(mel=mel, **d)

    def replace(self, **kw) -> "WaveNetConfig":
        return dataclasses.replace(self, **kw)


# Fields older params JSON may carry that no longer configure anything: the
# switches of the removed fused training kernel and its layer pipeline.
_RETIRED_FIELDS = ("fused_stack", "pipeline_microbatch")


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def tiny() -> WaveNetConfig:
    """1 block, dilations 1..128, 32 residual/16 skip, CPU-runnable."""
    return WaveNetConfig(
        num_blocks=1, max_dilation=128,
        residual_channels=32, skip_channels=16,
        batch_size=4, train_window=2048,
    )


def small() -> WaveNetConfig:
    """2 blocks x dilations 1..512, 64 residual ch (LJSpeech-style)."""
    return WaveNetConfig(
        num_blocks=2, max_dilation=512,
        residual_channels=64, skip_channels=64,
        batch_size=8, train_window=8192,
    )


def full() -> WaveNetConfig:
    """4 blocks x dilations 1..512, 128 residual/256 skip (RF ~ 0.26s @16kHz)."""
    return WaveNetConfig(
        num_blocks=4, max_dilation=512,
        residual_channels=128, skip_channels=256,
        batch_size=8, train_window=8192, remat=True,
    )


def fastgen_bench() -> WaveNetConfig:
    """Cached-queue AR sampling benchmark: 24kHz, batch-64 parallel decode."""
    return WaveNetConfig(
        num_blocks=2, max_dilation=512,
        residual_channels=64, skip_channels=128,
        sample_rate=24000, batch_size=64, train_window=8192,
    )


def conditional() -> WaveNetConfig:
    """Mel-conditioned Tacotron-style vocoder, shardable across devices."""
    return WaveNetConfig(
        num_blocks=2, max_dilation=512,
        residual_channels=64, skip_channels=128,
        mel=MelConfig(), batch_size=8, train_window=8192,
    )


def full_vocoder() -> WaveNetConfig:
    """Flagship-quality vocoder: the `full` stack + mel conditioning (the
    realistic TTS product)."""
    return WaveNetConfig(
        num_blocks=4, max_dilation=512,
        residual_channels=128, skip_channels=256,
        mel=MelConfig(), batch_size=8, train_window=8192, remat=True,
    )


PRESETS = {
    "tiny": tiny,
    "small": small,
    "full": full,
    "fastgen_bench": fastgen_bench,
    "conditional": conditional,
    "full_vocoder": full_vocoder,
}


def get_config(name: str) -> WaveNetConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
