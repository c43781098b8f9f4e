"""wavenet_tpu — WaveNet vocoder framework (JAX/XLA/Pallas) for NVIDIA GPUs.

A from-scratch re-design of the capabilities of musyoku/wavenet: mu-law
codec, dilated-causal gated conv stack, fast cached-queue AR decode, mel
conditioning, multi-device sharding, a Pallas decode kernel. See SURVEY.md.
"""

from wavenet_tpu.config import WaveNetConfig, MelConfig, get_config, PRESETS
from wavenet_tpu.models.api import WaveNet

__version__ = "0.1.0"
