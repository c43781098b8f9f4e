"""Ahead-of-time compiled decoder artifacts (jax.export).

The reference deploys by shipping HDF5 weights plus the Chainer model code
that rebuilds the graph at load time (SURVEY.md §1 "Generation driver" /
§3.4).  The serving equivalent here is an AOT artifact: the whole
autoregressive decode loop — already ONE compiled `lax.scan` — is lowered
and serialized ONCE via `jax.export` (StableHLO), so a serving host needs
only this loader and the artifact file: no model-construction code runs at
boot, no Python retrace, only XLA's final backend pass on first call.

Artifact layout (one .zip, conventionally *.wnx):
  exported.jaxir   jax.export blob: fn(params, key[, mel][, speaker])
  weights.npz      flat '/'-joined parameter arrays
  config.json      WaveNetConfig JSON (arch validation + mu-law decode)
  meta.json        {num_samples, batch, temperature, with_mel, mel_frames,
                    with_speaker, platforms}

Scope: the exported computation is the XLA scan decoder (`wn.generate`) —
platform-portable and shape-static.  The GPU whole-loop kernel stays a
JIT-time specialization (its Triton payload is bound to the compiler that
built it, the wrong thing to freeze into a deployment artifact).  By
default the artifact is lowered for both the CPU and CUDA backends.
Mel-conditioned
models export with a STATIC [batch, mel_frames, M] conditioning input
(frames sized to num_samples — the artifact's fixed-shape contract,
round 5); variable-length vocoder traffic goes through the live
facade/server instead.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Optional

import numpy as np

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.utils.pytree_io import flatten_tree, unflatten_tree

_EXPORTED = "exported.jaxir"
_WEIGHTS = "weights.npz"
_CONFIG = "config.json"
_META = "meta.json"


def export_decoder(params, cfg: WaveNetConfig, path: str, *,
                   num_samples: int, batch: int = 1,
                   temperature: float = 1.0,
                   platforms: Optional[tuple] = ("cpu", "cuda")) -> None:
    """Serialize an AOT decode artifact to `path`.

    num_samples/batch/temperature are baked into the traced computation
    (static shapes — the XLA contract); the PRNG key — plus the mel
    features [batch, mel_frames, M] when cfg.mel is set, and the speaker
    id when cfg.global_classes is set — stay runtime inputs.  `platforms`
    cross-lowers for several backends (default ("cpu", "cuda")); None
    lowers for the current backend only.
    """
    import jax
    from jax import export as jexport

    from wavenet_tpu.models import wavenet as wn

    with_speaker = cfg.global_classes is not None
    with_mel = cfg.mel is not None
    mel_frames = 0
    if with_mel:
        # smallest frame count whose upsampling covers num_samples
        mel_frames = -(-num_samples // cfg.mel.hop_length)

    def fn(p, key, *opt):
        opt = list(opt)
        cond = None
        if with_mel:
            from wavenet_tpu.models.conditioning import prepare_decode_cond
            cond = prepare_decode_cond(p, cfg, opt.pop(0), num_samples)
        speaker = opt.pop(0) if with_speaker else None
        return wn.generate(p, cfg, key, num_samples, batch=batch,
                           cond=cond, speaker=speaker,
                           temperature=temperature)

    example = [params, jax.random.PRNGKey(0)]
    if with_mel:
        example.append(np.zeros((batch, mel_frames, cfg.mel.num_mels),
                                np.float32))
    if with_speaker:
        example.append(np.zeros((batch,), np.int32))

    kw = {} if platforms is None else {"platforms": tuple(platforms)}
    exported = jexport.export(jax.jit(fn), **kw)(*example)

    wbuf = io.BytesIO()
    np.savez(wbuf, **flatten_tree(params))
    meta = {"num_samples": num_samples, "batch": batch,
            "temperature": temperature, "with_speaker": with_speaker,
            "with_mel": with_mel, "mel_frames": mel_frames,
            "platforms": list(exported.platforms)}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_EXPORTED, exported.serialize())
        z.writestr(_WEIGHTS, wbuf.getvalue())
        z.writestr(_CONFIG, cfg.to_json())
        z.writestr(_META, json.dumps(meta))


class AotDecoder:
    """A loaded artifact: weights + the serialized decode computation.

    generate(seed=..., mel=..., speaker=...) -> [batch, num_samples] int32
    tokens; waveform(...) -> float32 audio in [-1, 1] (mu-law expanded).
    Mel-exported artifacts take mel as [batch, mel_frames, M] (or
    [mel_frames, M], broadcast over the batch) — the STATIC frame count
    baked at export (meta.mel_frames).
    """

    def __init__(self, cfg: WaveNetConfig, params, exported, meta: dict):
        self.cfg = cfg
        self.params = params
        self._exported = exported
        self.num_samples = int(meta["num_samples"])
        self.batch = int(meta["batch"])
        self.temperature = float(meta["temperature"])
        self.with_speaker = bool(meta["with_speaker"])
        self.with_mel = bool(meta.get("with_mel", False))
        self.mel_frames = int(meta.get("mel_frames", 0))
        self.platforms = tuple(meta.get("platforms", ()))

    def generate(self, seed: int = 0, key=None, speaker=None, mel=None):
        import jax
        if key is None:
            key = jax.random.PRNGKey(seed)
        args = [self.params, key]
        if self.with_mel:
            if mel is None:
                raise ValueError("artifact was exported with mel "
                                 "conditioning; pass mel=")
            mel = np.asarray(mel, np.float32)
            if mel.ndim == 2:
                mel = np.broadcast_to(
                    mel, (self.batch,) + mel.shape).copy()
            want = (self.batch, self.mel_frames, self.cfg.mel.num_mels)
            if mel.shape != want:
                raise ValueError(f"mel must be {want} (static export "
                                 f"shape); got {mel.shape}")
            args.append(mel)
        elif mel is not None:
            raise ValueError("artifact was exported without mel "
                             "conditioning; mel= is not an input")
        if self.with_speaker:
            if speaker is None:
                speaker = np.zeros((self.batch,), np.int32)
            args.append(np.asarray(speaker, np.int32).reshape(self.batch))
        elif speaker is not None:
            raise ValueError("artifact was exported without global "
                             "conditioning; speaker= is not an input")
        return self._exported.call(*args)

    def waveform(self, seed: int = 0, key=None, speaker=None,
                 mel=None) -> np.ndarray:
        from wavenet_tpu.audio import mulaw
        toks = np.asarray(self.generate(seed=seed, key=key, speaker=speaker,
                                        mel=mel))
        return mulaw.decode_np(toks, self.cfg.quantization_channels)


def load_decoder(path: str) -> AotDecoder:
    """Load an artifact written by export_decoder."""
    import jax.numpy as jnp
    from jax import export as jexport

    with zipfile.ZipFile(path) as z:
        exported = jexport.deserialize(z.read(_EXPORTED))
        cfg = WaveNetConfig.from_json(z.read(_CONFIG).decode())
        meta = json.loads(z.read(_META).decode())
        with np.load(io.BytesIO(z.read(_WEIGHTS))) as w:
            params = unflatten_tree({k: jnp.asarray(w[k]) for k in w.files})
    return AotDecoder(cfg, params, exported, meta)
