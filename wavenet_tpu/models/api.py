"""Object-style facade over the functional model core.

The reference exposes a `WaveNet` model class (SURVEY.md §1 "model core"
public interface: forward/loss and save/load); this wraps the functional
API (models/wavenet.py) in the same ergonomic shape while staying a thin
veneer — params remain an explicit pytree so sharding/checkpointing
compose unchanged.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn


class WaveNet:
    """Convenience wrapper: model = WaveNet(cfg); model.init(key);
    model.loss(tokens); model.generate(seconds=1.0)."""

    def __init__(self, cfg: WaveNetConfig, params: Optional[wn.Params] = None):
        self.cfg = cfg
        self.params = params

    # ---- lifecycle ----

    def init(self, key: Optional[jax.Array] = None) -> "WaveNet":
        key = jax.random.PRNGKey(self.cfg.seed) if key is None else key
        self.params = wn.init_params(self.cfg, key)
        return self

    @classmethod
    def from_checkpoint(cls, directory: str, step: Optional[int] = None,
                        use_ema: bool = True) -> "WaveNet":
        """Load a trained model.  When the run kept Polyak-averaged weights
        (cfg.ema_decay) they are used for inference by default — pass
        use_ema=False for the raw training weights."""
        from wavenet_tpu.training.checkpoint import CheckpointManager
        from wavenet_tpu.training.trainer import TrainState, make_optimizer
        cfg = CheckpointManager.load_config(directory)
        ckpt = CheckpointManager(directory, cfg)
        params = jax.eval_shape(lambda: wn.init_params(cfg, jax.random.PRNGKey(0)))
        tx = make_optimizer(cfg)
        opt = jax.eval_shape(lambda p: tx.init(p), params)
        ema = params if cfg.ema_decay is not None else None
        abstract = TrainState(params, opt,
                              jax.ShapeDtypeStruct((), jnp.int32), ema)
        state, _ = ckpt.restore(abstract, step=step)
        use = (state.ema if (use_ema and cfg.ema_decay is not None)
               else state.params)
        return cls(cfg, use)

    def replace_config(self, **kw) -> "WaveNet":
        """Return a model with non-architectural config fields overridden
        (perf/deployment knobs: decode_unroll, batch_size, …).
        Params are shared, not copied; overriding an architecture field
        would desync params from config — guarded by the same field list
        the checkpoint loader enforces."""
        from wavenet_tpu.training.checkpoint import CheckpointManager
        bad = [k for k in kw if k in CheckpointManager._ARCH_FIELDS]
        if bad:
            raise ValueError(
                f"architecture fields {bad} cannot be replaced on a live "
                f"model (params were built for the current values)")
        return WaveNet(self.cfg.replace(**kw), self.params)

    def save(self, directory: str, step: int = 0) -> None:
        """Write these params as a loadable checkpoint (config JSON beside
        it, reference params-next-to-weights parity) without needing a
        Trainer — e.g. to persist EMA-extracted or converted weights.  The
        optimizer state is freshly initialized; resuming TRAINING from such
        a checkpoint starts the optimizer cold."""
        from wavenet_tpu.audio.dataset import IteratorState
        from wavenet_tpu.training.checkpoint import CheckpointManager
        from wavenet_tpu.training.trainer import TrainState, make_optimizer
        if self.params is None:
            raise ValueError("no params; call init() or load a checkpoint")
        tx = make_optimizer(self.cfg)
        state = TrainState(self.params, tx.init(self.params),
                           jnp.asarray(step, jnp.int32))
        ckpt = CheckpointManager(directory, self.cfg)
        ckpt.save(step, state, IteratorState(seed=self.cfg.seed, step=0),
                  wait=True)

    def export_npz(self, path: str) -> None:
        """Write the weights as ONE portable .npz (keys '/'-joined for
        nested subtrees, config JSON under '__config__') — the
        single-file interchange artifact the reference's HDF5 weight files
        were; the step checkpoints stay the training format."""
        import numpy as np
        from wavenet_tpu.utils.pytree_io import flatten_tree
        if self.params is None:
            raise ValueError("no params; call init() or load a checkpoint")
        flat = flatten_tree(self.params)
        flat["__config__"] = np.frombuffer(
            self.cfg.to_json().encode(), dtype=np.uint8)
        np.savez(path, **flat)

    @classmethod
    def from_npz(cls, path: str) -> "WaveNet":
        """Load a model exported with export_npz (config travels inside)."""
        import numpy as np
        from wavenet_tpu.config import WaveNetConfig
        from wavenet_tpu.utils.pytree_io import unflatten_tree
        with np.load(path) as z:
            cfg = WaveNetConfig.from_json(
                bytes(z["__config__"]).decode())
            params = unflatten_tree(
                {k: jnp.asarray(z[k]) for k in z.files
                 if k != "__config__"})
        return cls(cfg, params)

    # ---- model surface ----

    def logits(self, tokens, mel=None, speaker=None):
        return wn.forward_logits(self.params, self.cfg, tokens, mel=mel,
                                 speaker=speaker)

    def loss(self, tokens, mel=None, speaker=None):
        return wn.loss_fn(self.params, self.cfg, tokens, mel=mel,
                          speaker=speaker)

    def generate(self, seconds: Optional[float] = None,
                 num_samples: Optional[int] = None, batch: int = 1,
                 key: Optional[jax.Array] = None, prime_tokens=None,
                 mel=None, speaker=None, temperature: float = 1.0,
                 mesh=None, seed: int = 0, seeds=None, y=None):
        """Sample audio tokens.  mesh: optional jax.sharding.Mesh with
        (data, model) axes — routes through the distributed decoder
        (multi-device AR generation, SURVEY.md P3); `seed` drives its
        layout-independent counter RNG (key is ignored on that path).
        seeds: optional [batch] per-row counter-RNG seeds (ops/rng.py) —
        each row's audio then depends only on ITS seed (the serving
        replay contract), on any path and mesh layout.
        y: optional pre-UPSAMPLED conditioning features [batch, T, M]
        covering max(P-1,0)+num_samples steps, instead of mel= (the
        serving engine batches vocoder rows this way: per-row upsampling
        at each row's own length, zero-padded to the common timeline)."""
        from wavenet_tpu.generate.sampler import (generate_auto,
                                                  generate_distributed)
        if num_samples is None:
            if seconds is None:
                raise ValueError("pass seconds= or num_samples=")
            num_samples = int(seconds * self.cfg.sample_rate)
        if y is not None and mel is not None:
            raise ValueError("pass either mel= (frames) or y= (upsampled)")
        if y is None:
            y = self._upsampled_cond(mel, prime_tokens, num_samples)
        if mesh is not None:
            return generate_distributed(self.params, self.cfg, mesh,
                                        seed if seeds is None else seeds,
                                        num_samples, batch=batch,
                                        prime_tokens=prime_tokens, y=y,
                                        speaker=speaker,
                                        temperature=temperature)
        key = jax.random.PRNGKey(0) if key is None else key
        return generate_auto(self.params, self.cfg, key, num_samples,
                             batch=batch, prime_tokens=prime_tokens,
                             y=y, speaker=speaker, temperature=temperature,
                             seeds=seeds)

    def vocode(self, waveform, key: Optional[jax.Array] = None,
               temperature: float = 1.0, speaker=None):
        """Re-synthesize audio through the model: extract log-mel features
        from `waveform` ([T] float) and generate conditioned on them — the
        one-call vocoder entry point (generate.py --mel-from equivalent).
        Returns [1, T'] int32 tokens (T' = frames * hop)."""
        import numpy as np
        if self.cfg.mel is None:
            raise ValueError("vocode requires a mel-conditional model")
        from wavenet_tpu.audio.mel import log_mel
        mel = log_mel(np.asarray(waveform, np.float32),
                      self.cfg.sample_rate, self.cfg.mel)[None]
        n = mel.shape[1] * self.cfg.mel.hop_length
        return self.generate(num_samples=n, key=key, mel=jnp.asarray(mel),
                             speaker=speaker, temperature=temperature)

    def score(self, waveform=None, tokens=None, mel=None, speaker=None):
        """Per-utterance teacher-forced bits/sample ([B]); lower is better.
        Pass either float waveforms [B, T] (mu-law encoded here) or token
        ids [B, T]."""
        from wavenet_tpu.audio import mulaw
        if (waveform is None) == (tokens is None):
            raise ValueError("pass exactly one of waveform= / tokens=")
        if tokens is None:
            tokens = mulaw.encode(jnp.asarray(waveform),
                                  self.cfg.quantization_channels)
        return wn.score_fn(self.params, self.cfg, jnp.asarray(tokens),
                           mel=mel, speaker=speaker)

    def stream(self, seconds: Optional[float] = None,
               chunk_seconds: float = 1.0,
               batch: int = 1, key: Optional[jax.Array] = None,
               prime_tokens=None, mel=None, speaker=None,
               temperature: float = 1.0,
               num_samples: Optional[int] = None,
               chunk_samples: Optional[int] = None, seeds=None,
               mesh=None, seed: int = 0, y=None):
        """Yield float waveform chunks ([B, <=chunk] in [-1, 1]) as they are
        generated — the serving entry point for long-form synthesis.
        Bounded memory; the emitted audio is bit-identical to a one-shot
        generate on the same route (wavenet_tpu.route): the kernel's and
        the scan's RNG are both keyed by the global step.
        seeds: optional [batch] per-row counter-RNG seeds (ops/rng.py);
        key is ignored when given.
        mesh: optional jax.sharding.Mesh — streams through the DISTRIBUTED
        decoder (sampler.stream_distributed), chunk-for-chunk identical to
        generate(mesh=...) at the same seeds.
        y: optional pre-upsampled conditioning (see generate())."""
        from wavenet_tpu.audio import mulaw
        from wavenet_tpu.generate.sampler import (generate_stream,
                                                  stream_distributed)
        import numpy as np
        key = jax.random.PRNGKey(0) if key is None else key
        if num_samples is None:
            if seconds is None:
                raise ValueError("pass seconds= or num_samples=")
            num_samples = int(seconds * self.cfg.sample_rate)
        n = num_samples
        if chunk_samples is None:
            chunk_samples = int(chunk_seconds * self.cfg.sample_rate)
        if y is not None and mel is not None:
            raise ValueError("pass either mel= (frames) or y= (upsampled)")
        if y is None:
            y = self._upsampled_cond(mel, prime_tokens, n)
        if mesh is not None:
            gen = stream_distributed(
                self.params, self.cfg, mesh,
                seed if seeds is None else seeds, n, batch,
                chunk_samples=chunk_samples, prime_tokens=prime_tokens,
                y=y, speaker=speaker, temperature=temperature)
        else:
            gen = generate_stream(
                self.params, self.cfg, key, n,
                chunk_samples=chunk_samples,
                batch=batch, prime_tokens=prime_tokens, y=y,
                speaker=speaker, temperature=temperature, seeds=seeds)
        for toks in gen:
            yield np.asarray(
                mulaw.decode(toks, self.cfg.quantization_channels))

    def _upsampled_cond(self, mel, prime_tokens, num_samples):
        """Upsampled conditioning covering the priming steps too (advisor
        r1 #2): the decoder consumes features for t in [0, max(P-1,0)+N).
        One definition for generate() and stream() so the coverage rule
        cannot drift between the one-shot and streaming paths."""
        if mel is None:
            return None
        from wavenet_tpu.models.conditioning import upsample_mel
        P = 0 if prime_tokens is None else prime_tokens.shape[1]
        return upsample_mel(self.params["upsampler"], self.cfg.mel, mel,
                            max(P - 1, 0) + num_samples)

    def generate_wav(self, path: str, seconds: float, mel=None,
                     prime_tokens=None, **kw):
        """Sample and write wav file(s); supports the same conditioning
        arguments as generate() (mel=, speaker=, prime_tokens=, ...)."""
        from wavenet_tpu.generate.sampler import generate_wav
        n = int(seconds * self.cfg.sample_rate)
        y = self._upsampled_cond(mel, prime_tokens, n)
        if y is not None:
            kw["y"] = y
        if prime_tokens is not None:
            kw["prime_tokens"] = prime_tokens
        return generate_wav(self.params, self.cfg, path, seconds, **kw)

    @property
    def num_params(self) -> int:
        return sum(x.size for x in jax.tree.leaves(self.params))
