#!/usr/bin/env python
"""Evaluation CLI: per-utterance teacher-forced likelihood in bits/sample.

The reference validated models by watching training loss; this exposes the
same quantity on held-out audio (models/wavenet.py::score_fn) as a CLI —
score files or directories under a checkpoint and compare models:

  python score.py --ckpt runs/s1 eval/*.wav
  python score.py --ckpt runs/voc --mel self eval/        # vocoder: score
                                                          # under own mel
  python score.py --ckpt runs/ms --speaker 3 eval3.wav    # global-cond

Long clips are scored in chunks with a receptive-field left-context overlap,
so the numbers are EXACT (identical to one full-clip forward) at bounded
memory: logits at position t depend on tokens t-RF..t only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("paths", nargs="+", help="wav files or directories")
    p.add_argument("--ckpt", required=True, help="checkpoint directory")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--mel", choices=["self"], default=None,
                   help="'self': score each clip under its own log-mel "
                        "features (vocoder likelihood; requires a "
                        "mel-conditional checkpoint)")
    p.add_argument("--speaker", type=int, default=None,
                   help="global-conditioning class id")
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--chunk", type=int, default=16384,
                   help="targets scored per forward pass (memory bound)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON object instead of the table")
    return p.parse_args(argv)


def iter_wavs(paths):
    for path in paths:
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.lower().endswith(".wav"):
                    yield os.path.join(path, name)
        else:
            yield path


def score_clip(model, tokens, chunk, mel_self, speaker):
    """Mean bits/sample of `tokens` [T+1], exactly (chunked with RF
    left-context overlap), plus the token count scored.

    Every chunk runs at ONE fixed shape [1, RF + chunk] (missing left
    context zero-filled under forward_logits' valid_mask, tail right-padded
    and discarded) — one XLA compile per clip set instead of one per
    distinct tail length."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from wavenet_tpu.models import wavenet as wn

    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    cfg = model.cfg
    rf = cfg.receptive_field
    T = tokens.shape[0] - 1                      # target count
    W = rf + chunk                               # fixed window shape
    y = None
    if mel_self is not None:
        # upsampled features aligned with the MODEL INPUTS (positions 0..T)
        from wavenet_tpu.models.conditioning import upsample_mel
        y = upsample_mel(model.params["upsampler"], cfg.mel, mel_self, T)
        y = jnp.pad(y, ((0, 0), (rf, W), (0, 0)))    # window index = t + rf
    sp = None
    if speaker is not None:
        sp = jnp.asarray([speaker], jnp.int32)
    # pad the token timeline once: absolute position a lives at
    # padded[a + rf + 1] (one extra left slot so every window position has
    # a true prev-token row — prev of the clip's first sample is the zero
    # token, forward_logits' sequence-start convention)
    padded = np.pad(tokens, (rf + 1, W))
    pos = np.arange(W)

    @jax.jit
    def chunk_nll(inp, prev, tgt, mask, yc):
        logits = wn.forward_logits(model.params, cfg, inp,
                                   prev_tokens=prev,
                                   upsampled_cond=yc, speaker=sp,
                                   valid_mask=mask)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, tgt[..., None], -1)[..., 0]

    total_bits, total_n = 0.0, 0
    s = 0
    while s < T:
        e = min(s + chunk, T)
        # window = absolute positions [s - rf, s + chunk)
        inp = jnp.asarray(padded[s + 1:s + 1 + W])[None]
        prev = jnp.asarray(padded[s:s + W])[None]        # true prevs
        tgt = jnp.asarray(padded[s + 2:s + 2 + W])[None]
        # positions before the clip start are ABSENT (abs index < 0):
        # valid_mask zero-fills them exactly like a shorter sequence
        mask = jnp.asarray((pos + (s - rf) >= 0).astype(np.float32))[None]
        yc = None if y is None else y[:, s:s + W]
        nll = chunk_nll(inp, prev, tgt, mask, yc)
        keep = nll[0, rf:rf + (e - s)]           # this chunk's targets only
        total_bits += float(jnp.sum(keep)) / float(np.log(2.0))
        total_n += int(keep.shape[0])
        s = e
    return total_bits / max(total_n, 1), total_n


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from wavenet_tpu.audio import mulaw
    from wavenet_tpu.audio.io import read_wav
    from wavenet_tpu.models.api import WaveNet
    from wavenet_tpu.utils import compcache

    compcache.enable()
    model = WaveNet.from_checkpoint(args.ckpt, step=args.step,
                                    use_ema=not args.no_ema)
    cfg = model.cfg
    if args.mel == "self" and cfg.mel is None:
        sys.exit("--mel self requires a mel-conditional checkpoint")
    if args.mel is None and cfg.mel is not None:
        sys.exit("checkpoint is mel-conditional; pass --mel self to score "
                 "each clip under its own features")
    if args.speaker is not None and cfg.global_classes is None:
        sys.exit("--speaker requires a global_classes checkpoint")
    if args.speaker is None and cfg.global_classes is not None:
        sys.exit(f"checkpoint was trained with global_classes="
                 f"{cfg.global_classes}; pass --speaker")

    results = []
    for path in iter_wavs(args.paths):
        wave, _ = read_wav(path, cfg.sample_rate)
        tokens = mulaw.encode_np(wave, cfg.quantization_channels)
        mel_self = None
        if args.mel == "self":
            import jax.numpy as jnp
            from wavenet_tpu.audio.mel import log_mel
            mel_self = jnp.asarray(
                log_mel(wave, cfg.sample_rate, cfg.mel))[None]
        bits, n = score_clip(model, tokens, args.chunk, mel_self,
                             args.speaker)
        results.append({"file": path, "bits_per_sample": round(bits, 4),
                        "samples": n})
        if not args.json:
            print(f"{bits:8.4f} bits/sample  {n:>9d} samples  {path}")

    if not results:
        sys.exit("no wav files found")
    agg = (sum(r["bits_per_sample"] * r["samples"] for r in results)
           / sum(r["samples"] for r in results))
    if args.json:
        print(json.dumps({"files": results,
                          "bits_per_sample": round(agg, 4)}))
    else:
        print(f"{agg:8.4f} bits/sample  over {len(results)} file(s)")
    return agg


if __name__ == "__main__":
    main()
