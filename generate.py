#!/usr/bin/env python
"""Generation CLI — role parity with the reference's generate script
(musyoku/wavenet `generate_audio/generate.py`; SURVEY.md §3.2), running the
fast cached-queue decoder compiled into a single on-device loop.

Examples:
  python generate.py --ckpt ./runs/t1 --seconds 2 --out out.wav
  python generate.py --ckpt ./runs/t1 --seconds 1 --batch 8 --naive
  python generate.py --ckpt ./runs/t1 --prime some.wav --seconds 2
  python generate.py --ckpt ./runs/voc --mel-from ref.wav --out voc.wav
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="checkpoint directory")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--out", default="generated.wav")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prime", default=None, help="wav file to prime on")
    p.add_argument("--mel-from", default=None,
                   help="wav file to vocode: extract its log-mel features "
                        "and generate conditioned on them (requires a "
                        "conditional checkpoint; overrides --seconds with "
                        "the reference length)")
    p.add_argument("--speaker", type=int, default=None,
                   help="global-conditioning class id (requires a checkpoint "
                        "trained with global_classes); applied to every "
                        "batch row")
    p.add_argument("--naive", action="store_true",
                   help="use the O(RF)/sample reference algorithm instead of "
                        "the cached-queue fast decoder")
    p.add_argument("--stream", type=float, default=None, metavar="CHUNK_S",
                   help="stream generation: write the wav progressively in "
                        "CHUNK_S-second chunks (bit-identical audio to the "
                        "one-shot path; serving-style bounded memory)")
    p.add_argument("--no-ema", action="store_true",
                   help="sample from the raw training weights even when the "
                        "checkpoint kept Polyak-averaged (EMA) weights")
    p.add_argument("--export-aot", default=None, metavar="FILE.wnx",
                   help="instead of sampling, freeze the decode computation "
                        "for (--seconds, --batch, --temperature) via "
                        "jax.export into one deployment artifact "
                        "(wavenet_tpu.serving.load_decoder loads it without "
                        "model code)")
    p.add_argument("--export-platforms", default="cpu,cuda",
                   help="comma-separated lowering targets baked into the "
                        "--export-aot artifact (default: portable cpu,cuda)")
    p.add_argument("--data-parallel", type=int, default=1, metavar="N",
                   help="decode across N devices on the data (batch) mesh "
                        "axis (distributed AR generation)")
    p.add_argument("--model-parallel", type=int, default=1, metavar="N",
                   help="shard the conv stack's channels across N devices "
                        "and decode with per-layer collective state "
                        "exchange; tokens are identical to single-device "
                        "at the same --seed for any mesh layout")
    p.add_argument("--scan-unroll", type=int, default=None, metavar="K",
                   help="unroll the XLA scan decoder's layer scan K-way "
                        "(cfg.decode_unroll override; the persistent "
                        "compilation cache amortizes the longer compile). "
                        "Ignored on kernel routes")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import jax
    import jax.numpy as jnp

    from wavenet_tpu.audio import mulaw
    from wavenet_tpu.audio.io import read_wav, write_wav
    from wavenet_tpu.generate.sampler import (batch_paths, generate_auto,
                                              generate_naive,
                                              tokens_to_waveform)
    from wavenet_tpu.models.api import WaveNet

    from wavenet_tpu.utils import compcache
    print(f"compilation cache: {compcache.enable()}", file=sys.stderr)

    model = WaveNet.from_checkpoint(args.ckpt, step=args.step,
                                    use_ema=not args.no_ema)
    if args.scan_unroll:
        model = model.replace_config(decode_unroll=args.scan_unroll)
    cfg, params = model.cfg, model.params

    if args.export_aot:
        if args.prime or args.mel_from or args.stream or args.naive:
            sys.exit("--export-aot freezes the plain decode scan; drop "
                     "--prime/--mel-from/--stream/--naive")
        from wavenet_tpu.serving import export_decoder
        platforms = tuple(
            s.strip() for s in args.export_platforms.split(",") if s.strip())
        export_decoder(params, cfg, args.export_aot,
                       num_samples=int(args.seconds * cfg.sample_rate),
                       batch=args.batch, temperature=args.temperature,
                       platforms=platforms or None)
        print(f"wrote {args.export_aot} "
              f"({args.seconds}s x batch {args.batch}, "
              f"platforms {','.join(platforms) or 'native'}"
              f"{', speaker input' if cfg.global_classes else ''})")
        return 0

    prime_tokens = None
    if args.prime:
        wave, _ = read_wav(args.prime, cfg.sample_rate)
        prime_tokens = jnp.asarray(
            mulaw.encode_np(wave, cfg.quantization_channels))[None]
        prime_tokens = jnp.tile(prime_tokens, (args.batch, 1))

    n = int(args.seconds * cfg.sample_rate)
    y = None
    if args.mel_from:
        if cfg.mel is None:
            sys.exit("--mel-from requires a conditional (mel) checkpoint")
        from wavenet_tpu.audio.mel import log_mel
        from wavenet_tpu.models.conditioning import upsample_mel
        ref, _ = read_wav(args.mel_from, cfg.sample_rate)
        mel = log_mel(ref, cfg.sample_rate, cfg.mel)[None]   # [1, F, M]
        P = 0 if prime_tokens is None else prime_tokens.shape[1]
        n = min(n, mel.shape[1] * cfg.mel.hop_length - max(P - 1, 0))
        if n <= 0:
            sys.exit(f"--prime ({P} samples) covers the whole --mel-from "
                     f"reference ({mel.shape[1] * cfg.mel.hop_length} "
                     f"samples); nothing left to vocode")
        y = upsample_mel(params["upsampler"], cfg.mel, jnp.asarray(mel),
                         max(P - 1, 0) + n)
        y = jnp.tile(y, (args.batch, 1, 1))

    speaker = None
    if cfg.global_classes is not None:
        sid = args.speaker if args.speaker is not None else 0
        if not 0 <= sid < cfg.global_classes:
            sys.exit(f"--speaker must be in [0, {cfg.global_classes})")
        speaker = jnp.full((args.batch,), sid, jnp.int32)
    elif args.speaker is not None:
        sys.exit("--speaker requires a global_classes checkpoint")

    key = jax.random.PRNGKey(args.seed)
    t0 = time.perf_counter()
    if args.data_parallel * args.model_parallel > 1:
        if args.stream is not None or args.naive:
            sys.exit("--data-parallel/--model-parallel use the distributed "
                     "fast decoder; drop --stream/--naive")
        import dataclasses

        from wavenet_tpu.generate.sampler import generate_distributed
        from wavenet_tpu.parallel.mesh import make_mesh
        mesh_cfg = dataclasses.replace(cfg,
                                       data_parallel=args.data_parallel,
                                       model_parallel=args.model_parallel,
                                       seq_parallel=1)
        mesh = make_mesh(mesh_cfg)
        toks = generate_distributed(params, cfg, mesh, args.seed,
                                    num_samples=n, batch=args.batch,
                                    prime_tokens=prime_tokens, y=y,
                                    speaker=speaker,
                                    temperature=args.temperature)
        import numpy as np
        toks = np.asarray(toks)   # readback-timed: block_until_ready can
        dt = time.perf_counter() - t0  # return early on kernel outputs
        print(f"{n} samples x{args.batch} in {dt:.2f}s = "
              f"{n * args.batch / dt:.0f} samples/s (distributed "
              f"dp={args.data_parallel} mp={args.model_parallel})",
              file=sys.stderr)
        wave = tokens_to_waveform(toks, cfg)
        for i, path in enumerate(batch_paths(args.out, args.batch)):
            write_wav(path, wave[i], cfg.sample_rate)
        print(f"wrote {args.out}", file=sys.stderr)
        return toks
    if args.stream is not None:
        if args.naive:
            sys.exit("--stream uses the fast decoder; drop --naive")
        import wave as wave_mod

        import numpy as np
        from wavenet_tpu.generate.sampler import generate_stream
        speaker_t = speaker
        writers = []
        paths = batch_paths(args.out, args.batch)
        for path in paths:
            w = wave_mod.open(path, "wb")
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(cfg.sample_rate)
            writers.append(w)
        total = 0
        for toks in generate_stream(
                params, cfg, key, n,
                chunk_samples=int(args.stream * cfg.sample_rate),
                batch=args.batch, prime_tokens=prime_tokens, y=y,
                speaker=speaker_t, temperature=args.temperature):
            from wavenet_tpu.audio import mulaw
            wavec = np.asarray(mulaw.decode(toks, cfg.quantization_channels))
            pcm = np.clip(wavec * 32767.0, -32768, 32767).astype(np.int16)
            for i, w in enumerate(writers):
                w.writeframes(pcm[i].tobytes())
            total += toks.shape[1]
            print(f"\rstreamed {total}/{n} samples", end="",
                  file=sys.stderr)
        for w in writers:
            w.close()
        dt = time.perf_counter() - t0
        print(f"\n{n} samples x{args.batch} in {dt:.2f}s = "
              f"{n * args.batch / dt:.0f} samples/s (streamed)",
              file=sys.stderr)
        print(f"wrote {args.out}", file=sys.stderr)
        return None
    if args.naive:
        toks = generate_naive(params, cfg, key, num_samples=n,
                              batch=args.batch, prime_tokens=prime_tokens,
                              speaker=speaker,
                              temperature=args.temperature)
    else:
        toks = generate_auto(params, cfg, key, num_samples=n,
                             batch=args.batch, prime_tokens=prime_tokens,
                             y=y, speaker=speaker,
                             temperature=args.temperature)
    import numpy as np
    toks = np.asarray(toks)       # readback-timed: block_until_ready can
    dt = time.perf_counter() - t0  # return early on kernel outputs
    sps = n * args.batch / dt
    print(f"{n} samples x{args.batch} in {dt:.2f}s = {sps:.0f} samples/s "
          f"({'naive' if args.naive else 'fast'})", file=sys.stderr)

    wave = tokens_to_waveform(toks, cfg)
    for i, path in enumerate(batch_paths(args.out, args.batch)):
        write_wav(path, wave[i], cfg.sample_rate)
    print(f"wrote {args.out}", file=sys.stderr)
    return toks


if __name__ == "__main__":
    main()
