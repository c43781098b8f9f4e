#!/usr/bin/env python
"""Time the router's training and decode paths on one NVIDIA GPU; print
ONE JSON line naming the device.

    python bench.py [--train-preset full] [--train-steps 10]
                    [--decode full:8 fastgen_bench:64] [--decode-steps 2048]

Training: the Trainer's jitted step on synthetic audio at the preset's own
batch and window (the first step, which compiles, is not timed).  Decode:
`generate_auto`, the one-shot entry point, on whichever route
`wavenet_tpu.route.decode` picks, after one warm-up call.  Exits non-zero
when JAX's platform is not "gpu": a number from another device is not a
GPU number.  The cell benchmark with per-layer metrics is separate work
(ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def bench_training(preset: str, steps: int) -> dict:
    import jax
    from wavenet_tpu.audio.dataset import AudioDataset
    from wavenet_tpu.config import get_config
    from wavenet_tpu.training.trainer import Trainer
    cfg = get_config(preset)
    ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=1.0)
    m = Trainer(cfg, ds).run(steps + 1, log_every=0)
    return {"preset": preset, "batch": cfg.batch_size,
            "window": cfg.train_window,
            "step_ms": 1e3 / m["steps_per_sec"],
            "audio_seconds_per_sec": m["audio_seconds_per_sec"],
            "loss": m["loss"],
            "peak_bytes_in_use":
                jax.devices()[0].memory_stats().get("peak_bytes_in_use")}


def bench_decode(preset: str, batch: int, steps: int) -> dict:
    import jax
    from wavenet_tpu import route
    from wavenet_tpu.config import get_config
    from wavenet_tpu.generate.sampler import generate_auto
    from wavenet_tpu.models import wavenet as wn
    cfg = get_config(preset)
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    y = None
    if cfg.mel is not None:
        y = jax.random.normal(jax.random.PRNGKey(1),
                              (batch, steps, cfg.mel.num_mels))

    def run(seed):
        return generate_auto(params, cfg, jax.random.PRNGKey(seed), steps,
                             batch=batch, y=y)

    jax.block_until_ready(run(0))                   # compile + warm up
    t0 = time.perf_counter()
    jax.block_until_ready(run(1))
    dt = time.perf_counter() - t0
    return {"preset": preset, "batch": batch, "steps": steps,
            "route": route.decode(cfg), "steps_per_sec": steps / dt,
            "samples_per_sec": steps * batch / dt,
            "realtime_streams": steps * batch / dt / cfg.sample_rate}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--train-preset", default="full")
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--decode", nargs="*", default=["full:8",
                                                    "fastgen_bench:64"],
                    metavar="PRESET:BATCH")
    ap.add_argument("--decode-steps", type=int, default=2048)
    args = ap.parse_args(argv)

    import jax
    from wavenet_tpu.utils import compcache
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs an NVIDIA GPU; JAX's platform is "
              f"{dev.platform!r}", file=sys.stderr)
        return 2
    compcache.enable()
    out = {"platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices()),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"],
               capture_output=True, text=True).stdout.strip()}
    if args.train_steps:
        out["train"] = bench_training(args.train_preset, args.train_steps)
    out["decode"] = []
    for spec in args.decode:
        preset, batch = spec.split(":")
        out["decode"].append(bench_decode(preset, int(batch),
                                          args.decode_steps))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
