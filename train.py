#!/usr/bin/env python
"""Training CLI — role parity with the reference's train script
(musyoku/wavenet `train_audio/train.py`; SURVEY.md §3.1).

Examples:
  python train.py --preset tiny --data ./wavs --steps 10000 --ckpt ./runs/t1
  python train.py --preset small --synthetic --steps 500
  python train.py --config ./runs/t1/params.json --resume --ckpt ./runs/t1
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="tiny",
                   help="config preset (tiny/small/full/fastgen_bench/conditional)")
    p.add_argument("--config", default=None,
                   help="path to a params.json (overrides --preset)")
    p.add_argument("--data", default=None, help="directory of .wav files")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic sine mixtures (smoke runs)")
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--ckpt", default=None, help="checkpoint directory")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a jax profiler trace of steps 10-15 here")
    p.add_argument("--sample-every", type=int, default=0,
                   help="every N steps, dump a generated wav next to the "
                        "checkpoints (ear-validation, reference README "
                        "workflow)")
    p.add_argument("--sample-seconds", type=float, default=1.0)
    p.add_argument("--eval-every", type=int, default=0,
                   help="run the held-out evaluation loop every N steps and "
                        "log eval_* metrics (stderr + --metrics-file)")
    p.add_argument("--eval-data", default=None,
                   help="directory of held-out .wav files for --eval-every "
                        "(defaults to deterministic batches from the "
                        "training set)")
    p.add_argument("--metrics-file", default=None,
                   help="append JSONL metrics here")
    p.add_argument("--override", action="append", default=[],
                   help="config overrides as key=json, e.g. --override remat=true")
    return p.parse_args(argv)


def build_config(args):
    from wavenet_tpu.config import WaveNetConfig, get_config
    if args.config:
        with open(args.config) as f:
            cfg = WaveNetConfig.from_json(f.read())
    else:
        cfg = get_config(args.preset)
    kw = {}
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.lr is not None:
        kw["learning_rate"] = args.lr
    for ov in args.override:
        k, v = ov.split("=", 1)
        val = json.loads(v)
        if k == "mel" and isinstance(val, dict):
            from wavenet_tpu.config import MelConfig
            if "upsample_factors" in val:
                val["upsample_factors"] = tuple(val["upsample_factors"])
            val = MelConfig(**val)
        kw[k] = val
    return cfg.replace(**kw) if kw else cfg


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)

    from wavenet_tpu.audio.dataset import AudioDataset
    from wavenet_tpu.training.trainer import Trainer
    from wavenet_tpu.utils import compcache

    # restart-after-preemption latency: a resumed run reuses the previous
    # process's compiled train step (SURVEY §5.3)
    print(f"compilation cache: {compcache.enable()}", file=sys.stderr)

    if args.synthetic or not args.data:
        print("using synthetic dataset", file=sys.stderr)
        ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=4.0)
    else:
        ds = AudioDataset.from_dir(args.data, cfg)

    tr = Trainer(cfg, ds, checkpoint_dir=args.ckpt)
    if args.resume and tr.ckpt and tr.ckpt.latest_step() is not None:
        tr.restore()
        print(f"resumed at step {tr.ckpt.latest_step()}", file=sys.stderr)

    from wavenet_tpu.training.metrics import MetricsLogger
    mlog = MetricsLogger(args.metrics_file, also_print=False) \
        if args.metrics_file else None

    def log_fn(msg):
        print(msg, file=sys.stderr)

    def run_chunk(n):
        m = tr.run(n, log_every=args.log_every,
                   checkpoint_every=args.ckpt_every if args.ckpt else None,
                   log_fn=log_fn,
                   metrics_fn=mlog.log if mlog else None)
        if mlog:
            mlog.log(int(jax.device_get(tr.state.step)), m)
        return m

    import jax
    eval_ds = None
    if args.eval_data:
        eval_ds = AudioDataset.from_dir(args.eval_data, cfg)

    def run_eval():
        em = tr.evaluate(eval_ds)
        step = int(jax.device_get(tr.state.step))
        print("step %d  %s" % (step, "  ".join(
            f"{k} {v:.4f}" for k, v in sorted(em.items()))), file=sys.stderr)
        if mlog:
            mlog.log(step, em)
        return em

    sample_every = args.sample_every if args.ckpt else 0
    if args.profile_dir:
        from wavenet_tpu.utils.profiling import profiled_steps
        with profiled_steps(tr, args.profile_dir, start=10, stop=15):
            metrics = run_chunk(args.steps)
    elif sample_every or args.eval_every:
        import math
        from wavenet_tpu.generate.sampler import generate_wav
        chunk = math.gcd(sample_every, args.eval_every)
        done = 0
        metrics = {}
        while done < args.steps:
            n = min(chunk, args.steps - done)
            metrics = run_chunk(n)
            done += n
            step = int(jax.device_get(tr.state.step))
            if sample_every and done % sample_every == 0:
                out = f"{args.ckpt}/sample_step{step}.wav"
                generate_wav(tr.state.params, cfg, out, args.sample_seconds)
                print(f"wrote {out}", file=sys.stderr)
            if args.eval_every and done % args.eval_every == 0:
                metrics.update(run_eval())
    else:
        metrics = run_chunk(args.steps)
    if args.ckpt:
        tr.save()
        tr.ckpt.wait()
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
