#!/usr/bin/env python
"""Training-quality evidence for the FLAGSHIP `full` preset (round-3
verdict #6: the flagship config had bench windows only — no committed
training run).

What it does (one GPU, remat on):

  1. train the `full` preset (4x1..512, 128/256 ch, B=8, W=8192) for
     `steps` steps on a deterministically regenerated 256-clip synthetic
     speech-like corpus (ensure_corpus below; held-out clips come from the
     committed vocoder corpus_eval), loss curve to metrics.jsonl +
     loss_curve.png; every EVAL_EVERY steps the held-out median
     bits/sample (raw AND EMA weights) is recorded to trajectory.json —
     a TRAJECTORY, not an endpoint (round-4 verdict #7);
  2. held-out bits/sample on every corpus_eval clip (teacher-forced
     score, the quantity the loss optimizes, on unseen data);
  3. generate a free-running sample wav through the decode route the
     router picks (`wavenet_tpu.route.decode`: the GPU decode kernel on a
     GPU), plus a short primed continuation of a held-out clip.

Artifacts under runs/evidence/full/: metrics.jsonl, scores.json,
trajectory.json, loss_curve.png, sample_free.wav, sample_primed.wav,
README.md.

Usage: python tools/full_evidence.py [steps]     (default 20000; GPU)
       python tools/full_evidence.py resume      (redo 2-3 from checkpoint)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np                                          # noqa: E402

RESUME = len(sys.argv) > 1 and sys.argv[1] == "resume"
STEPS = (int(sys.argv[1]) if len(sys.argv) > 1 and not RESUME else 20000)
EVAL_EVERY = 2000
ROOT = "runs/evidence/full"
CORPUS = os.path.join(ROOT, "corpus_train")   # generated, not committed
EVAL = "runs/evidence/vocoder/corpus_eval"
N_CLIPS, CLIP_S, CORPUS_SEED = 256, 4.0, 1234


def ensure_corpus():
    """Deterministically (re)generate the training corpus: N_CLIPS x 4 s
    speech-like clips from seed 1234 — a DIFFERENT seed from the committed
    vocoder corpus/eval stream (seed 42), so train and held-out sets are
    independent draws.  Sizing (measured round 4): the ~5M-param flagship
    memorizes small corpora — held-out 6.5 bits vs 2.6 train after 4k
    steps on 24 clips, still 4-7.6 bits on 64 clips (~100 epochs); 256
    clips (~24 epochs at 6k steps) keeps the held-out gap meaningful.
    Not committed (~33 MB): this function reproduces it bit-exactly."""
    import importlib.util
    import numpy as np
    from wavenet_tpu.audio.io import write_wav
    if (os.path.isdir(CORPUS)
            and len(os.listdir(CORPUS)) == N_CLIPS):
        return
    spec = importlib.util.spec_from_file_location(
        "msc", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "make_speechlike_corpus.py"))
    msc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(msc)
    os.makedirs(CORPUS, exist_ok=True)
    rng = np.random.default_rng(CORPUS_SEED)
    for i in range(N_CLIPS):
        write_wav(os.path.join(CORPUS, f"clip_{i:04d}.wav"),
                  msc.make_clip(rng, CLIP_S), msc.SR)


def main():
    import jax
    import jax.numpy as jnp

    from wavenet_tpu.audio import mulaw
    from wavenet_tpu.audio.io import read_wav, write_wav
    from wavenet_tpu.config import full
    from wavenet_tpu.models.api import WaveNet

    os.makedirs(ROOT, exist_ok=True)
    # EMA horizon must fit the run: 0.9999 over a 6k-step run leaves the
    # average ~55% at the INIT weights (scored 5.5-7.4 held-out bits where
    # the raw weights scored 2.8-3.9 — measured round 4, the classic short-
    # run Polyak pitfall).  0.999 = ~1k-step horizon, well inside STEPS.
    ema = 0.999 if STEPS < 50_000 else 0.9999
    cfg = full().replace(lr_schedule="cosine", lr_decay_steps=STEPS,
                         ema_decay=ema)
    metrics_path = os.path.join(ROOT, "metrics.jsonl")

    if not RESUME:
        from wavenet_tpu.audio.dataset import AudioDataset
        from wavenet_tpu.training.trainer import Trainer
        from wavenet_tpu.models import wavenet as wn
        from wavenet_tpu.audio.io import read_wav as _read
        ensure_corpus()
        print(f"training full preset: {STEPS} steps on {N_CLIPS} clips, "
              f"held-out trajectory every {EVAL_EVERY}", flush=True)
        ds = AudioDataset.from_dir(CORPUS, cfg)
        tr = Trainer(cfg, ds, checkpoint_dir=os.path.join(ROOT, "ckpt"))

        # held-out trajectory machinery: score every eval clip at each
        # segment boundary, for BOTH the raw and the EMA weights (the raw
        # curve shows optimization progress; the EMA curve is what ships)
        eval_paths = sorted(os.path.join(EVAL, nm)
                            for nm in os.listdir(EVAL)
                            if nm.endswith(".wav"))
        eval_toks = []
        for pth in eval_paths:
            w, _ = _read(pth, cfg.sample_rate)
            eval_toks.append(jnp.asarray(
                mulaw.encode_np(w, cfg.quantization_channels)[None]))
        score_jit = jax.jit(lambda p, t: wn.score_fn(p, cfg, t))

        def held_out_median(params):
            vals = sorted(float(score_jit(params, t)[0]) for t in eval_toks)
            n = len(vals)
            return (vals[n // 2] if n % 2
                    else 0.5 * (vals[n // 2 - 1] + vals[n // 2]))

        traj = []
        traj_path = os.path.join(ROOT, "trajectory.json")
        with open(metrics_path, "w") as mf:
            def hook(step, m):
                mf.write(json.dumps({"step": step, **m}) + "\n")
                mf.flush()
            done = 0
            while done < STEPS:
                seg = min(EVAL_EVERY, STEPS - done)
                tr.run(num_steps=seg, log_every=100, metrics_fn=hook)
                done += seg
                rec = {"step": done,
                       "held_out_median_raw":
                           round(held_out_median(tr.state.params), 3)}
                if tr.state.ema is not None:
                    rec["held_out_median_ema"] = round(
                        held_out_median(tr.state.ema), 3)
                traj.append(rec)
                with open(traj_path, "w") as tf:
                    json.dump(traj, tf, indent=1)
                print(f"trajectory @{done}: {rec}", flush=True)
        tr.save()               # durable by default (round-5 contract)
        last = json.loads(open(metrics_path).readlines()[-1])
    else:
        if not os.path.exists(metrics_path):
            raise SystemExit(f"resume: {metrics_path} missing")
        last = json.loads(open(metrics_path).readlines()[-1])

    model = WaveNet.from_checkpoint(os.path.join(ROOT, "ckpt"))

    # --- held-out bits/sample ---
    scores = {}
    eval_paths = sorted(os.path.join(EVAL, n) for n in os.listdir(EVAL)
                        if n.endswith(".wav"))
    for p in eval_paths:
        w, _ = read_wav(p, cfg.sample_rate)
        bps = float(model.score(waveform=jnp.asarray(w[None]))[0])
        scores[os.path.basename(p)] = round(bps, 3)
    with open(os.path.join(ROOT, "scores.json"), "w") as f:
        json.dump({"held_out_bits_per_sample": scores,
                   "final_train_loss_nats": last.get("loss"),
                   "final_train_bits_per_sample":
                       last.get("bits_per_sample")}, f, indent=2)

    # --- loss curve ---
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        recs = [json.loads(l) for l in open(metrics_path)]
        plt.figure(figsize=(7, 3.2))
        plt.plot([r["step"] for r in recs], [r["loss"] for r in recs])
        plt.xlabel("step"); plt.ylabel("loss (nats)")
        plt.title(f"full preset, {STEPS} steps, speech-like corpus")
        plt.tight_layout()
        plt.savefig(os.path.join(ROOT, "loss_curve.png"), dpi=110)
    except Exception as e:                          # matplotlib optional
        print(f"loss_curve skipped: {e!r}", flush=True)

    # --- free-running + primed samples through the routed decoder ---
    from wavenet_tpu.generate.sampler import generate_auto, tokens_to_waveform
    params = model.params        # from_checkpoint loads the EMA by default
    n = 2 * cfg.sample_rate
    toks = generate_auto(params, cfg, jax.random.PRNGKey(0), n,
                         batch=1, temperature=1.0)
    write_wav(os.path.join(ROOT, "sample_free.wav"),
              tokens_to_waveform(toks, cfg)[0], cfg.sample_rate)
    w, _ = read_wav(eval_paths[0], cfg.sample_rate)
    prime = mulaw.encode_np(w[:cfg.sample_rate],
                            cfg.quantization_channels)[None]
    toks = generate_auto(params, cfg, jax.random.PRNGKey(1), n,
                         batch=1, prime_tokens=jnp.asarray(prime),
                         temperature=1.0)
    write_wav(os.path.join(ROOT, "sample_primed.wav"),
              tokens_to_waveform(toks, cfg)[0], cfg.sample_rate)

    # --- README ---
    rows = "\n".join(f"| {k} | {v} |" for k, v in scores.items())
    traj_rows = ""
    traj_path = os.path.join(ROOT, "trajectory.json")
    if os.path.exists(traj_path):
        traj = json.load(open(traj_path))
        traj_rows = "\n".join(
            f"| {r['step']} | {r.get('held_out_median_raw', '-')} | "
            f"{r.get('held_out_median_ema', '-')} |" for r in traj)
        traj_rows = ("\n- held-out MEDIAN bits/sample trajectory "
                     "(20 unseen clips, every "
                     f"{EVAL_EVERY} steps — raw and EMA weights):\n\n"
                     "| step | raw | ema |\n|---|---|---|\n"
                     + traj_rows + "\n")
    with open(os.path.join(ROOT, "README.md"), "w") as f:
        f.write(f"""# `full` flagship preset — training evidence

`full` preset (4x1..512, 128 residual / 256 skip, RF ~0.26 s @16 kHz,
B=8, W=8192, remat, EMA {ema}, cosine lr to {STEPS} steps), {STEPS}
steps on a {N_CLIPS}-clip synthetic speech-like corpus
(deterministically regenerable: seed {CORPUS_SEED},
`tools/full_evidence.py ensure_corpus` — an independent draw from the
committed vocoder corpus stream), one {jax.devices()[0].device_kind}.  Held-out clips are the committed
`runs/evidence/vocoder/corpus_eval` set (20 clips after the round-4
extension).

- final train: loss {last.get('loss'):.3f} nats
  ({last.get('bits_per_sample'):.3f} bits/sample); curve:
  `loss_curve.png` / `metrics.jsonl`
{traj_rows}
- held-out bits/sample per clip at the end of training (teacher-forced,
  EMA weights):

| clip | bits/sample |
|---|---|
{rows}

- `sample_free.wav` / `sample_primed.wav`: 2 s free-running and
  held-out-primed samples decoded through the routed decoder
  (`generate_auto`) from the EMA weights.
""")
    print(json.dumps(scores, indent=1), flush=True)
    print("full evidence complete", flush=True)


if __name__ == "__main__":
    main()
