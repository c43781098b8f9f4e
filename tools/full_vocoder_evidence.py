"""Training-quality evidence for the FLAGSHIP VOCODER preset (round 5).

`full_vocoder` (the `full` stack + 80-mel local conditioning) is the
realistic TTS product config (BASELINE configs 3+5 jointly); this produces
its training evidence:

  1. train `full_vocoder` on the regenerable 256-clip speech-like corpus
     (tools/full_evidence.ensure_corpus — the same corpus as the
     unconditional flagship run), cosine lr, loss curve to metrics.jsonl;
  2. held-out likelihood: score every corpus_eval clip in bits/sample
     under its own mel, against the committed UNCONDITIONAL `full` run's
     per-clip scores (runs/evidence/full/scores.json, 20k steps) — the
     conditioned flagship must win on every clip;
  3. copy-synthesis through the routed decoder with mel (WaveNet.vocode ->
     generate_auto -> the GPU decode kernel on a GPU): held-out mel ->
     waveform for the first N_SYNTH clips; log-mel L1 between every
     (synth, source) pair must be minimized on the diagonal (the output
     tracks the conditioning, not the corpus prior).

Artifacts under runs/evidence/full_vocoder/: metrics.jsonl, scores.json,
melconf.json, copysyn_*.wav, README.md.

Usage: python tools/full_vocoder_evidence.py [steps]   (default 8000; GPU)
       python tools/full_vocoder_evidence.py resume    (redo 2-3 from ckpt)
"""

import importlib.util
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np                                          # noqa: E402

RESUME = len(sys.argv) > 1 and sys.argv[1] == "resume"
STEPS = (int(sys.argv[1]) if len(sys.argv) > 1 and not RESUME else 8000)
ROOT = "runs/evidence/full_vocoder"
EVAL = "runs/evidence/vocoder/corpus_eval"
UNCOND_SCORES = "runs/evidence/full/scores.json"
N_SYNTH = 6


def _full_evidence_mod():
    spec = importlib.util.spec_from_file_location(
        "fev", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "full_evidence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    import jax
    import jax.numpy as jnp

    from wavenet_tpu.audio import mulaw
    from wavenet_tpu.audio.io import read_wav, write_wav
    from wavenet_tpu.audio.mel import log_mel
    from wavenet_tpu.config import full_vocoder
    from wavenet_tpu.models.api import WaveNet

    os.makedirs(ROOT, exist_ok=True)
    cfg = full_vocoder().replace(lr_schedule="cosine", lr_decay_steps=STEPS,
                                 ema_decay=0.999)
    metrics_path = os.path.join(ROOT, "metrics.jsonl")

    if not RESUME:
        from wavenet_tpu.audio.dataset import AudioDataset
        from wavenet_tpu.training.trainer import Trainer
        fev = _full_evidence_mod()
        fev.ensure_corpus()
        print(f"training full_vocoder: {STEPS} steps on "
              f"{fev.N_CLIPS} clips (mel-conditioned)", flush=True)
        ds = AudioDataset.from_dir(fev.CORPUS, cfg)
        tr = Trainer(cfg, ds, checkpoint_dir=os.path.join(ROOT, "ckpt"))
        with open(metrics_path, "w") as mf:
            def hook(step, m):
                mf.write(json.dumps({"step": step, **m}) + "\n")
                mf.flush()
            tr.run(num_steps=STEPS, log_every=200, metrics_fn=hook)
        tr.save()               # durable by default
        last = json.loads(open(metrics_path).readlines()[-1])
    else:
        if not os.path.exists(metrics_path):
            raise SystemExit(f"resume: {metrics_path} missing")
        last = json.loads(open(metrics_path).readlines()[-1])

    voc = WaveNet.from_checkpoint(os.path.join(ROOT, "ckpt"))
    uncond = (json.load(open(UNCOND_SCORES))["held_out_bits_per_sample"]
              if os.path.exists(UNCOND_SCORES) else {})

    eval_paths = sorted(os.path.join(EVAL, n) for n in os.listdir(EVAL)
                        if n.endswith(".wav"))
    waves = [read_wav(p, cfg.sample_rate)[0] for p in eval_paths]

    # --- held-out likelihood vs the unconditional flagship run ---
    scores = {}
    for p, w in zip(eval_paths, waves):
        mel = jnp.asarray(log_mel(w, cfg.sample_rate, cfg.mel)[None])
        n = mel.shape[1] * cfg.mel.hop_length
        wv = jnp.asarray(w[:n + 1][None])
        bps = float(voc.score(waveform=wv, mel=mel)[0])
        name = os.path.basename(p)
        scores[name] = {"vocoder_bits_per_sample": round(bps, 3),
                        "uncond_full_20k_bits_per_sample":
                            uncond.get(name)}
        print(f"{name}: vocoder {bps:.3f} vs uncond-full "
              f"{uncond.get(name)}", flush=True)
    wins = all(v["uncond_full_20k_bits_per_sample"] is None
               or v["vocoder_bits_per_sample"]
               < v["uncond_full_20k_bits_per_sample"]
               for v in scores.values())
    med = sorted(v["vocoder_bits_per_sample"] for v in scores.values())
    med = med[len(med) // 2]
    json.dump({"per_clip": scores, "vocoder_wins_every_clip": wins,
               "vocoder_held_out_median": med, "steps": STEPS},
              open(os.path.join(ROOT, "scores.json"), "w"), indent=1)
    print("flagship vocoder wins every held-out clip:", wins,
          "| median", med, flush=True)

    # --- copy-synthesis through the routed decoder with mel ---
    synth_mels, src_mels = [], []
    for p, w in zip(eval_paths[:N_SYNTH], waves[:N_SYNTH]):
        toks = voc.vocode(w, key=jax.random.PRNGKey(7), temperature=0.9)
        out = np.asarray(mulaw.decode(toks, cfg.quantization_channels))[0]
        name = os.path.basename(p).replace("clip", "copysyn")
        write_wav(os.path.join(ROOT, name), out, cfg.sample_rate)
        synth_mels.append(log_mel(out, cfg.sample_rate, cfg.mel))
        src_mels.append(log_mel(w[:len(out)], cfg.sample_rate, cfg.mel))
        print("copysyn:", name, flush=True)
    n_ev = len(synth_mels)
    conf = np.zeros((n_ev, n_ev))
    for i in range(n_ev):
        for j in range(n_ev):
            F = min(len(synth_mels[i]), len(src_mels[j]))
            conf[i, j] = float(np.mean(np.abs(
                synth_mels[i][:F] - src_mels[j][:F])))
    diag_best = all(np.argmin(conf[i]) == i for i in range(n_ev))
    print("log-mel L1 (rows=synth, cols=source):\n", np.round(conf, 3),
          flush=True)
    json.dump({"log_mel_l1": conf.tolist(),
               "diagonal_is_row_min": diag_best},
              open(os.path.join(ROOT, "melconf.json"), "w"), indent=1)

    rows = "\n".join(
        f"| {k} | {v['vocoder_bits_per_sample']} | "
        f"{v['uncond_full_20k_bits_per_sample']} |"
        for k, v in scores.items())
    with open(os.path.join(ROOT, "README.md"), "w") as f:
        f.write(f"""# Flagship vocoder (`full_vocoder` preset) — evidence

`full_vocoder` (4x1..512, 128/256 ch + 80-mel local conditioning — the
round-5 preset), {STEPS} steps (cosine lr, EMA 0.999) on the regenerable
256-clip corpus shared with the unconditional flagship run; one
{jax.devices()[0].device_kind}.

- final train: loss {last.get('loss', float('nan')):.3f} nats
  ({last.get('bits_per_sample', float('nan')):.3f} bits/sample);
  curve: `metrics.jsonl`
- held-out bits/sample under OWN mel vs the committed 20k-step
  UNCONDITIONAL `full` run (runs/evidence/full/scores.json):

| clip | vocoder (own mel) | uncond full @20k |
|---|---|---|
{rows}

  vocoder wins every clip: **{wins}** (median {med}; the unconditional
  run's 20k-step median was 2.55 — same corpus and schedule family)
- copy-synthesis `copysyn_*.wav` ({n_ev} held-out clips) decoded through
  the routed decoder with mel (`WaveNet.vocode` -> `generate_auto`);
  log-mel L1 minimized
  on the diagonal for every row: **{diag_best}** (`melconf.json`).
""")
    print("evidence written to", ROOT, flush=True)


if __name__ == "__main__":
    main()
