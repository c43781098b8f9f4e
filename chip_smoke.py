#!/usr/bin/env python3
"""Smoke run of the main path on one NVIDIA GPU, at the `full` widths.

    python3 chip_smoke.py            # device, train, serve, kernel check
    python3 chip_smoke.py --sweep    # the decode kernel-vs-scan sweep only
    python3 chip_smoke.py --multi    # the four-GPU paths only

Phases, in one process, in order:

  1. device  — jax.devices(), the card's name and power limit; exits
               non-zero unless JAX's platform is "gpu" (no CPU fallback).
  2. train   — Trainer on the `full` preset at its own widths (B=8,
               W=8192, remat) for a few steps on synthetic audio; step 1's
               loss against the float32 `highest`-precision reference; a
               checkpoint saved through the checkpointer.
  3. serve   — the checkpoint restored as serve.py does, the HTTP front end
               on a thread: an unconditioned, a streamed, and a mel request
               (on a `full_vocoder` model); WAV lengths and same-seed
               replays checked.
  4. kernel  — the GPU decode kernel against the scan at real widths
               (`full`, `full_vocoder` with mel, `fastgen_bench`): 2,048
               teacher-forced steps of logits and greedy choices, a
               chunk-continuation check, one short timing of each route.

A failed check exits non-zero.  The last line of standard output is one
JSON object naming the device; it is printed only when every phase passed.
Details go to --out (default chiprun_out/chip_smoke).
"""

from __future__ import annotations

import argparse
import base64
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave

TRAIN_STEPS = 6
# bf16 path vs f32 `highest` reference, step 1.  H100 readings at `full`:
# sound 9e-6 and 4e-5 relative; one layer dropped 3.8e-3 and 4.6e-3.
LOSS_RTOL = 1e-3
CHECK_STEPS = 2048        # kernel-vs-scan teacher-forced steps
TIMING_STEPS = 2048
SCAN_UNROLLS = (1, 8, 40)
SWEEP = (("full", 8, 16384, False), ("full_vocoder", 8, 16384, True),
         ("conditional", 8, 16384, True), ("fastgen_bench", 64, 8192, False))
SWEEP_ROUNDS = 5

RESULTS: dict = {}


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    log(f"  ok: {what}")


def block(x):
    import jax
    return jax.block_until_ready(x)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(count: int):
    import jax
    devs = jax.devices()
    log("devices:", devs)
    d = devs[0]
    log("device_kind:", d.device_kind)
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX's platform "
                         f"is {d.platform!r}")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX finds "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(smi)
    RESULTS["device"] = {"platform": d.platform, "kind": d.device_kind,
                         "count": len(devs), "nvidia_smi": smi}
    return d


# ---------------------------------------------------------------------------
# 2. train
# ---------------------------------------------------------------------------

def phase_train(ckpt_dir: str):
    import jax
    import numpy as np

    from wavenet_tpu.audio.dataset import AudioDataset
    from wavenet_tpu.config import get_config
    from wavenet_tpu.models import wavenet as wn
    from wavenet_tpu.training.trainer import Trainer

    log("== train: full preset")
    cfg = get_config("full")
    log(f"  B={cfg.batch_size} W={cfg.train_window} R={cfg.residual_channels}"
        f" S={cfg.skip_channels} L={cfg.num_layers} remat={cfg.remat}")
    ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=1.0)
    tr = Trainer(cfg, ds, checkpoint_dir=ckpt_dir)
    batch, _ = ds.sample_batch(tr.iter_state)      # the first step's batch
    ref = float(block(jax.jit(
        lambda p, t: wn.reference_loss_fn(p, cfg, t)[0])(
            tr.state.params, batch["tokens"])))
    losses = []
    t0 = time.perf_counter()
    m = tr.run(TRAIN_STEPS, log_every=1, log_fn=lambda s: None,
               metrics_fn=lambda step, mm: losses.append(mm["loss"]))
    total = time.perf_counter() - t0
    losses.append(m["loss"])
    step_s = 1.0 / m["steps_per_sec"]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    first = total - (TRAIN_STEPS - 1) * step_s
    log(f"  losses {[round(v, 4) for v in losses]}")
    log(f"  step 1 loss {losses[0]:.6f} vs f32 reference {ref:.6f}")
    log(f"  step time {step_s * 1e3:.2f} ms, "
        f"{m['audio_seconds_per_sec']:.1f} audio-s/s, first step (compile "
        f"included) {first:.1f} s, peak_bytes_in_use {peak}")
    RESULTS["train"] = {"losses": losses, "reference_loss": ref,
                        "step_ms": step_s * 1e3,
                        "audio_seconds_per_sec": m["audio_seconds_per_sec"],
                        "first_step_s": first, "peak_bytes_in_use": peak}
    check(all(np.isfinite(losses)), "training losses are finite")
    check(abs(losses[0] - ref) <= LOSS_RTOL * abs(ref),
          f"step-1 loss within {LOSS_RTOL} relative of the f32 reference")
    tr.save()
    check(tr.ckpt.latest_step() == TRAIN_STEPS,
          f"checkpoint at step {TRAIN_STEPS} saved")
    del tr


# ---------------------------------------------------------------------------
# 3. serve
# ---------------------------------------------------------------------------

def _post(port: int, body: dict) -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def _wav_samples(data: bytes):
    with wave.open(io.BytesIO(data)) as w:
        return w.getnframes(), w.readframes(w.getnframes())


def _serve(model, requests):
    """Run the engine + HTTP front end on a thread, answer `requests`
    (name, body, check_fn) in order, shut down."""
    from wavenet_tpu.serving import WaveNetServer
    from wavenet_tpu.serving.http import make_server
    engine = WaveNetServer(model, max_batch=4, chunk_seconds=0.25,
                           length_quantum_seconds=0.25)
    server = make_server(engine, host="127.0.0.1", port=0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        for name, body, fn in requests:
            t0 = time.perf_counter()
            a = _post(port, body)
            t1 = time.perf_counter()
            b = _post(port, body)                 # same seed: a replay
            t2 = time.perf_counter()
            log(f"  {name}: {len(a)} bytes, first {t1 - t0:.2f} s "
                f"(compile included), replay {t2 - t1:.2f} s")
            RESULTS.setdefault("serve", {})[name] = {
                "bytes": len(a), "first_s": t1 - t0, "replay_s": t2 - t1}
            fn(a)
            check(a == b, f"{name}: the same seed replays the same audio")
    finally:
        server.shutdown()
        engine.close()


def phase_serve(ckpt_dir: str):
    import jax
    import numpy as np

    from wavenet_tpu.config import get_config
    from wavenet_tpu.models.api import WaveNet

    log("== serve: restored full checkpoint, HTTP front end")
    model = WaveNet.from_checkpoint(ckpt_dir)     # as serve.py does
    n = int(0.25 * model.cfg.sample_rate)

    def wav_len(data):
        frames, _ = _wav_samples(data)
        check(frames == n, f"WAV holds {n} samples")

    def stream_len(data):
        check(len(data) == 2 * n, f"streamed PCM holds {n} int16 samples")

    _serve(model, [
        ("unconditioned", {"seconds": 0.25, "seed": 7}, wav_len),
        ("streamed", {"seconds": 0.25, "seed": 7, "stream": True},
         stream_len),
    ])

    log("== serve: full_vocoder model (random weights), mel request")
    voc = WaveNet(get_config("full_vocoder")).init(jax.random.PRNGKey(3))
    M, hop = voc.cfg.mel.num_mels, voc.cfg.mel.hop_length
    frames = -(-n // hop)
    mel = np.random.default_rng(0).standard_normal((frames, M))
    mel_b64 = base64.b64encode(mel.astype("<f4").tobytes()).decode()
    _serve(voc, [("mel", {"seconds": 0.25, "seed": 11, "mel_b64": mel_b64},
                  wav_len)])


# ---------------------------------------------------------------------------
# 4. kernel
# ---------------------------------------------------------------------------

def _preset(name: str, batch: int, steps: int, mel: bool, seed: int = 1):
    import jax
    from wavenet_tpu.config import get_config
    from wavenet_tpu.models import wavenet as wn
    cfg = get_config(name)
    params = wn.init_params(cfg, jax.random.PRNGKey(seed))
    y = None
    if mel:
        y = 0.5 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                    (batch, steps, cfg.mel.num_mels))
    return cfg, params, y


def _seconds(fn):
    t0 = time.perf_counter()
    block(fn())
    return time.perf_counter() - t0


def time_routes(name, cfg, params, batch: int, steps: int, y, unrolls,
                rounds: int = 1):
    """Steps/s of the kernel and of the scan at each unroll, one process.

    Each route's first call (compile included) is timed on its own; then
    `rounds` rounds time every route once each, interleaved so that drift
    of the card's clock falls on all routes alike.  A route more than 20%
    behind the leader after the first round drops out.  Returns, per route,
    the median steps/s, the rounds' min and max, and the first call's
    seconds."""
    import statistics

    import jax
    import jax.numpy as jnp
    from wavenet_tpu.models import wavenet as wn
    from wavenet_tpu.models.conditioning import project_cond
    from wavenet_tpu.ops.pallas import decode_gpu
    state = wn.decode_init(cfg, batch)
    tok = jnp.full((batch,), cfg.quantization_channels // 2, jnp.int32)
    seeds = jnp.arange(batch, dtype=jnp.int32)
    cond = None if y is None else project_cond(params, y)
    fns = {"kernel": lambda: decode_gpu.decode_chunk(
        params, cfg, state, tok, seeds, steps, 1.0, y=y)[2]}
    for u in unrolls:
        fn = jax.jit(functools.partial(
            wn.decode_sample_chunk, cfg=cfg.replace(decode_unroll=u), i0=0,
            n=steps, temperature=1.0))
        fns[f"scan_unroll{u}"] = functools.partial(
            lambda f: f(params, state=state, first=tok,
                        key=jax.random.PRNGKey(0), cond=cond,
                        seeds=seeds)[2], fn)
    first = {k: _seconds(fn) for k, fn in fns.items()}
    runs = {k: [] for k in fns}
    live = list(fns)
    for r in range(rounds):
        for k in live:
            runs[k].append(steps / _seconds(fns[k]))
        if r == 0:
            lead = max(runs[k][0] for k in live)
            live = [k for k in live if runs[k][0] >= 0.8 * lead]
    out = {}
    for k, v in runs.items():
        out[k] = {"steps_per_s": statistics.median(v), "min": min(v),
                  "max": max(v), "rounds": len(v), "first_call_s": first[k]}
        log(f"  {name} B={batch} {k}: median {out[k]['steps_per_s']:.1f} "
            f"steps/s over {len(v)} (min {min(v):.1f}, max {max(v):.1f}), "
            f"{out[k]['steps_per_s'] * batch:.1f} samples/s; first call "
            f"{first[k]:.2f} s")
    return out


def phase_kernel():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from wavenet_tpu.models import wavenet as wn
    from wavenet_tpu.ops.pallas import decode_gpu

    log("== kernel: GPU decode kernel vs the scan, teacher-forced "
        f"{CHECK_STEPS} steps")
    log(f"  tolerances: mean {decode_gpu.LOGITS_MEAN_TOL}, max "
        f"{decode_gpu.LOGITS_MAX_TOL}, greedy margin "
        f"{decode_gpu.MARGIN_TOL}")
    RESULTS["kernel"] = {}
    for name, batch, mel in (("full", 8, False), ("full_vocoder", 8, True),
                             ("fastgen_bench", 64, False)):
        cfg, params, y = _preset(name, batch, CHECK_STEPS, mel)
        t0 = time.perf_counter()
        r = decode_gpu.compare_with_scan(params, cfg, batch, CHECK_STEPS,
                                         y=y)
        r["seconds"] = time.perf_counter() - t0
        log(f"  {name} B={batch}: {r}")
        RESULTS["kernel"][name] = r
        check(r["ok"], f"{name}: kernel logits and greedy choices within "
                       f"tolerance of the scan")

    cfg, params, _ = _preset("full", 8, 0, False)
    B, n = 8, 1024
    state = wn.decode_init(cfg, B)
    tok = jnp.full((B,), 128, jnp.int32)
    seeds = jnp.arange(B, dtype=jnp.int32)
    _, _, one = decode_gpu.decode_chunk(params, cfg, state, tok, seeds,
                                        2 * n, 1.0)
    st, nxt, a = decode_gpu.decode_chunk(params, cfg, state, tok, seeds, n,
                                         1.0)
    _, _, b = decode_gpu.decode_chunk(params, cfg, st, nxt, seeds, n, 1.0)
    check(bool((jnp.concatenate([a, b], 1) == one).all()),
          "full: two kernel chunks equal one (sampled, carried state)")

    log(f"== timing: full B=8, {TIMING_STEPS} steps")
    RESULTS["timing_full_b8"] = time_routes("full", cfg, params, 8,
                                            TIMING_STEPS, None, (40,))


def phase_sweep():
    """Kernel vs the scan at each unroll of SCAN_UNROLLS, per SWEEP preset,
    over SWEEP_ROUNDS interleaved rounds."""
    log("== sweep: decode steps/s, kernel vs scan")
    RESULTS["sweep"] = {}
    for name, batch, steps, mel in SWEEP:
        cfg, params, y = _preset(name, batch, steps, mel)
        RESULTS["sweep"][name] = dict(
            batch=batch, steps=steps,
            **time_routes(name, cfg, params, batch, steps, y, SCAN_UNROLLS,
                          SWEEP_ROUNDS))


# ---------------------------------------------------------------------------
# --multi: four GPUs
# ---------------------------------------------------------------------------

def _tree_close(a, b, rtol):
    """Relative L2 distance of two param trees, compared on the host."""
    import jax
    import numpy as np
    a, b = jax.device_get(a), jax.device_get(b)
    num = sum(float(np.sum((np.asarray(x, np.float64) - y) ** 2))
              for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    den = sum(float(np.sum(np.asarray(y, np.float64) ** 2))
              for y in jax.tree.leaves(b))
    rel = (num / den) ** 0.5
    return rel, rel <= rtol


def _one_step(cfg, devices, batch):
    import jax
    from wavenet_tpu.audio.dataset import AudioDataset
    from wavenet_tpu.parallel.mesh import make_mesh
    from wavenet_tpu.training.trainer import Trainer
    ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=1.0)
    tr = Trainer(cfg, ds, mesh=make_mesh(cfg, devices))
    with tr.mesh:
        state, m = tr._step(tr.state, batch)
    return block(state), jax.device_get(m), tr


def phase_multi():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from wavenet_tpu.audio.dataset import AudioDataset, IteratorState
    from wavenet_tpu.config import get_config
    from wavenet_tpu.models import wavenet as wn
    from wavenet_tpu.ops import rng
    from wavenet_tpu.ops.pallas import decode_gpu
    from wavenet_tpu.parallel import distdecode

    devs = jax.devices()[:4]
    cfg = get_config("full")
    ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=1.0)
    batch, _ = ds.sample_batch(IteratorState(seed=cfg.seed, step=0))
    RESULTS["multi"] = {}

    log("== multi: one card, the reference step")
    ref_state, ref_m, _ = _one_step(cfg, devs[:1], batch)

    for label, c in (("data (4,1,1)", cfg.replace(data_parallel=4)),
                     ("seq x model (1,2,2)",
                      cfg.replace(seq_parallel=2, model_parallel=2))):
        log(f"== multi: {label}")
        st, m, tr = _one_step(c, devs, batch)
        rel, ok = _tree_close(st.params, ref_state.params, 1e-2)
        log(f"  loss {m['loss']:.6f} vs one card {ref_m['loss']:.6f}; "
            f"grad norm {m['grad_norm']:.6f} vs {ref_m['grad_norm']:.6f}; "
            f"updated params rel. L2 diff {rel:.2e}")
        spread = [len(x.sharding.device_set) for x in
                  jax.tree.leaves(st.params)]
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
        log(f"  devices per param leaf {sorted(set(spread))}; "
            f"peak_bytes_in_use per device {peaks}")
        RESULTS["multi"][label] = {"loss": float(m["loss"]),
                                   "ref_loss": float(ref_m["loss"]),
                                   "param_rel_l2": rel, "peaks": peaks}
        check(abs(m["loss"] - ref_m["loss"]) <= 1e-3 * abs(ref_m["loss"]),
              f"{label}: loss matches one card")
        check(abs(m["grad_norm"] - ref_m["grad_norm"])
              <= 0.05 * ref_m["grad_norm"],
              f"{label}: gradient norm within 5% of one card")
        check(ok, f"{label}: updated params within 1e-2 rel. L2 of one card")
        check(all(p and p > 0 for p in peaks),
              f"{label}: every device holds arrays")
        if label.startswith("data"):
            check(min(spread) == 4, f"{label}: params replicated on all 4")
        del tr, st

    params = wn.init_params(cfg, jax.random.PRNGKey(1))
    B, n = 8, 512
    tok = jnp.full((B,), cfg.quantization_channels // 2, jnp.int32)
    log("== multi: generate_sharded on (2 data, 2 model), greedy")
    mesh = Mesh(np.asarray(devs).reshape(2, 2),
                (distdecode.DATA_AXIS, distdecode.MODEL_AXIS))
    toks = distdecode.generate_sharded(params, cfg, mesh, 0, n, B,
                                       temperature=0.0)
    r = decode_gpu.greedy_margins(params, cfg, tok, jnp.asarray(toks))
    log(f"  {r}")
    RESULTS["multi"]["generate_sharded"] = r
    check(r["max_margin"] <= decode_gpu.MARGIN_TOL,
          "generate_sharded greedy choices are single-device argmaxes "
          "within tolerance")

    log("== multi: kernel fan-out on (4 data, 1 model)")
    mesh = Mesh(np.asarray(devs).reshape(4, 1),
                (distdecode.DATA_AXIS, distdecode.MODEL_AXIS))
    seeds = rng.as_row_seeds(5, B)
    fan = distdecode.generate_pallas_dp(params, cfg, mesh, seeds, n, B,
                                        temperature=0.0)
    one = decode_gpu.generate(params, cfg, None, n, batch=B, seeds=seeds,
                              temperature=0.0)
    same = bool((jnp.asarray(fan) == jnp.asarray(one)).all())
    r = decode_gpu.greedy_margins(params, cfg, tok, jnp.asarray(fan))
    log(f"  equal to one card's kernel: {same}; {r}")
    RESULTS["multi"]["kernel_fanout"] = dict(r, equal_to_one_card=same)
    check(same, "kernel fan-out tokens equal one card's kernel")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU paths")
    ap.add_argument("--sweep", action="store_true",
                    help="run only the timing of the decode kernel against "
                         f"the scan at unrolls {SCAN_UNROLLS} for "
                         f"{[s[0] for s in SWEEP]}")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "chip_smoke"))
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wavenet_tpu.utils import compcache
    count = 4 if args.multi else 1
    dev = phase_device(count)
    log("compilation cache:", compcache.enable())
    t0 = time.perf_counter()
    if args.multi:
        phase_multi()
    elif args.sweep:
        phase_sweep()
    else:
        with tempfile.TemporaryDirectory(dir=_mkdir(args.out)) as tmp:
            ckpt = os.path.join(tmp, "ckpt")
            phase_train(ckpt)
            phase_serve(ckpt)
        phase_kernel()
    RESULTS["seconds"] = time.perf_counter() - t0
    name = "multi" if args.multi else "sweep" if args.sweep else "smoke"
    with open(os.path.join(_mkdir(args.out), f"{name}.json"), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


def _mkdir(d: str) -> str:
    os.makedirs(d, exist_ok=True)
    return d


if __name__ == "__main__":
    sys.exit(main())
