"""Training integration tests (SURVEY.md §4 "Integration"): a tiny config
overfits a single synthetic clip; checkpoint/restore resumes exactly."""

import numpy as np
import jax
import pytest

from wavenet_tpu.audio.dataset import AudioDataset, IteratorState
from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.training.trainer import Trainer


def micro_cfg(**kw):
    base = dict(num_blocks=1, max_dilation=16, residual_channels=16,
                skip_channels=16, compute_dtype="float32",
                batch_size=2, train_window=256, learning_rate=4e-3)
    base.update(kw)
    return WaveNetConfig(**base)


def test_overfit_single_clip():
    cfg = micro_cfg()
    ds = AudioDataset.synthetic(cfg, num_clips=1, clip_seconds=0.1)
    tr = Trainer(cfg, ds)
    m = tr.run(num_steps=250, log_every=0)
    # a periodic sine mixture is highly predictable: loss must drop far
    # below the ln(256)=5.55 init level (calibrated: ~0.4 @ 300 steps)
    assert m["loss"] < 2.0, m
    assert m["audio_seconds_per_sec"] > 0


def test_metrics_fn_hook():
    """Trainer.run streams per-log_every metrics to metrics_fn (the JSONL
    hook train.py wires to MetricsLogger)."""
    cfg = micro_cfg()
    ds = AudioDataset.synthetic(cfg, num_clips=1, clip_seconds=0.1)
    tr = Trainer(cfg, ds)
    seen = []
    tr.run(num_steps=7, log_every=2, log_fn=lambda _: None,
           metrics_fn=lambda step, m: seen.append((step, m)))
    assert [s for s, _ in seen] == [1, 3, 5]        # intervals before final
    assert all(np.isfinite(m["loss"]) for _, m in seen)


def test_deterministic_iterator():
    cfg = micro_cfg()
    ds = AudioDataset.synthetic(cfg, num_clips=3)
    s0 = IteratorState(seed=0, step=5)
    b1, s1 = ds.sample_batch(s0)
    b2, _ = ds.sample_batch(IteratorState(seed=0, step=5))
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert s1.step == 6
    b3, _ = ds.sample_batch(IteratorState(seed=0, step=6))
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_checkpoint_resume_exact(tmp_path):
    cfg = micro_cfg()
    ds = AudioDataset.synthetic(cfg, num_clips=2)
    d = str(tmp_path / "ckpt")

    tr = Trainer(cfg, ds, checkpoint_dir=d)
    tr.run(num_steps=6, log_every=0)
    tr.save()
    tr.ckpt.wait()
    tr.run(num_steps=4, log_every=0)
    final_a = jax.device_get(tr.state.params)
    iter_a = tr.iter_state

    # fresh trainer, restore at step 6, run the same 4 steps
    tr2 = Trainer(cfg, ds, checkpoint_dir=d)
    tr2.restore()
    assert int(jax.device_get(tr2.state.step)) == 6
    tr2.run(num_steps=4, log_every=0)
    final_b = jax.device_get(tr2.state.params)

    assert tr2.iter_state == iter_a
    for a, b in zip(jax.tree.leaves(final_a), jax.tree.leaves(final_b)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_config_saved_next_to_checkpoints(tmp_path):
    cfg = micro_cfg()
    ds = AudioDataset.synthetic(cfg, num_clips=2)
    d = str(tmp_path / "ckpt")
    Trainer(cfg, ds, checkpoint_dir=d)
    from wavenet_tpu.training.checkpoint import CheckpointManager
    assert CheckpointManager.load_config(d) == cfg


def test_checkpoint_dir_architecture_guard(tmp_path):
    """Reusing a checkpoint directory with a different model ARCHITECTURE
    must be refused (a stale params.json silently mis-restores); training-
    schedule fields may differ across resumes."""
    import dataclasses
    import pytest
    from wavenet_tpu.training.checkpoint import CheckpointManager
    cfg = micro_cfg()
    d = str(tmp_path / "ckpt")
    CheckpointManager(d, cfg)
    # schedule-only change: fine
    CheckpointManager(d, dataclasses.replace(cfg, learning_rate=1e-9))
    # architecture change: refused
    with pytest.raises(ValueError, match="different model architecture"):
        CheckpointManager(
            d, dataclasses.replace(
                cfg, residual_channels=cfg.residual_channels * 2))


def test_evaluate():
    cfg = micro_cfg()
    ds = AudioDataset.synthetic(cfg, num_clips=2)
    tr = Trainer(cfg, ds)
    m = tr.evaluate(num_batches=2)
    assert set(m) >= {"eval_loss", "eval_accuracy"}
    assert abs(m["eval_loss"] - np.log(256)) < 0.2
    # deterministic
    m2 = tr.evaluate(num_batches=2)
    assert m == m2


def test_lr_schedules():
    from wavenet_tpu.training.trainer import make_lr_schedule
    for sched, kw in [("constant", {}),
                      ("cosine", {}),
                      ("exponential", {}),
                      ("cosine", dict(warmup_steps=10))]:
        cfg = micro_cfg(lr_schedule=sched, lr_decay_steps=100, **kw)
        f = make_lr_schedule(cfg)
        v0, vmid, vend = float(f(0)), float(f(50)), float(f(100))
        assert np.isfinite([v0, vmid, vend]).all()
        if sched != "constant" and not kw:
            assert vend < v0
        if kw.get("warmup_steps"):
            assert v0 == 0.0 and float(f(10)) > 0


def test_overfit_then_generate_distribution():
    """SURVEY.md §4 integration gate: overfit one clip, then free-running
    generation (primed with the clip's prefix) must reproduce the clip's
    mu-law token distribution — the stand-in for 'bit-matched mu-law sample
    distributions vs reference' while the reference mount is empty."""
    from wavenet_tpu.models import wavenet as wn
    import jax.numpy as jnp

    cfg = micro_cfg(max_dilation=32, residual_channels=24, skip_channels=24,
                    train_window=512, batch_size=4, learning_rate=3e-3)
    ds = AudioDataset.synthetic(cfg, num_clips=1, clip_seconds=0.15)
    tr = Trainer(cfg, ds)
    m = tr.run(num_steps=400, log_every=0)
    assert m["loss"] < 1.5, m

    clip_tokens = ds.tokens[0]
    prime = jnp.asarray(clip_tokens[:cfg.receptive_field + 32])[None]
    n = 600
    out = np.asarray(wn.generate(
        tr.state.params, cfg, jax.random.PRNGKey(3), num_samples=n,
        batch=1, prime_tokens=prime, temperature=0.8))[0]

    # compare coarse token histograms (32 bins over the 256 classes)
    ref_hist = np.histogram(clip_tokens, bins=32, range=(0, 256))[0] / len(clip_tokens)
    gen_hist = np.histogram(out, bins=32, range=(0, 256))[0] / n
    l1 = np.abs(ref_hist - gen_hist).sum()
    assert l1 < 0.8, (l1, ref_hist.round(2), gen_hist.round(2))
    # generated audio must not be constant/silent
    assert out.std() > 1.0


def test_ema_invariants_and_checkpoint(tmp_path):
    """EMA (Polyak) averaging: decay=0 tracks params exactly, decay=1 stays
    at init; save/restore round-trips the EMA; the facade loads EMA by
    default and raw weights on request."""
    import jax.numpy as jnp
    from wavenet_tpu.models.api import WaveNet

    def run(decay, steps=2, ckpt=None):
        cfg = micro_cfg(ema_decay=decay)
        ds = AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.25)
        tr = Trainer(cfg, ds, checkpoint_dir=ckpt)
        tr.run(steps, log_every=0)
        return tr

    tr0 = run(0.0)
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr0.state.params)[0],
            jax.tree_util.tree_flatten_with_path(tr0.state.ema)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(ka))

    tr1 = run(1.0)
    init = jax.jit(lambda: __import__(
        "wavenet_tpu.models.wavenet", fromlist=["init_params"]
    ).init_params(tr1.cfg, jax.random.PRNGKey(tr1.cfg.seed)))()
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_flatten_with_path(init)[0],
            jax.tree_util.tree_flatten_with_path(tr1.state.ema)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(ka))

    # checkpoint round-trip + facade selection
    tr = run(0.5, steps=3, ckpt=str(tmp_path / "ck"))
    tr.save()
    tr.ckpt.wait()
    m_ema = WaveNet.from_checkpoint(str(tmp_path / "ck"))
    m_raw = WaveNet.from_checkpoint(str(tmp_path / "ck"), use_ema=False)
    np.testing.assert_allclose(
        np.asarray(m_ema.params["w_cur"]), np.asarray(tr.state.ema["w_cur"]))
    np.testing.assert_allclose(
        np.asarray(m_raw.params["w_cur"]),
        np.asarray(tr.state.params["w_cur"]))
    assert not np.allclose(np.asarray(m_ema.params["w_cur"]),
                           np.asarray(m_raw.params["w_cur"]))


def test_ema_checkpoint_cross_compat(tmp_path):
    """EMA toggled across save/restore: a no-EMA checkpoint restores into
    an EMA-enabled run (average seeded from the restored params), and an
    EMA checkpoint restores into a no-EMA run (average dropped)."""
    cfg0 = micro_cfg()
    ds = AudioDataset.synthetic(cfg0, num_clips=2, clip_seconds=0.25)
    tr0 = Trainer(cfg0, ds, checkpoint_dir=str(tmp_path / "a"))
    tr0.run(2, log_every=0)
    tr0.save()
    tr0.ckpt.wait()

    cfg1 = micro_cfg(ema_decay=0.9)
    tr1 = Trainer(cfg1, ds, checkpoint_dir=str(tmp_path / "a"))
    tr1.restore()
    assert tr1.state.ema is not None
    np.testing.assert_array_equal(np.asarray(tr1.state.ema["w_cur"]),
                                  np.asarray(tr0.state.params["w_cur"]))
    tr1.run(1, log_every=0)                     # averaging proceeds

    tr1.ckpt = __import__(
        "wavenet_tpu.training.checkpoint",
        fromlist=["CheckpointManager"]).CheckpointManager(
            str(tmp_path / "b"), cfg1)
    tr1.save()
    tr1.ckpt.wait()
    tr2 = Trainer(cfg0, ds, checkpoint_dir=str(tmp_path / "b"))
    tr2.restore()                                # EMA ckpt into no-EMA run
    assert tr2.state.ema is None
    np.testing.assert_array_equal(np.asarray(tr2.state.params["w_cur"]),
                                  np.asarray(tr1.state.params["w_cur"]))


def test_restore_across_mesh_shapes(tmp_path):
    """Elastic recovery: a checkpoint saved on one mesh shape restores into
    a trainer built over a DIFFERENT mesh (the checkpointer places every
    leaf onto the target's NamedShardings) and training continues with
    identical params."""
    import dataclasses
    ds_cfg = micro_cfg()
    ds = AudioDataset.synthetic(ds_cfg, num_clips=2)
    d = str(tmp_path / "ckpt")

    tr = Trainer(ds_cfg, ds, checkpoint_dir=d)         # single-device
    tr.run(num_steps=3, log_every=0)
    tr.save()
    tr.ckpt.wait()
    ref = jax.device_get(tr.state.params)

    # resume over a (2, 1, 2) dp x sp x mp mesh
    cfg2 = dataclasses.replace(ds_cfg, data_parallel=2, model_parallel=2)
    tr2 = Trainer(cfg2, ds, checkpoint_dir=d)
    tr2.restore()
    got = jax.device_get(tr2.state.params)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)
    m = tr2.run(num_steps=2, log_every=0)
    assert np.isfinite(m["loss"])

    # and back DOWN: the sharded trainer's save restores on a single device
    tr2.save()
    tr2.ckpt.wait()
    tr3 = Trainer(ds_cfg, ds, checkpoint_dir=d)
    tr3.restore()
    assert int(jax.device_get(tr3.state.step)) == 5
    got3 = jax.device_get(tr3.state.params)
    for a, b in zip(jax.tree.leaves(jax.device_get(tr2.state.params)),
                    jax.tree.leaves(got3)):
        np.testing.assert_array_equal(a, b)


def test_score_cli_exact_chunking(tmp_path):
    """score.py: chunked scoring with RF left-context overlap equals one
    full-clip score_fn pass; directory input and --json work."""
    import json
    import dataclasses
    import jax.numpy as jnp
    from wavenet_tpu.audio import mulaw
    from wavenet_tpu.audio.io import write_wav, read_wav
    from wavenet_tpu.models import wavenet as wn
    from wavenet_tpu.models.api import WaveNet
    import score as score_cli

    cfg = micro_cfg()
    ds = AudioDataset.synthetic(cfg, num_clips=2)
    d = str(tmp_path / "ckpt")
    tr = Trainer(cfg, ds, checkpoint_dir=d)
    tr.run(num_steps=2, log_every=0)
    tr.save()
    tr.ckpt.wait()

    rng = np.random.default_rng(3)
    wavdir = tmp_path / "eval"
    wavdir.mkdir()
    t = np.arange(900) / cfg.sample_rate
    for i, f in enumerate((220.0, 440.0)):
        write_wav(str(wavdir / f"c{i}.wav"),
                  (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32),
                  cfg.sample_rate)

    # tiny chunk forces several overlapped passes
    agg = score_cli.main(["--ckpt", d, str(wavdir), "--chunk", "150"])

    m = WaveNet.from_checkpoint(d)
    bits, n = [], []
    for i in range(2):
        w, _ = read_wav(str(wavdir / f"c{i}.wav"), cfg.sample_rate)
        toks = jnp.asarray(mulaw.encode_np(
            w, cfg.quantization_channels))[None]
        bits.append(float(wn.score_fn(m.params, cfg, toks)[0]))
        n.append(toks.shape[1] - 1)
    expect = float(np.average(bits, weights=n))
    assert abs(agg - expect) < 1e-3

    out = score_cli.main(["--ckpt", d, str(wavdir / "c0.wav"), "--json"])
    assert abs(out - bits[0]) < 1e-3


def test_train_cli_eval_every(tmp_path):
    """train.py --eval-every logs eval_* metrics (stderr + JSONL), with
    --eval-data pointing at a held-out directory, alongside --sample-every
    (gcd-chunked loop)."""
    import json as json_mod
    from wavenet_tpu.audio.io import write_wav
    import train as train_cli

    hold = tmp_path / "hold"
    hold.mkdir()
    t = np.arange(2000) / 16000.0
    write_wav(str(hold / "h.wav"),
              (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), 16000)
    mfile = str(tmp_path / "m.jsonl")
    metrics = train_cli.main([
        "--preset", "tiny", "--synthetic", "--steps", "4", "--log-every",
        "0", "--eval-every", "2", "--eval-data", str(hold),
        "--metrics-file", mfile, "--override", "train_window=512"])
    assert "eval_loss" in metrics and np.isfinite(metrics["eval_loss"])
    rows = [json_mod.loads(l) for l in open(mfile)]
    eval_steps = [r["step"] for r in rows if "eval_loss" in r]
    assert eval_steps == [2, 4]


def test_grad_accum_equals_large_batch():
    """grad_accum=k over k microbatches must produce the SAME parameters as
    one step on the concatenated k*batch_size batch (optax.MultiSteps
    averages the microbatch grads; adam then sees one identical update),
    and EMA must advance only on APPLIED optimizer steps."""
    import jax.numpy as jnp
    from wavenet_tpu.models import wavenet as wn
    from wavenet_tpu.training.trainer import (TrainState, make_optimizer,
                                              make_train_step)

    toks = jax.random.randint(jax.random.PRNGKey(3), (4, 257), 0, 256)

    def init_state(cfg):
        tx = make_optimizer(cfg)
        p = wn.init_params(cfg, jax.random.PRNGKey(0))
        ema = p if cfg.ema_decay is not None else None
        return tx, TrainState(p, tx.init(p), jnp.zeros((), jnp.int32), ema)

    # accumulate 2 microbatches of 2 rows
    cfg_a = micro_cfg(batch_size=2, grad_accum=2, ema_decay=0.5)
    tx_a, st_a = init_state(cfg_a)
    step_a = jax.jit(make_train_step(cfg_a, tx_a))
    mid, _ = step_a(st_a, {"tokens": toks[:2]})
    # microstep 1 accumulates only: params and ema untouched
    for a, b in zip(jax.tree.leaves(mid.params), jax.tree.leaves(st_a.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(mid.ema), jax.tree.leaves(st_a.ema)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fin_a, _ = step_a(mid, {"tokens": toks[2:]})

    # one step on the concatenated batch
    cfg_b = micro_cfg(batch_size=4, grad_accum=1, ema_decay=0.5)
    tx_b, st_b = init_state(cfg_b)
    step_b = jax.jit(make_train_step(cfg_b, tx_b))
    fin_b, _ = step_b(st_b, {"tokens": toks})

    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_flatten_with_path(fin_a.params)[0],
            jax.tree_util.tree_flatten_with_path(fin_b.params)[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6, err_msg=str(ka))
    # EMA advanced exactly once on the apply step (same value both sides)
    for a, b in zip(jax.tree.leaves(fin_a.ema), jax.tree.leaves(fin_b.ema)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6)


def test_async_save_is_durable_for_fresh_manager(tmp_path):
    """The durability contract (round-4 verdict #2): even an ASYNC save
    (wait=False, the in-loop checkpoint_every path) must be observable by a
    brand-new CheckpointManager's restore()/latest_step() in this process —
    checkpoint._wait_directory settles in-flight saves before reads, so no
    public path can see a half-written/absent checkpoint it just queued."""
    cfg = micro_cfg()
    ds = AudioDataset.synthetic(cfg, num_clips=1, clip_seconds=0.1)
    tr = Trainer(cfg, ds, checkpoint_dir=str(tmp_path / "ck"))
    tr.run(num_steps=3, log_every=0)
    tr.save(wait=False)                  # queue async, do NOT wait
    tr2 = Trainer(cfg, ds, checkpoint_dir=str(tmp_path / "ck"))
    assert tr2.ckpt.latest_step() == 3   # waits for tr's in-flight save
    tr2.restore()
    for a, b in zip(jax.tree.leaves(tr.state.params),
                    jax.tree.leaves(tr2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_save_survives_manager_gc(tmp_path):
    """Round-5 review: a caller may drop its last reference to the manager
    while the async save is still in flight — the per-directory strong
    registry (checkpoint._PENDING) must keep the save observable to a
    fresh manager's restore."""
    import gc
    cfg = micro_cfg()
    ds = AudioDataset.synthetic(cfg, num_clips=1, clip_seconds=0.1)

    def run_and_drop():
        tr = Trainer(cfg, ds, checkpoint_dir=str(tmp_path / "ck"))
        tr.run(num_steps=2, log_every=0)
        tr.save(wait=False)
        return jax.tree.map(np.asarray, tr.state.params)

    params = run_and_drop()
    gc.collect()                         # the manager itself may be gone
    tr2 = Trainer(cfg, ds, checkpoint_dir=str(tmp_path / "ck"))
    tr2.restore()                        # must see the GC'd manager's save
    for a, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(tr2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_grad_accum_trainer_end_to_end(tmp_path):
    """Full Trainer path with grad_accum: runs, checkpoints, resumes exactly
    (the MultiSteps accumulator is part of the sharded opt state).  The
    tr.save() at step 5 is the DURABLE default — tr2's restore through a
    fresh manager must see it with no manual wait (round-4 verdict #2)."""
    cfg = micro_cfg(grad_accum=2)
    ds = AudioDataset.synthetic(cfg, num_clips=1, clip_seconds=0.1)
    tr = Trainer(cfg, ds, checkpoint_dir=str(tmp_path / "ck"))
    tr.run(num_steps=5, log_every=0)
    tr.save()
    m5 = {k: np.asarray(v) for k, v in
          jax.device_get(jax.tree.map(np.asarray, tr.state.params)).items()}
    tr.run(num_steps=4, log_every=0)

    tr2 = Trainer(cfg, ds, checkpoint_dir=str(tmp_path / "ck"))
    tr2.restore()
    for k, v in jax.device_get(
            jax.tree.map(np.asarray, tr2.state.params)).items():
        np.testing.assert_array_equal(np.asarray(v), m5[k], err_msg=k)
    tr2.run(num_steps=4, log_every=0)
    for a, b in zip(jax.tree.leaves(tr.state.params),
                    jax.tree.leaves(tr2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
