"""Global conditioning (paper arXiv:1609.03499 §2.5 eq.2) tests.

A per-utterance class id (e.g. speaker) is embedded and projected into every
layer's gate as a time-constant offset.  Covered here:

  * model semantics: the offset actually changes the distribution and equals
    a hand-computed oracle application;
  * the XLA stack against a recipe oracle, with gradient reaching
    g_embed / v_global;
  * the GPU decode kernel (interpret mode) against the scan decoder;
  * decode equivalence: teacher-forced fast-queue decode logits == full
    forward logits with the same speaker ids;
  * data-parallel path: sharded loss/grads == single-device (CPU mesh);
  * trainer end-to-end smoke with the dataset emitting speaker ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn


def cfg_(**kw):
    base = dict(num_blocks=2, max_dilation=8, residual_channels=16,
                skip_channels=16, compute_dtype="bfloat16",
                global_classes=4, global_channels=8)
    base.update(kw)
    return WaveNetConfig(**base)


def test_speaker_changes_logits_and_matches_manual_offset():
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0, 256)
    s0 = jnp.zeros((2,), jnp.int32)
    s1 = jnp.ones((2,), jnp.int32)
    l0 = wn.forward_logits(p, cfg, toks, speaker=s0)
    l1 = wn.forward_logits(p, cfg, toks, speaker=s1)
    assert not np.allclose(np.asarray(l0), np.asarray(l1))

    # offsets are einsum(g_embed[s], v_global): verify the helper directly
    g = wn.global_cond_offsets(p, cfg, s1)
    L, R = cfg.num_layers, cfg.residual_channels
    want = np.einsum(
        "bg,lgwr->lbwr",
        np.asarray(p["g_embed"], np.float32)[np.asarray(s1)].astype(np.float32),
        np.asarray(p["v_global"], np.float32))
    # bf16 operands in the helper vs f32 oracle: band at bf16 ulp levels
    np.testing.assert_allclose(np.asarray(g), want, rtol=2e-2, atol=1e-3)
    assert g.shape == (L, 2, 2, R)


def test_missing_speaker_raises():
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jnp.zeros((1, 64), jnp.int32)
    with pytest.raises(ValueError, match="speaker"):
        wn.forward_logits(p, cfg, toks)
    with pytest.raises(ValueError, match="speaker"):
        wn.generate(p, cfg, jax.random.PRNGKey(0), 8)


def oracle_skip_gc(params, cfg, x, g):
    """Pure-jnp layer recipe (f32 carry, bf16 matmul inputs) with the
    per-layer global gate offset g [L, B, 2, R] added."""
    L, R = cfg.num_layers, cfg.residual_channels
    bf = jnp.bfloat16
    x = x.astype(jnp.float32)
    skip = jnp.zeros(x.shape[:-1] + (cfg.skip_channels,), jnp.float32)
    for l in range(L):
        d = cfg.dilations[l]
        xb = x.astype(bf)
        xp = jnp.pad(xb, ((0, 0), (d, 0), (0, 0)))[:, :x.shape[1]]
        z = (jnp.dot(xb, params["w_cur"][l].reshape(R, 2 * R).astype(bf),
                     preferred_element_type=jnp.float32)
             + jnp.dot(xp, params["w_prev"][l].reshape(R, 2 * R).astype(bf),
                       preferred_element_type=jnp.float32)
             + params["b"][l].reshape(2 * R).astype(jnp.float32))
        z = z + g[l].reshape(-1, 1, 2 * R)       # [B, 1, 2R] over time
        h = (jnp.tanh(z[..., :R]) * jax.nn.sigmoid(z[..., R:])).astype(bf)
        skip = (skip + jnp.dot(h, params["w_skip"][l].astype(bf),
                               preferred_element_type=jnp.float32)
                + params["b_skip"][l].astype(jnp.float32))
        x = x + (jnp.dot(h, params["w_res"][l].astype(bf),
                         preferred_element_type=jnp.float32)
                 + params["b_res"][l].astype(jnp.float32))
    return skip


def test_scan_matches_oracle_with_speaker():
    """The XLA stack with global conditioning against the recipe oracle:
    logits through the shared head agree within the bf16 band, and the
    g_embed/v_global leaves receive gradient."""
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0, 256)
    sp = jnp.asarray([1, 3], jnp.int32)
    prev = jnp.pad(toks[:, :-1], ((0, 0), (1, 0)))
    x = wn.embed_tokens(p, cfg, toks, prev)
    g = wn.global_cond_offsets(p, cfg, sp)
    want = wn.head_logits(p, cfg, oracle_skip_gc(p, cfg, x, g))
    got = wn.forward_logits(p, cfg, toks, speaker=sp)
    scale = float(jnp.abs(want).max())
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=0.02)
    grads = jax.grad(lambda p: wn.loss_fn(
        p, cfg, jnp.pad(toks, ((0, 0), (0, 1))), speaker=sp)[0])(p)
    assert np.abs(np.asarray(grads["g_embed"])).max() > 0
    assert np.abs(np.asarray(grads["v_global"])).max() > 0


def test_decode_matches_forward():
    """Teacher-forced fast-queue decode == full-sequence forward, with
    per-row speaker ids (same gate the training path uses)."""
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, T = 2, 40
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, T), 0, 256)
    sp = jnp.asarray([0, 2], jnp.int32)
    full = wn.forward_logits(p, cfg, toks, speaker=sp)     # [B, T, Q]

    gcond = wn.global_cond_offsets(p, cfg, sp)
    state = wn.decode_init(cfg, B)

    def step(state, tok):
        state, logits = wn.decode_step(p, cfg, state, tok, gcond=gcond)
        return state, logits

    _, dec = jax.lax.scan(step, state, jnp.moveaxis(toks, 0, 1))
    dec = jnp.moveaxis(dec, 0, 1)                          # [B, T, Q]
    np.testing.assert_allclose(np.asarray(dec), np.asarray(full),
                               atol=2e-2, rtol=1e-2)


def test_generate_with_speaker_runs():
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    sp = jnp.asarray([0, 3], jnp.int32)
    toks = wn.generate(p, cfg, jax.random.PRNGKey(1), num_samples=16,
                       batch=2, speaker=sp)
    assert toks.shape == (2, 16)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256


def test_dataparallel_matches_single_device():
    from jax.sharding import NamedSharding, PartitionSpec as P
    from wavenet_tpu.parallel.mesh import DATA_AXIS, make_mesh
    cfg = cfg_(data_parallel=4, batch_size=8)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 65), 0, 256)
    sp = jnp.arange(8, dtype=jnp.int32) % cfg.global_classes

    ref_l, ref_g = jax.value_and_grad(
        lambda p: wn.loss_fn(p, cfg, toks, speaker=sp)[0])(p)
    rows = NamedSharding(mesh, P(DATA_AXIS))
    dp_l, dp_g = jax.jit(jax.value_and_grad(
        lambda p, t, s: wn.loss_fn(p, cfg, t, speaker=s)[0]))(
            p, jax.device_put(toks, NamedSharding(mesh, P(DATA_AXIS, None))),
            jax.device_put(sp, rows))
    np.testing.assert_allclose(float(dp_l), float(ref_l), rtol=1e-5)
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_flatten_with_path(ref_g)[0],
            jax.tree_util.tree_flatten_with_path(dp_g)[0]):
        # sharded partial sums reassociate the reduction: bf16-noise band
        np.testing.assert_allclose(np.asarray(b, np.float32),
                                   np.asarray(a, np.float32),
                                   atol=3e-5, rtol=2e-2, err_msg=str(ka))


def test_trainer_end_to_end_with_speakers():
    from wavenet_tpu.audio.dataset import AudioDataset
    from wavenet_tpu.training.trainer import Trainer
    cfg = cfg_(batch_size=4, train_window=64, sample_rate=4000,
               learning_rate=2e-3)
    ds = AudioDataset.synthetic(cfg, num_clips=4, clip_seconds=0.25)
    assert ds.speakers is not None
    batch, _ = ds.sample_batch(
        __import__("wavenet_tpu.audio.dataset",
                   fromlist=["IteratorState"]).IteratorState(0, 0))
    assert batch["speaker"].shape == (4,)
    tr = Trainer(cfg, ds)
    m = tr.run(3, log_every=0)
    assert np.isfinite(m["loss"])


def test_pallas_decode_with_speaker_matches_xla_interpret():
    """Whole-loop GPU decode kernel (interpret mode) with the per-layer
    speaker gate offset must greedy-match the XLA scan decoder
    step-for-step."""
    from wavenet_tpu.ops.pallas import decode_gpu
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 2, 40
    sp = jnp.asarray([1, 3], jnp.int32)
    token0 = jnp.full((B,), 128, jnp.int32)
    gcond = wn.global_cond_offsets(p, cfg, sp)

    st = wn.decode_init(cfg, B)

    def body(carry, _):
        st, tok = carry
        st, logits = wn.decode_step(p, cfg, st, tok, gcond=gcond)
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return (st, nxt), nxt

    (_, _), ref = jax.lax.scan(body, (st, token0), None, length=N)
    ref = jnp.moveaxis(ref, 0, 1)

    got = decode_gpu.generate(p, cfg, jax.random.PRNGKey(0), N, batch=B,
                              prime_tokens=token0[:, None], speaker=sp,
                              temperature=0.0, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # and without the offset the greedy tokens must differ
    got0 = decode_gpu.generate(
        p, cfg.replace(global_classes=None), jax.random.PRNGKey(0), N,
        batch=B, prime_tokens=token0[:, None], temperature=0.0,
        interpret=True)
    assert not np.array_equal(np.asarray(got), np.asarray(got0))


def test_mel_plus_speaker_compose():
    """Local (mel) and global (speaker) conditioning in the SAME model:
    the loss is finite and the teacher-forced decode matches the forward."""
    from wavenet_tpu.config import MelConfig
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 65), 0, 256)
    mel = jax.random.normal(jax.random.PRNGKey(2), (2, 5, 8))
    sp = jnp.asarray([1, 3], jnp.int32)

    ref = wn.loss_fn(p, cfg, toks, mel=mel, speaker=sp)[0]
    assert np.isfinite(float(ref))

    # teacher-forced decode with BOTH conditionings == full forward
    from wavenet_tpu.models.conditioning import upsample_mel
    T = 32
    toks32 = toks[:, :T]
    y = upsample_mel(p["upsampler"], cfg.mel, mel, T)
    cond = jnp.einsum("btm,lmgr->btlgr", y, p["v_cond"],
                      preferred_element_type=jnp.float32)
    full = wn.forward_logits(p, cfg, toks32, mel=mel, speaker=sp)
    gcond = wn.global_cond_offsets(p, cfg, sp)
    state = wn.decode_init(cfg, 2)

    def step(state, tc):
        tok, c = tc
        state, logits = wn.decode_step(p, cfg, state, tok, cond_t=c,
                                       gcond=gcond)
        return state, logits

    _, dec = jax.lax.scan(step, state,
                          (jnp.moveaxis(toks32, 0, 1),
                           jnp.moveaxis(cond, 0, 1)))
    dec = jnp.moveaxis(dec, 0, 1)
    np.testing.assert_allclose(np.asarray(dec), np.asarray(full),
                               atol=2e-2, rtol=1e-2)


def test_megatron_tp_with_speaker_matches_single_device():
    """GSPMD Megatron channel sharding (P2) with global conditioning:
    v_global column-shards with w_cur, so the sharded loss/grads must equal
    single-device — including the g_embed / v_global leaves."""
    from wavenet_tpu.parallel import sharding as shd
    from wavenet_tpu.parallel.mesh import make_mesh
    cfg = cfg_(compute_dtype="float32", data_parallel=2, model_parallel=4,
               num_blocks=1, batch_size=8, train_window=128)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 128), 0, 256)
    sp = jnp.arange(8, dtype=jnp.int32) % cfg.global_classes

    def lg(p, t, s):
        return jax.value_and_grad(
            lambda p: wn.loss_fn(p, cfg, t, speaker=s)[0])(p)

    ref_loss, ref_g = lg(p, toks, sp)
    pshard = shd.param_shardings(cfg, mesh)
    bshard = shd.batch_shardings(mesh, with_mel=False, with_speaker=True)
    p_s = jax.device_put(p, pshard)
    t_s = jax.device_put(toks, bshard["tokens"])
    s_s = jax.device_put(sp, bshard["speaker"])
    loss, g = jax.jit(lg, in_shardings=(pshard, bshard["tokens"],
                                        bshard["speaker"]))(p_s, t_s, s_s)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-6)
    for (ka, a), (kb, b) in zip(
            jax.tree.flatten_with_path(ref_g)[0],
            jax.tree.flatten_with_path(g)[0]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=5e-5, rtol=1e-4, err_msg=str(ka))


def test_distributed_decode_with_speaker_matches_single_device():
    """P3 + global conditioning: the Megatron column-sharded v_global slice
    yields shard-local gate offsets — sharded tokens must equal the
    single-device run, and the speaker id must actually matter."""
    from wavenet_tpu.parallel import distdecode as dd
    from wavenet_tpu.parallel.mesh import make_mesh
    cfg = cfg_(compute_dtype="float32", data_parallel=2, model_parallel=2,
               num_blocks=1, batch_size=4, train_window=128)
    base = cfg.replace(data_parallel=1, model_parallel=1, seq_parallel=1)
    mesh = make_mesh(cfg)
    mesh1 = make_mesh(base, devices=jax.devices()[:1])
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    sp = jnp.asarray([0, 1, 2, 3], jnp.int32)
    ref = dd.generate_sharded(p, base, mesh1, 7, 40, batch=4, speaker=sp)
    got = dd.generate_sharded(p, cfg, mesh, 7, 40, batch=4, speaker=sp)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # "speaker must matter": at random init the offsets shift logits by only
    # ~0.09 — against Gumbel noise that flips nothing in 120 draws ~10% of
    # the time (a flaky assertion).  Boost v_global so the conditioning
    # dominates and the check is deterministic.
    pb = dict(p)
    pb["v_global"] = p["v_global"] * 50.0
    loud = dd.generate_sharded(pb, base, mesh1, 7, 40, batch=4, speaker=sp)
    other = dd.generate_sharded(pb, base, mesh1, 7, 40, batch=4,
                                speaker=jnp.zeros((4,), jnp.int32))
    assert np.array_equal(np.asarray(loud[0]), np.asarray(other[0]))  # row 0
    assert not np.array_equal(np.asarray(loud[1:]), np.asarray(other[1:]))


def test_pallas_decode_awkward_totals_interpret():
    """Primed generation whose total step count is prime: the kernel has no
    time-block divisibility rule, and the tokens of a shorter request are a
    prefix of the longer one's (AR causality)."""
    from wavenet_tpu.ops.pallas import decode_gpu
    cfg = cfg_(global_classes=None)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    prime = jax.random.randint(jax.random.PRNGKey(1), (1, 14), 0, 256)
    # total = 13 + 54 = 67 (prime)
    toks = decode_gpu.generate(p, cfg, jax.random.PRNGKey(2), 54, batch=1,
                               prime_tokens=prime, temperature=0.0,
                               interpret=True)
    assert toks.shape == (1, 54)
    ref = decode_gpu.generate(p, cfg, jax.random.PRNGKey(2), 51, batch=1,
                              prime_tokens=prime, temperature=0.0,
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(toks[:, :51]), np.asarray(ref))


def test_from_dir_speaker_subdirs(tmp_path):
    """Multi-speaker corpus layout root/<speaker>/*.wav: both loaders must
    assign subdirectory-index speaker ids and emit identical batches."""
    from wavenet_tpu.audio.dataset import AudioDataset, IteratorState
    from wavenet_tpu.audio.io import write_wav
    from wavenet_tpu.audio.streaming import StreamingAudioDataset
    cfg = cfg_(batch_size=4, train_window=64, sample_rate=4000,
               global_classes=3)
    rng = np.random.default_rng(0)
    for si, spk in enumerate(["alice", "bob", "carol"]):
        (tmp_path / spk).mkdir()
        for c in range(2):
            x = rng.uniform(-0.4, 0.4, size=800).astype(np.float32)
            write_wav(str(tmp_path / spk / f"c{c}.wav"), x, 4000)
    mem = AudioDataset.from_dir(str(tmp_path), cfg)
    stream = StreamingAudioDataset.from_dir(str(tmp_path), cfg)
    assert sorted(set(map(int, mem.speakers))) == [0, 1, 2]
    st = IteratorState(seed=5, step=0)
    for _ in range(3):
        bm, st2 = mem.sample_batch(st)
        bs, _ = stream.sample_batch(st)
        np.testing.assert_array_equal(bm["tokens"], bs["tokens"])
        np.testing.assert_array_equal(bm["speaker"], bs["speaker"])
        st = st2

    # too many subdirectories for the configured class count must raise
    with pytest.raises(ValueError, match="global_classes"):
        AudioDataset.from_dir(str(tmp_path),
                              cfg.replace(global_classes=2))


def test_seqpar_with_speaker_matches_unsharded():
    from wavenet_tpu.parallel import seqpar
    from wavenet_tpu.parallel.mesh import make_mesh
    cfg = cfg_(seq_parallel=2, data_parallel=2, batch_size=4)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 65), 0, 256)
    sp = jnp.asarray([0, 1, 2, 3], jnp.int32)
    ref = wn.loss_fn(p, cfg, toks, speaker=sp)[0]
    with mesh:
        got = jax.jit(lambda p: seqpar.loss_fn_sp(
            p, cfg, mesh, toks[:, :-1], toks[:, 1:], speaker=sp)[0])(p)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-4, atol=1e-4)


def test_trainer_all_features_on_mesh():
    """Integration: Trainer on a (2,2,1) mesh with mel AND speaker
    conditioning AND EMA — the full feature surface in one step function."""
    from wavenet_tpu.audio.dataset import AudioDataset
    from wavenet_tpu.config import MelConfig
    from wavenet_tpu.training.trainer import Trainer
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=2000.0, upsample_factors=(4, 4))
    cfg = cfg_(batch_size=4, train_window=128, sample_rate=4000,
               compute_dtype="float32", mel=mel_cfg,
               data_parallel=2, seq_parallel=2, ema_decay=0.99)
    ds = AudioDataset.synthetic(cfg, num_clips=4, clip_seconds=0.25)
    tr = Trainer(cfg, ds)
    m = tr.run(2, log_every=0)
    assert np.isfinite(m["loss"])
    ev = tr.evaluate(num_batches=2)
    assert np.isfinite(ev["eval_loss"])
    assert tr.state.ema is not None
