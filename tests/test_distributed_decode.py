"""Distributed AR generation (P3, parallel/distdecode.py): sharded decode
over the (data, model) mesh must sample the SAME tokens as a single-device
run — the counter-based sampling noise is keyed by global coordinates, so
any mesh layout is token-equivalent.  BASELINE north_star: "generation
exchanges cached conv states and sampled tokens via collectives"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.parallel import distdecode as dd
from wavenet_tpu.parallel.mesh import make_mesh


def cfg_(**kw):
    base = dict(num_blocks=1, max_dilation=8, residual_channels=16,
                skip_channels=16, compute_dtype="float32",
                batch_size=4, train_window=128)
    base.update(kw)
    return WaveNetConfig(**base)


def single_run(cfg, p, seed, n, batch, **kw):
    mesh1 = make_mesh(cfg_(), devices=jax.devices()[:1])
    return dd.generate_sharded(p, cfg_base_strip(cfg), mesh1, seed, n,
                               batch, **kw)


def cfg_base_strip(cfg):
    return cfg.replace(data_parallel=1, model_parallel=1, seq_parallel=1)


@pytest.mark.parametrize("dp,mp", [(4, 1), (1, 4), (2, 2), (2, 4)])
def test_sharded_tokens_match_single_device(dp, mp):
    cfg = cfg_(data_parallel=dp, model_parallel=mp)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    ref = single_run(cfg, p, seed=7, n=40, batch=4)
    got = dd.generate_sharded(p, cfg, mesh, 7, 40, batch=4)
    assert got.shape == (4, 40)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("dp,mp", [(1, 4), (2, 2)])
def test_model_sharded_rings_match(dp, mp):
    """shard_rings_model: conv caches shard channels over `model` and every
    read reconstitutes them via all_gather — tokens must be unchanged."""
    cfg = cfg_(data_parallel=dp, model_parallel=mp)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    ref = single_run(cfg, p, seed=3, n=32, batch=4)
    got = dd.generate_sharded(p, cfg, mesh, 3, 32, batch=4,
                              shard_rings_model=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_priming_matches_single_device():
    cfg = cfg_(data_parallel=2, model_parallel=2)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    prime = jax.random.randint(jax.random.PRNGKey(2), (4, 12), 0, 256)
    ref = single_run(cfg, p, seed=5, n=24, batch=4, prime_tokens=prime)
    got = dd.generate_sharded(p, cfg, mesh, 5, 24, batch=4,
                              prime_tokens=prime)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_greedy_matches_canonical_decoder():
    """temperature=0 sharded decode == a manual argmax loop over the
    canonical wn.decode_step — ties the sharded math to the reference
    fast decoder, not just to itself."""
    cfg = cfg_(data_parallel=2, model_parallel=2)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 4, 24
    got = dd.generate_sharded(p, cfg, mesh, 0, N, batch=B, temperature=0.0)

    st = wn.decode_init(cfg, B)
    tok = jnp.full((B,), cfg.quantization_channels // 2, jnp.int32)
    outs = []
    for _ in range(N):
        st, logits = wn.decode_step(p, cfg, st, tok)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        outs.append(tok)
    want = jnp.stack(outs, axis=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pallas_dp_matches_single_chip_kernel():
    """generate_pallas_dp (interpret): the data-parallel kernel fan-out is
    token-identical to ONE single-chip kernel run over the full batch —
    the per-row counter RNG (ops/rng.py) makes the fan-out layout-free."""
    cfg = cfg_(compute_dtype="bfloat16")
    cfg = cfg.replace(data_parallel=4)
    mesh = make_mesh(cfg)
    from wavenet_tpu.ops.pallas import decode_gpu
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 8, 16
    got = dd.generate_pallas_dp(p, cfg, mesh, 9, N, batch=B,
                                interpret=True)
    assert got.shape == (B, N)
    want = decode_gpu.generate(p, cfg, None, N, batch=B, interpret=True,
                               seeds=9)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # and each shard equals a standalone kernel run over its seed slice
    from wavenet_tpu.ops import rng
    seeds = rng.as_row_seeds(9, B)
    per = B // 4
    shard0 = decode_gpu.generate(p, cfg, None, N, batch=per,
                                 interpret=True, seeds=seeds[:per])
    np.testing.assert_array_equal(np.asarray(got[:per]), np.asarray(shard0))


def test_sampled_tokens_unified_across_all_decoders():
    """ONE counter RNG (ops/rng.py) drives every sampled decoder: at the
    same per-row seeds, the whole-loop decode kernel (interpreter), its
    data-parallel fan-out, the XLA scan's counter-sampling mode, and the
    collective decoder over (4,1) and (2,2) meshes all emit IDENTICAL
    tokens on the CPU, where kernel and scan logits agree bit for bit."""
    from wavenet_tpu.ops.pallas import decode_gpu
    B, N, seed = 4, 40, 123
    base = cfg_(compute_dtype="bfloat16")
    p = wn.init_params(base, jax.random.PRNGKey(0))

    from wavenet_tpu.ops import rng
    kernel = decode_gpu.generate(p, base, None, N, batch=B, interpret=True,
                                 seeds=seed, temperature=1.0)
    scan = wn.generate(p, base, None, N, batch=B, temperature=1.0,
                       seeds=rng.as_row_seeds(seed, B))
    np.testing.assert_array_equal(np.asarray(kernel), np.asarray(scan),
                                  err_msg="kernel vs XLA scan")
    toks = np.asarray(kernel)
    assert len(np.unique(toks)) > 4, "sampling looks degenerate"

    for dp, mp in [(4, 1), (2, 2)]:
        cfg = base.replace(data_parallel=dp, model_parallel=mp)
        mesh = make_mesh(cfg)
        coll = dd.generate_sharded(p, cfg, mesh, seed, N, batch=B,
                                   temperature=1.0)
        np.testing.assert_array_equal(
            np.asarray(coll), toks, err_msg=f"collective ({dp},{mp})")

    mesh_dp = make_mesh(base.replace(data_parallel=4))
    dp_fan = dd.generate_pallas_dp(p, base.replace(data_parallel=4),
                                   mesh_dp, seed, N, batch=B,
                                   temperature=1.0, interpret=True)
    np.testing.assert_array_equal(np.asarray(dp_fan), toks,
                                  err_msg="kernel dp fan-out")


@pytest.mark.parametrize("dp,mp", [(4, 1), (2, 2)])
def test_conditional_sharded_matches_single_device(dp, mp):
    """Mel-conditioned distributed decode: each shard projects its step's
    features with the LOCAL v_cond column slice (aligned with the local z
    columns); tokens must equal the single-device run."""
    from wavenet_tpu.config import MelConfig
    from wavenet_tpu.models.conditioning import upsample_mel
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(data_parallel=dp, model_parallel=mp, mel=mel_cfg)
    base = cfg_base_strip(cfg)
    mesh = make_mesh(cfg)
    mesh1 = make_mesh(base, devices=jax.devices()[:1])
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    n, P = 32, 9
    mel = jax.random.normal(jax.random.PRNGKey(2), (4, 4, 8))
    y = upsample_mel(p["upsampler"], mel_cfg, mel, P - 1 + n)
    prime = jax.random.randint(jax.random.PRNGKey(3), (4, P), 0, 256)

    ref = dd.generate_sharded(p, base, mesh1, 5, n, batch=4,
                              prime_tokens=prime, y=y)
    got = dd.generate_sharded(p, cfg, mesh, 5, n, batch=4,
                              prime_tokens=prime, y=y)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # and the conditioning must actually matter
    bare = dd.generate_sharded(p, base, mesh1, 5, n, batch=4,
                               prime_tokens=prime, y=y * 0.0)
    assert not np.array_equal(np.asarray(ref), np.asarray(bare))


@pytest.mark.parametrize("dp,mp,rings", [(2, 2, False), (1, 4, True)])
def test_mesh_streaming_matches_one_shot(dp, mp, rings):
    """generate_sharded_stream: chunked mesh decode carrying the sharded
    DecodeState between shard_map'd scans concatenates to EXACTLY the
    one-shot tokens (the counter RNG keys by the global step) — round-2
    verdict #3."""
    cfg = cfg_(data_parallel=dp, model_parallel=mp)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    prime = jax.random.randint(jax.random.PRNGKey(2), (4, 7), 0, 256)
    one = dd.generate_sharded(p, cfg, mesh, 11, 40, batch=4,
                              prime_tokens=prime, shard_rings_model=rings)
    chunks = list(dd.generate_sharded_stream(
        p, cfg, mesh, 11, 40, batch=4, chunk_samples=16,
        prime_tokens=prime, shard_rings_model=rings))
    assert [c.shape[1] for c in chunks] == [16, 16, 8]
    got = jnp.concatenate(chunks, axis=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(one))


def test_mesh_streaming_conditional_matches_one_shot():
    """Mel-conditioned mesh streaming: per-chunk local v_cond projection
    (bounded memory) still concatenates to the one-shot tokens."""
    from wavenet_tpu.config import MelConfig
    from wavenet_tpu.models.conditioning import upsample_mel
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(data_parallel=2, model_parallel=2, mel=mel_cfg)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    mel = jax.random.normal(jax.random.PRNGKey(2), (4, 4, 8))
    y = upsample_mel(p["upsampler"], mel_cfg, mel, 32)
    one = dd.generate_sharded(p, cfg, mesh, 5, 32, batch=4, y=y)
    got = jnp.concatenate(list(dd.generate_sharded_stream(
        p, cfg, mesh, 5, 32, batch=4, chunk_samples=12, y=y)), axis=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(one))


def test_pallas_dp_streaming_matches_one_shot():
    """generate_pallas_dp_stream (interpret): shard_map'd kernel chunks
    carrying the sharded decode state concatenate to the one-shot fan-out —
    AND to the collective mesh stream at the same seeds (unified RNG)."""
    cfg = cfg_(compute_dtype="bfloat16").replace(data_parallel=4)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N, seed = 4, 40, 3
    one = dd.generate_pallas_dp(p, cfg, mesh, seed, N, batch=B,
                                temperature=1.0, interpret=True)
    chunks = list(dd.generate_pallas_dp_stream(
        p, cfg, mesh, seed, N, batch=B, chunk_samples=16,
        temperature=1.0, interpret=True))
    got = jnp.concatenate(chunks, axis=1)
    assert got.shape == (B, N)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(one))
    coll = jnp.concatenate(list(dd.generate_sharded_stream(
        p, cfg, mesh, seed, N, batch=B, chunk_samples=16,
        temperature=1.0)), axis=1)
    np.testing.assert_array_equal(np.asarray(coll), np.asarray(got))


def test_counter_uniform_full_range():
    """Regression: int32 demotion in the murmur mix cleared the sign bit
    and squeezed the 'uniform' noise into (0, 0.5), truncating the Gumbel
    right tail — low-logit tokens could never win a sample."""
    from wavenet_tpu.ops import rng
    seeds = rng.derive_row_seeds(jnp.int32(7), 64)
    u = np.asarray(rng.counter_uniform(
        seeds[:, None], jnp.int32(3), jnp.int32(0), (64, 128),
        class_axis=1))
    assert u.min() > 0.0 and u.max() < 1.0
    assert u.max() > 0.5, f"noise capped at {u.max()} — sign-bit demotion?"
    assert 0.4 < u.mean() < 0.6


def test_counter_rng_keying_properties():
    """The unified keying (ops/rng.py): (1) a row's noise depends only on
    its OWN seed — not its batch position or neighbors; (2) the kernel's
    transposed [Q, Bt] layout and the scan's [B, Q] layout hash
    identically; (3) a class-sharded tile (class0 offset) equals the
    corresponding slice of the unsharded draw."""
    from wavenet_tpu.ops import rng
    t = jnp.int32(17)
    s_all = rng.as_row_seeds(np.asarray([5, 9, 5], np.int32), 3)
    u = np.asarray(rng.counter_uniform(s_all[:, None], t, 0, (3, 16),
                                       class_axis=1))
    # same seed, different rows -> same noise; different seed -> different
    np.testing.assert_array_equal(u[0], u[2])
    assert not np.array_equal(u[0], u[1])
    # transposed (kernel) layout == scan layout
    ut = np.asarray(rng.counter_uniform(s_all[None, :], t, 0, (16, 3),
                                        class_axis=0))
    np.testing.assert_array_equal(ut.T, u)
    # class-sharded tile == slice of the unsharded draw
    half = np.asarray(rng.counter_uniform(s_all[:, None], t, 8, (3, 8),
                                          class_axis=1))
    np.testing.assert_array_equal(half, u[:, 8:])


def test_facade_mesh_routing():
    """WaveNet.generate(mesh=...) routes through the distributed decoder and
    reproduces the library call exactly (layout-independent counter RNG);
    committed (checkpoint-style) params are re-placed onto the mesh."""
    from wavenet_tpu.models.api import WaveNet
    cfg = cfg_(data_parallel=2, model_parallel=2)
    m = WaveNet(cfg_base_strip(cfg)).init(jax.random.PRNGKey(0))
    mesh = make_mesh(cfg)
    got = m.generate(num_samples=40, batch=2, mesh=mesh, seed=11)
    ref = single_run(cfg, m.params, 11, 40, 2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # committed params (the from_checkpoint situation): same result
    committed = jax.device_put(m.params, jax.devices()[0])
    got2 = dd.generate_sharded(committed, cfg_base_strip(cfg), mesh, 11, 40,
                               batch=2)
    np.testing.assert_array_equal(np.asarray(got2), np.asarray(ref))


def test_generate_cli_distributed(tmp_path):
    """generate.py --data-parallel/--model-parallel produce the same audio
    as a single-device distributed run at the same seed."""
    import sys
    from unittest import mock
    from wavenet_tpu.audio.dataset import AudioDataset
    from wavenet_tpu.audio import mulaw
    from wavenet_tpu.audio.io import read_wav
    from wavenet_tpu.training.trainer import Trainer
    cfg = cfg_base_strip(cfg_())
    d = str(tmp_path / "ckpt")
    tr = Trainer(cfg, AudioDataset.synthetic(cfg, num_clips=2),
                 checkpoint_dir=d)
    tr.run(num_steps=1, log_every=0)
    tr.save()
    tr.ckpt.wait()

    import generate as gen_cli
    out = str(tmp_path / "o.wav")
    argv = ["--ckpt", d, "--seconds", "0.005", "--out", out,
            "--model-parallel", "2", "--data-parallel", "2",
            "--batch", "2", "--seed", "3"]
    toks = gen_cli.main(argv)
    n = toks.shape[1]
    from wavenet_tpu.models.api import WaveNet
    m = WaveNet.from_checkpoint(d)
    ref = single_run(cfg, m.params, 3, n, 2)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref))
    w0, _ = read_wav(str(tmp_path / "o_0.wav"), cfg.sample_rate)
    exp = np.asarray(mulaw.decode(ref, cfg.quantization_channels))[0]
    np.testing.assert_allclose(w0, exp, atol=2.0 / 32767)
