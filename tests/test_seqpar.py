"""Sequence-parallel (halo exchange) tests — SURVEY.md §7.4: "halo exchange
must preserve exactness — assert sharded forward == unsharded, always"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.parallel import seqpar
from wavenet_tpu.parallel.mesh import make_mesh


def cfg_(**kw):
    base = dict(num_blocks=1, max_dilation=8, residual_channels=16,
                skip_channels=16, compute_dtype="float32",
                batch_size=2, train_window=128)
    base.update(kw)
    return WaveNetConfig(**base)


@pytest.mark.parametrize("sp,dp", [(8, 1), (4, 2), (2, 1)])
def test_sp_forward_exact(sp, dp):
    cfg = cfg_(seq_parallel=sp, data_parallel=dp)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    T = 128
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, T), 0, 256)
    ref = wn.forward_logits(p, cfg, toks)
    got = jax.jit(lambda p, t: seqpar.forward_logits_sp(p, cfg, mesh, t))(p, toks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_sp_loss_and_grads_match():
    cfg = cfg_(seq_parallel=4, data_parallel=2)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    window = jax.random.randint(jax.random.PRNGKey(1), (2, 129), 0, 256)

    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: wn.loss_fn(p, cfg, window)[0])(p)

    inputs, targets = window[:, :-1], window[:, 1:]
    # NOTE: partial-manual shard_map (axis_names subset) only works under jit
    # in jax 0.9 — the eager impl path builds an internal spec over all mesh
    # axes and trips its own validation. loss_fn_sp documents this.
    sp_loss, sp_grads = jax.jit(jax.value_and_grad(
        lambda p: seqpar.loss_fn_sp(p, cfg, mesh, inputs, targets)[0]))(p)

    np.testing.assert_allclose(float(sp_loss), float(ref_loss), rtol=2e-6)
    for (ka, a), (kb, b) in zip(
            jax.tree.flatten_with_path(ref_grads)[0],
            jax.tree.flatten_with_path(sp_grads)[0]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=5e-5, rtol=1e-4, err_msg=str(ka))


def test_sp_composes_with_model_parallel():
    """seq x model: shard_map manual over (data, seq), GSPMD over model."""
    cfg = cfg_(seq_parallel=4, model_parallel=2)
    mesh = make_mesh(cfg)
    from wavenet_tpu.parallel import sharding as shd
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    p_s = jax.device_put(p, shd.param_shardings(cfg, mesh))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 128), 0, 256)
    ref = wn.forward_logits(p, cfg, toks)
    got = jax.jit(
        lambda p, t: seqpar.forward_logits_sp(p, cfg, mesh, t))(p_s, toks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_sp_rejects_too_short_shards():
    cfg = cfg_(seq_parallel=8, max_dilation=32)
    mesh = make_mesh(cfg)
    with pytest.raises(ValueError, match="halo"):
        seqpar.check_seq_shardable(cfg, mesh, 64)   # 64/8=8 < maxd=32


def test_trainer_with_seq_parallel_matches_single_device():
    from wavenet_tpu.audio.dataset import AudioDataset
    from wavenet_tpu.training.trainer import Trainer

    cfg = cfg_(seq_parallel=4, data_parallel=2, batch_size=2,
               learning_rate=1e-3)
    ds = AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.2)
    tr_sp = Trainer(cfg, ds)
    tr_sp.run(num_steps=3, log_every=0)

    cfg1 = cfg.replace(seq_parallel=1, data_parallel=1)
    from wavenet_tpu.parallel.mesh import make_mesh as mm
    tr_one = Trainer(cfg1, ds, mesh=mm(cfg1, jax.devices()[:1]))
    tr_one.run(num_steps=3, log_every=0)

    pa = jax.device_get(tr_sp.state.params)
    pb = jax.device_get(tr_one.state.params)
    for (ka, a), (kb, b) in zip(
            jax.tree.flatten_with_path(pa)[0],
            jax.tree.flatten_with_path(pb)[0]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=str(ka))


def test_sp_forward_speaker_exact():
    """Global conditioning through the seq-parallel forward: time-constant
    offsets need no halo; logits must equal the unsharded forward."""
    cfg = cfg_(seq_parallel=4, global_classes=3, global_channels=8)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 128), 0, 256)
    spk = jnp.asarray([0, 2], jnp.int32)
    ref = wn.forward_logits(p, cfg, toks, speaker=spk)
    got = jax.jit(lambda p, t, s: seqpar.forward_logits_sp(
        p, cfg, mesh, t, speaker=s))(p, toks, spk)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="global_classes unset"):
        seqpar.forward_logits_sp(p, cfg_(seq_parallel=4), mesh, toks,
                                 speaker=spk)
