"""Data parallelism by GSPMD: the plain XLA loss jitted over a batch
sharded on the `data` axis equals the single-device loss and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.parallel.mesh import DATA_AXIS, make_mesh


def cfg_(**kw):
    base = dict(num_blocks=2, max_dilation=8, residual_channels=16,
                skip_channels=16, compute_dtype="bfloat16",
                data_parallel=4, batch_size=8, train_window=64)
    base.update(kw)
    return WaveNetConfig(**base)


def _sharded_tokens(mesh, toks):
    return jax.device_put(toks, NamedSharding(mesh, P(DATA_AXIS, None)))


def test_dp_scan_loss_matches():
    cfg = cfg_()
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 65), 0, 256)
    ref, _ = wn.loss_fn(p, cfg, toks)
    got, aux = jax.jit(lambda p, t: wn.loss_fn(p, cfg, t))(
        p, _sharded_tokens(mesh, toks))
    np.testing.assert_allclose(float(got), float(ref), rtol=2e-5)
    assert set(aux) == {"loss", "bits_per_sample", "accuracy"}


def test_dp_grads_match():
    cfg = cfg_()
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 65), 0, 256)
    ref_l, ref_g = jax.value_and_grad(lambda p: wn.loss_fn(p, cfg, toks)[0])(p)
    dp_l, dp_g = jax.jit(jax.value_and_grad(
        lambda p, t: wn.loss_fn(p, cfg, t)[0]))(p, _sharded_tokens(mesh, toks))
    np.testing.assert_allclose(float(dp_l), float(ref_l), rtol=2e-5)
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_flatten_with_path(ref_g)[0],
            jax.tree_util.tree_flatten_with_path(dp_g)[0]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=5e-5, rtol=1e-4, err_msg=str(ka))


def test_grad_accum_composes_with_mesh_trainer():
    """grad_accum under a real (data, model) mesh Trainer: the MultiSteps
    accumulator must shard like the params (Trainer._opt_state_shardings
    suffix-matches through the MultiSteps pytree), and two microsteps on a
    dp=2/mp=2 mesh must equal one step of a single-device Trainer on the
    concatenated batch.  Explicit batches go through _step on both sides
    so the microbatches concat to exactly the big batch."""
    from wavenet_tpu.training.trainer import Trainer
    from wavenet_tpu.audio.dataset import AudioDataset

    cfg_a = cfg_(data_parallel=2, model_parallel=2, batch_size=4,
                 grad_accum=2, compute_dtype="float32")
    ds_a = AudioDataset.synthetic(cfg_a, num_clips=2, clip_seconds=0.05)
    tr_a = Trainer(cfg_a, ds_a)
    toks = jax.random.randint(jax.random.PRNGKey(9), (8, 65), 0, 256)
    with tr_a.mesh:
        st, _ = tr_a._step(tr_a.state, {"tokens": toks[:4]})
        st, _ = tr_a._step(st, {"tokens": toks[4:]})

    cfg_b = cfg_a.replace(data_parallel=1, model_parallel=1, batch_size=8,
                          grad_accum=1)
    tr_b = Trainer(cfg_b, AudioDataset.synthetic(cfg_b, num_clips=2,
                                                 clip_seconds=0.05))
    with tr_b.mesh:
        st_b, _ = tr_b._step(tr_b.state, {"tokens": toks})

    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_flatten_with_path(st.params)[0],
            jax.tree_util.tree_flatten_with_path(st_b.params)[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6, err_msg=str(ka))
