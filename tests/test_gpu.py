"""Tests that need an NVIDIA GPU (marker `gpu`; they skip elsewhere).  On the
card, in one process:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist
"""

import jax
import jax.numpy as jnp
import pytest

from wavenet_tpu import route
from wavenet_tpu.config import MelConfig, WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.ops.pallas import decode_gpu

pytestmark = pytest.mark.gpu


def cfg_(**kw):
    base = dict(num_blocks=2, max_dilation=64, residual_channels=128,
                skip_channels=256)
    base.update(kw)
    return WaveNetConfig(**base)


def test_router_takes_kernel_on_gpu():
    assert route.decode(cfg_()) == route.KERNEL


@pytest.mark.parametrize("kw,batch", [({}, 8), ({}, 40),
                                      ({"global_classes": 3}, 8)])
def test_compiled_kernel_matches_scan(kw, batch):
    cfg = cfg_(**kw)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    speaker = (jnp.arange(batch, dtype=jnp.int32) % 3
               if cfg.global_classes else None)
    r = decode_gpu.compare_with_scan(p, cfg, batch, 512, speaker=speaker)
    assert r["ok"], r


def test_compiled_kernel_with_mel_matches_scan():
    cfg = cfg_(mel=MelConfig())
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    y = jax.random.normal(jax.random.PRNGKey(1), (8, 512, 80))
    r = decode_gpu.compare_with_scan(p, cfg, 8, 512, y=y)
    assert r["ok"], r


def test_compiled_chunks_continue_exactly():
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    B = 8
    st0 = wn.decode_init(cfg, B)
    tok = jnp.full((B,), 128, jnp.int32)
    seeds = jnp.arange(B, dtype=jnp.int32)
    _, _, one = decode_gpu.decode_chunk(p, cfg, st0, tok, seeds, 256, 1.0)
    st, nxt, a = decode_gpu.decode_chunk(p, cfg, st0, tok, seeds, 128, 1.0)
    _, _, b = decode_gpu.decode_chunk(p, cfg, st, nxt, seeds, 128, 1.0)
    assert bool((jnp.concatenate([a, b], 1) == one).all())


def test_train_loss_matches_f32_reference_on_gpu():
    cfg = cfg_(batch_size=2, train_window=1024)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 1025), 0, 256)
    got = float(jax.jit(lambda p, t: wn.loss_fn(p, cfg, t)[0])(p, toks))
    want = float(jax.jit(
        lambda p, t: wn.reference_loss_fn(p, cfg, t)[0])(p, toks))
    assert abs(got - want) <= 1e-3 * abs(want)   # chip_smoke.LOSS_RTOL
