"""The timed bf16 XLA loss against its float32 reference at `highest`
matmul precision (models/wavenet.reference_loss_fn).

Tolerances, and why: the timed path rounds activations and matmul inputs
to bf16 (8 significant bits), so the loss, a mean over many positions,
agrees to about 1e-5 relative, while gradients at initialisation, small
and sums of many rounded terms, agree to about 10% in global L2 norm.  A
wrong term (a dropped conditioning input, a misplaced tap, a sign)
moves either far past these bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from wavenet_tpu.config import MelConfig, WaveNetConfig
from wavenet_tpu.models import wavenet as wn

LOSS_RTOL = 1e-3
GRAD_REL_L2 = 0.2
GRAD_COSINE = 0.98

VARIANTS = {
    "plain": {},
    "mel": dict(mel=MelConfig(num_mels=8, hop_length=16, win_length=64,
                              upsample_factors=(4, 4))),
    "speaker": dict(global_classes=3),
    "k3": dict(kernel_size=3),
    "remat": dict(remat=True),
}


def _setup(name):
    cfg = WaveNetConfig(num_blocks=2, max_dilation=8, residual_channels=32,
                        skip_channels=32, **VARIANTS[name])
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 129), 0, 256)
    kw = {}
    if cfg.mel is not None:
        kw["mel"] = jax.random.normal(jax.random.PRNGKey(2), (2, 9, 8))
    if cfg.global_classes is not None:
        kw["speaker"] = jnp.asarray([0, 2], jnp.int32)
    return cfg, p, toks, kw


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_loss_matches_f32_reference(name):
    cfg, p, toks, kw = _setup(name)
    got, aux = wn.loss_fn(p, cfg, toks, **kw)
    want, _ = wn.reference_loss_fn(p, cfg, toks, **kw)
    assert cfg.compute_dtype == "bfloat16"
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert set(aux) == {"loss", "bits_per_sample", "accuracy"}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_grads_match_f32_reference(name):
    cfg, p, toks, kw = _setup(name)
    g = jax.grad(lambda p: wn.loss_fn(p, cfg, toks, **kw)[0])(p)
    r = jax.grad(lambda p: wn.reference_loss_fn(p, cfg, toks, **kw)[0])(p)
    diff = jax.tree.map(lambda a, b: a - b, g, r)
    rel = float(optax.global_norm(diff) / optax.global_norm(r))
    dot = sum(float(jnp.vdot(a, b)) for a, b in
              zip(jax.tree.leaves(g), jax.tree.leaves(r)))
    cos = dot / float(optax.global_norm(g) * optax.global_norm(r))
    assert rel < GRAD_REL_L2, rel
    assert cos > GRAD_COSINE, cos
