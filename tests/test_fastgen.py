"""Fast-generation equivalence tests (SURVEY.md §4 "Equivalence"): the
cached-queue decoder (arXiv:1611.09482) must reproduce the naive full-window
forward's logits step for step — this catches queue/ring-indexing bugs, the
classic fast-WaveNet failure mode."""

import jax
import jax.numpy as jnp
import numpy as np

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn


def cfg_(**kw):
    base = dict(num_blocks=2, max_dilation=8, residual_channels=8,
                skip_channels=8, compute_dtype="float32")
    base.update(kw)
    return WaveNetConfig(**base)


def _fast_logits(p, cfg, toks):
    """Step the fast decoder over a teacher-forced token sequence, collecting
    the logits after each step, inside one scan."""
    B, T = toks.shape
    st = wn.decode_init(cfg, B)

    def body(st, tok):
        st, logits = wn.decode_step(p, cfg, st, tok)
        return st, logits

    _, logits = jax.lax.scan(body, st, jnp.moveaxis(toks, 1, 0))
    return jnp.moveaxis(logits, 0, 1)            # [B, T, Q]


def test_naive_fast_equivalence():
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    T = cfg.receptive_field + 17                 # cross the full RF
    toks = jax.random.randint(jax.random.PRNGKey(1), (3, T), 0, 256)
    naive = wn.forward_logits(p, cfg, toks)
    fast = _fast_logits(p, cfg, toks)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(naive),
                               atol=1e-5, rtol=1e-5)


def test_equivalence_bf16():
    cfg = cfg_(compute_dtype="bfloat16")
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 40), 0, 256)
    naive = wn.forward_logits(p, cfg, toks)
    fast = _fast_logits(p, cfg, toks)
    # bf16: tolerance-banded (SURVEY.md §4 "Kernel" policy)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(naive),
                               atol=0.15, rtol=0.05)


def test_generate_shapes_and_determinism():
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(42)
    out1 = wn.generate(p, cfg, key, num_samples=25, batch=2)
    out2 = wn.generate(p, cfg, key, num_samples=25, batch=2)
    assert out1.shape == (2, 25)
    assert out1.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))
    assert (np.asarray(out1) >= 0).all() and (np.asarray(out1) < 256).all()


def test_generate_with_priming_matches_teacher_forcing():
    """Priming through the queues must leave the decoder in exactly the state
    the naive forward implies: the first sampled step's logits must equal the
    naive forward logits at the last priming position."""
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    P = 30
    prime = jax.random.randint(jax.random.PRNGKey(7), (2, P), 0, 256)

    naive = wn.forward_logits(p, cfg, prime)     # [2, P, Q]

    st = wn.decode_init(cfg, 2)
    def body(st, tok):
        st, logits = wn.decode_step(p, cfg, st, tok)
        return st, logits
    st, _ = jax.lax.scan(body, st, jnp.moveaxis(prime[:, :-1], 1, 0))
    _, logits_last = wn.decode_step(p, cfg, st, prime[:, -1])
    np.testing.assert_allclose(np.asarray(logits_last),
                               np.asarray(naive[:, -1]), atol=1e-5, rtol=1e-5)


def test_decode_state_pytree():
    cfg = cfg_()
    st = wn.decode_init(cfg, 4)
    leaves = jax.tree.leaves(st)
    assert len(leaves) == 3
    assert st.queues.shape == (sum(cfg.dilations), 4, cfg.residual_channels)


def test_sampler_trajectory_identical_to_fast():
    """The naive oracle driver and the cached-queue generate() must produce
    IDENTICAL free-running trajectories (greedy and sampled-with-same-key):
    the naive window's warm-up mask and RF+1-wide prev handling reproduce
    the fast path's empty-ring boundary semantics exactly, so every step's
    logits — hence every argmax and every categorical draw — coincide."""
    from wavenet_tpu.generate.sampler import generate_naive
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    N = cfg.receptive_field + 23        # cross warm-up AND window rolling

    # greedy, unprimed: keys deliberately differ (greedy must ignore them)
    fast = wn.generate(p, cfg, jax.random.PRNGKey(5), N, batch=2,
                       temperature=0.0)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(9), N, batch=2,
                           temperature=0.0)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))

    # sampled with the SAME key: identical logits => identical draws
    fast = wn.generate(p, cfg, jax.random.PRNGKey(7), 40, batch=2)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(7), 40, batch=2)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))

    # primed with P < RF (exercises the masked left-fill boundary)
    prime = jax.random.randint(jax.random.PRNGKey(2), (2, 13), 0, 256)
    fast = wn.generate(p, cfg, jax.random.PRNGKey(3), 30, batch=2,
                       prime_tokens=prime, temperature=0.0)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(4), 30, batch=2,
                           prime_tokens=prime, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))


def test_forward_logits_valid_mask_equals_short_sequence():
    """valid_mask contract: logits at valid positions are bit-identical to
    running the plain forward on just the valid suffix."""
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    T, S = 40, 17                                   # S = valid suffix length
    toks = jax.random.randint(jax.random.PRNGKey(1), (3, T), 0, 256)
    # left-fill of token 0 so the first valid position's prev embeds the
    # zero-token (the documented caller obligation)
    full = jnp.concatenate(
        [jnp.zeros((3, T - S), jnp.int32), toks[:, -S:]], axis=1)
    mask = (jnp.arange(T)[None, :] >= T - S).astype(jnp.float32)
    mask = jnp.broadcast_to(mask, (3, T))
    masked = wn.forward_logits(p, cfg, full, valid_mask=mask)[:, -S:]
    short = wn.forward_logits(p, cfg, toks[:, -S:])
    np.testing.assert_array_equal(np.asarray(masked), np.asarray(short))


def test_sampler_trajectory_identical_to_fast_mel():
    """Mel-conditioned variant of the oracle gate (round-3 verdict #5): the
    naive full-window forward with a SLIDING conditioning-feature window
    must free-run the exact trajectory of the cached-queue decoder fed the
    same upsampled features — greedy, sampled, and primed — on the
    CONDITIONAL preset's structure (reduced depth for CPU time; the real
    preset's mel geometry: 80 mels, hop 256, eq.3 gate conditioning)."""
    from wavenet_tpu.config import MelConfig
    from wavenet_tpu.generate.sampler import generate_naive
    from wavenet_tpu.models.conditioning import project_cond, upsample_mel
    cfg = cfg_(num_blocks=2, max_dilation=16,
               mel=MelConfig(num_mels=80, hop_length=256, win_length=1024,
                             upsample_factors=(4, 8, 8)))
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    B = 2
    N = cfg.receptive_field + 17        # cross warm-up AND window rolling
    P = 9
    prime = jax.random.randint(jax.random.PRNGKey(2), (B, P), 0, 256)
    total = max(P - 1, 0) + N
    frames = total // cfg.mel.hop_length + 1
    mel = jax.random.normal(jax.random.PRNGKey(6), (B, frames,
                                                    cfg.mel.num_mels))
    y = upsample_mel(p["upsampler"], cfg.mel, mel, total)      # [B, T, M]
    cond = project_cond(p, y)           # fast path's [B, T, L, 2, R] form

    # greedy unprimed (keys differ on purpose)
    fast = wn.generate(p, cfg, jax.random.PRNGKey(5), N, batch=B,
                       cond=cond[:, :N], temperature=0.0)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(9), N, batch=B,
                           y=y[:, :N], temperature=0.0)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))

    # sampled with the SAME key
    fast = wn.generate(p, cfg, jax.random.PRNGKey(7), 40, batch=B,
                       cond=cond[:, :40])
    naive = generate_naive(p, cfg, jax.random.PRNGKey(7), 40, batch=B,
                           y=y[:, :40])
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))

    # primed (P < RF: masked left-fill + conditioning through priming)
    fast = wn.generate(p, cfg, jax.random.PRNGKey(3), 30, batch=B,
                       prime_tokens=prime, cond=cond, temperature=0.0)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(4), 30, batch=B,
                           prime_tokens=prime, y=y, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))

    # and the whole-loop decode kernel (interpreter) on the same features
    from wavenet_tpu.ops.pallas import decode_gpu
    if decode_gpu.supported(cfg):
        k = decode_gpu.generate(p, cfg, jax.random.PRNGKey(11), 40,
                                batch=B, y=y[:, :40], temperature=0.0,
                                interpret=True)
        naive = generate_naive(p, cfg, jax.random.PRNGKey(12), 40, batch=B,
                               y=y[:, :40], temperature=0.0)
        np.testing.assert_array_equal(np.asarray(k), np.asarray(naive))
