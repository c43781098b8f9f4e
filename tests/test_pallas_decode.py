"""Whole-loop GPU decode kernel (ops/pallas/decode_gpu.py) vs the XLA scan
decoder, run in the Pallas interpreter on the CPU.  On the CPU the two
agree bit for bit, so these tests compare tokens exactly; on the card the
comparison is within a tolerance (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.ops import rng
from wavenet_tpu.ops.pallas import decode_gpu


def cfg_(**kw):
    base = dict(num_blocks=2, max_dilation=8, residual_channels=16,
                skip_channels=16, compute_dtype="bfloat16")
    base.update(kw)
    return WaveNetConfig(**base)


def xla_greedy_rollout(params, cfg, token0, n):
    """Greedy closed-loop decode with the XLA scan path."""
    B = token0.shape[0]
    st = wn.decode_init(cfg, B)

    def body(carry, _):
        st, tok = carry
        st, logits = wn.decode_step(params, cfg, st, tok)
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return (st, nxt), nxt

    (_, _), toks = jax.lax.scan(body, (st, token0), None, length=n)
    return jnp.moveaxis(toks, 0, 1)            # [B, n]


def _chunk(params, cfg, state, token, n, temperature=0.0, seeds=0, **kw):
    seeds = rng.as_row_seeds(seeds, token.shape[0])
    return decode_gpu.decode_chunk(params, cfg, state, token, seeds, n,
                                   temperature, interpret=True, **kw)


def test_greedy_equivalence_interpret():
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 2, 40
    token0 = jnp.full((B,), 128, jnp.int32)

    ref = np.asarray(xla_greedy_rollout(params, cfg, token0, N))
    state, nxt, toks = _chunk(params, cfg, wn.decode_init(cfg, B), token0, N)
    np.testing.assert_array_equal(np.asarray(toks), ref)
    np.testing.assert_array_equal(np.asarray(nxt), ref[:, -1])
    assert int(state.t) == N


def test_chunked_continuation_interpret():
    """Two chunks of N/2 must equal one chunk of N (state carries)."""
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 2, 32
    tok = jnp.full((B,), 128, jnp.int32)
    st0 = wn.decode_init(cfg, B)
    _, _, one = _chunk(params, cfg, st0, tok, N, 1.0, seeds=5)
    st, nxt, a = _chunk(params, cfg, st0, tok, N // 2, 1.0, seeds=5)
    _, _, b = _chunk(params, cfg, st, nxt, N // 2, 1.0, seeds=5)
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate([a, b], axis=1)), np.asarray(one))


def test_sampled_tokens_in_range_interpret():
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = decode_gpu.generate(params, cfg, jax.random.PRNGKey(3),
                               num_samples=24, batch=2, interpret=True)
    t = np.asarray(toks)
    assert t.shape == (2, 24)
    assert (t >= 0).all() and (t < 256).all()
    # sampling at temperature 1 should not be constant
    assert len(np.unique(t)) > 1


@pytest.mark.parametrize("batch,padded", [(1, 16), (8, 16), (16, 16),
                                          (17, 32), (64, 64)])
def test_row_padding_to_tile(batch, padded):
    """Rows pad to whole 16-row tiles (Triton's dot minimum); the pad rows
    never reach the caller."""
    assert decode_gpu.padded_rows(batch) == padded
    assert padded % decode_gpu.BT == 0


@pytest.mark.parametrize("mels,padded", [(8, 16), (16, 16), (20, 32),
                                         (80, 128), (128, 128)])
def test_mel_padding_to_pow2(mels, padded):
    """Mel channels pad to a power of two (Triton block shapes): 80 -> 128."""
    assert decode_gpu.padded_mels(mels) == padded


def test_priming_matches_xla():
    """Teacher-forced priming in the kernel == XLA prime + greedy rollout."""
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, P, N = 2, 17, 23
    prime = jax.random.randint(jax.random.PRNGKey(9), (B, P), 0, 256)

    # XLA reference: teacher-force prime[:-1], then greedy from prime[-1]
    st = wn.decode_init(cfg, B)
    def feed(st, tok):
        st, _ = wn.decode_step(params, cfg, st, tok)
        return st, None
    st, _ = jax.lax.scan(feed, st, jnp.moveaxis(prime[:, :-1], 1, 0))
    def roll(carry, _):
        st, tok = carry
        st, logits = wn.decode_step(params, cfg, st, tok)
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return (st, nxt), nxt
    (_, _), ref = jax.lax.scan(roll, (st, prime[:, -1]), None, length=N)
    ref = np.asarray(jnp.moveaxis(ref, 0, 1))

    got = decode_gpu.generate(params, cfg, jax.random.PRNGKey(0),
                              num_samples=N, batch=B, prime_tokens=prime,
                              temperature=0.0, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_batch_tiled_equals_single_tile_interpret():
    """A batch spanning several 16-row tiles (with pad rows in the last)
    greedy-decodes exactly like the scan: tiles share weights and carry
    independent rings."""
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 20, 24
    token0 = jax.random.randint(jax.random.PRNGKey(4), (B,), 0, 256)
    ref = np.asarray(xla_greedy_rollout(params, cfg, token0, N))
    assert decode_gpu.padded_rows(B) // decode_gpu.BT == 2
    _, nxt, toks = _chunk(params, cfg, wn.decode_init(cfg, B), token0, N)
    np.testing.assert_array_equal(np.asarray(toks), ref)
    np.testing.assert_array_equal(np.asarray(nxt), ref[:, -1])


def test_batch_tiled_sampling_matches_untiled_interpret():
    """Sampled rows do not depend on the batch around them: the counter RNG
    is keyed by each row's own seed, so rows of a two-tile batch equal the
    same rows decoded alone."""
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 18, 24
    seeds = rng.derive_row_seeds(jnp.int32(11), B)
    key = jax.random.PRNGKey(11)
    whole = decode_gpu.generate(params, cfg, key, N, batch=B, seeds=seeds,
                                temperature=1.0, interpret=True)
    part = decode_gpu.generate(params, cfg, key, N, batch=3,
                               seeds=seeds[15:], temperature=1.0,
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(whole[15:]), np.asarray(part))


def _mel_cfg():
    from wavenet_tpu.config import MelConfig
    return MelConfig(num_mels=8, hop_length=16, win_length=64,
                     fmax=4000.0, upsample_factors=(4, 4))


def _bf16_cond(params, y):
    # the kernel's recipe: bf16 features and v_cond, f32 accumulation
    return jnp.einsum("btm,lmgr->btlgr", y.astype(jnp.bfloat16),
                      params["v_cond"].astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)


def test_conditional_decode_matches_xla_interpret():
    """In-kernel mel conditioning == the XLA scan decoder with cond_t."""
    from wavenet_tpu.models.conditioning import upsample_mel
    cfg = cfg_(mel=_mel_cfg())
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 2, 32
    mel = jax.random.normal(jax.random.PRNGKey(2), (B, 4, 8))
    y = upsample_mel(params["upsampler"], cfg.mel, mel, N)      # [B, N, M]
    cond = _bf16_cond(params, y)
    st = wn.decode_init(cfg, B)
    tok = jnp.full((B,), 128, jnp.int32)
    outs = []
    for t in range(N):
        st, logits = wn.decode_step(params, cfg, st, tok, cond_t=cond[:, t])
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        outs.append(tok)
    ref = np.asarray(jnp.stack(outs, axis=1))

    _, _, toks = _chunk(params, cfg, wn.decode_init(cfg, B),
                        jnp.full((B,), 128, jnp.int32), N, y=y)
    np.testing.assert_array_equal(np.asarray(toks), ref)


def test_conditional_generate_pallas_with_priming_interpret():
    from wavenet_tpu.models.conditioning import upsample_mel
    cfg = cfg_(mel=_mel_cfg())
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, P, N = 2, 9, 16
    prime = jax.random.randint(jax.random.PRNGKey(9), (B, P), 0, 256)
    total = P - 1 + N
    mel = jax.random.normal(jax.random.PRNGKey(2), (B, 4, 8))
    y = upsample_mel(params["upsampler"], cfg.mel, mel, total)
    cond = _bf16_cond(params, y)

    # XLA reference: teacher-force prime WITH cond, then greedy with cond
    st = wn.decode_init(cfg, B)
    for t in range(P - 1):
        st, _ = wn.decode_step(params, cfg, st, prime[:, t],
                               cond_t=cond[:, t])
    tok = prime[:, -1]
    outs = []
    for i in range(N):
        st, logits = wn.decode_step(params, cfg, st, tok, cond_t=cond[:, st.t])
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        outs.append(tok)
    ref = np.asarray(jnp.stack(outs, axis=1))

    got = decode_gpu.generate(params, cfg, jax.random.PRNGKey(0),
                              num_samples=N, batch=B, prime_tokens=prime,
                              y=y, temperature=0.0, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_priming_chunked_interpret():
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, P, N = 2, 9, 16
    prime = jax.random.randint(jax.random.PRNGKey(9), (B, P), 0, 256)
    one = decode_gpu.generate(params, cfg, jax.random.PRNGKey(0),
                              num_samples=N, batch=B, prime_tokens=prime,
                              temperature=0.0, interpret=True)
    many = list(decode_gpu.stream(params, cfg, jax.random.PRNGKey(0), N, 5,
                                  batch=B, prime_tokens=prime,
                                  temperature=0.0, interpret=True))
    assert [c.shape[1] for c in many] == [5, 5, 5, 1]
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate(many, axis=1)), np.asarray(one))


def test_generate_stream_matches_one_shot_interpret():
    """Streaming chunks must concatenate to EXACTLY the one-shot tokens —
    sampled, primed, and speaker-conditioned (RNG keyed by global step)."""
    from wavenet_tpu.generate.sampler import generate_stream
    cfg = cfg_(global_classes=3, global_channels=8)
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 2, 48
    key = jax.random.PRNGKey(7)
    sp = jnp.asarray([0, 2], jnp.int32)
    prime = jax.random.randint(jax.random.PRNGKey(8), (B, 11), 0, 256)

    one = decode_gpu.generate(params, cfg, key, N, batch=B,
                              prime_tokens=prime, speaker=sp,
                              temperature=1.0, interpret=True)
    chunks = list(generate_stream(params, cfg, key, N, chunk_samples=16,
                                  batch=B, prime_tokens=prime, speaker=sp,
                                  temperature=1.0, interpret=True))
    assert len(chunks) > 1
    got = jnp.concatenate(chunks, axis=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(one))


def test_non_pow2_chunk_hint_lowers():
    """Chunk and step counts need no alignment: a 37-step chunk over 100
    steps streams [37, 37, 26] and equals the one-shot decode."""
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    one = decode_gpu.generate(params, cfg, jax.random.PRNGKey(1), 100,
                              batch=1, temperature=0.0, interpret=True)
    chunks = list(decode_gpu.stream(params, cfg, jax.random.PRNGKey(1), 100,
                                    37, batch=1, temperature=0.0,
                                    interpret=True))
    assert [c.shape[1] for c in chunks] == [37, 37, 26]
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate(chunks, axis=1)), np.asarray(one))


def test_long_prime_stays_in_kernel():
    """The prime streams from device memory, so a long prime has no size
    limit; only its last token's successors are emitted."""
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    prime = jax.random.randint(jax.random.PRNGKey(2), (1, 300), 0, 256)
    got = decode_gpu.generate(params, cfg, jax.random.PRNGKey(1), 8, batch=1,
                              prime_tokens=prime, temperature=0.0,
                              interpret=True)
    ref = wn.generate(params, cfg, jax.random.PRNGKey(1), 8, batch=1,
                      prime_tokens=prime, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_generate_stream_with_mel_matches_one_shot_interpret():
    """Streaming slices the upsampled mel per chunk; the chunks must
    concatenate to the one-shot conditional tokens."""
    from wavenet_tpu.generate.sampler import generate_stream
    from wavenet_tpu.models.conditioning import upsample_mel
    cfg = cfg_(mel=_mel_cfg())
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 2, 48
    key = jax.random.PRNGKey(9)
    mel = jax.random.normal(jax.random.PRNGKey(10), (B, 4, 8))
    y = upsample_mel(params["upsampler"], cfg.mel, mel, N)

    one = decode_gpu.generate(params, cfg, key, N, batch=B, y=y,
                              temperature=1.0, interpret=True)
    chunks = list(generate_stream(params, cfg, key, N, chunk_samples=16,
                                  batch=B, y=y, temperature=1.0,
                                  interpret=True))
    assert len(chunks) > 1
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate(chunks, axis=1)), np.asarray(one))


def test_generate_stream_xla_fallback():
    """The scan route streams too (chunked decode_step scans), emitting
    exactly what the one-shot XLA generate() would."""
    from wavenet_tpu.generate import sampler
    cfg = cfg_(global_classes=3, global_channels=8)
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 2, 40
    key = jax.random.PRNGKey(9)
    sp = jnp.asarray([1, 2], jnp.int32)
    prime = jax.random.randint(jax.random.PRNGKey(4), (B, 7), 0, 256)

    chunks = list(sampler.generate_stream(params, cfg, key, N,
                                          chunk_samples=16, batch=B,
                                          prime_tokens=prime, speaker=sp))
    assert len(chunks) == 3 and sum(c.shape[1] for c in chunks) == N
    got = jnp.concatenate(chunks, axis=1)
    one = wn.generate(params, cfg, key, N, batch=B, prime_tokens=prime,
                      speaker=sp)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(one))


def test_generate_stream_xla_fallback_mel():
    """Mel-conditioned scan-route streaming: y features are projected per
    chunk and consumed via the state's step counter."""
    from wavenet_tpu.generate import sampler
    from wavenet_tpu.models.conditioning import project_cond
    cfg = cfg_(mel=_mel_cfg())
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 2, 32
    key = jax.random.PRNGKey(5)
    y = jax.random.normal(jax.random.PRNGKey(6), (B, N, cfg.mel.num_mels))

    chunks = list(sampler.generate_stream(params, cfg, key, N,
                                          chunk_samples=10, batch=B, y=y))
    got = jnp.concatenate(chunks, axis=1)
    one = wn.generate(params, cfg, key, N, batch=B,
                      cond=project_cond(params, y))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(one))


def test_supported_fuzz():
    """supported() over random configs: exactly the width-2, bf16,
    power-of-two-width configs without an embed projection."""
    r = np.random.RandomState(11)
    for _ in range(60):
        R = int(2 ** r.randint(2, 9))
        S = int(2 ** r.randint(2, 9))
        K = int(r.choice([2, 2, 3]))
        dt = str(r.choice(["bfloat16", "float32"]))
        causal = None if r.rand() < 0.8 else R * 2
        cfg = WaveNetConfig(num_blocks=1, max_dilation=8,
                            residual_channels=R, skip_channels=S,
                            kernel_size=K, compute_dtype=dt,
                            causal_channels=causal)
        want = (K == 2 and dt == "bfloat16" and causal is None
                and R >= 16 and S >= 16)
        assert decode_gpu.supported(cfg) == want, cfg


def test_generate_stream_mel_plus_speaker_interpret():
    """Streaming with BOTH local (mel) and global (speaker) conditioning in
    one model: chunks concatenate to exactly the one-shot kernel tokens."""
    from wavenet_tpu.generate.sampler import generate_stream
    from wavenet_tpu.models.conditioning import upsample_mel
    cfg = cfg_(mel=_mel_cfg(), global_classes=3, global_channels=8)
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N = 2, 48
    key = jax.random.PRNGKey(7)
    sp = jnp.asarray([0, 2], jnp.int32)
    mel = jax.random.normal(jax.random.PRNGKey(2), (B, 4, 8))
    y = upsample_mel(params["upsampler"], cfg.mel, mel, N)

    one = decode_gpu.generate(params, cfg, key, N, batch=B, y=y,
                              speaker=sp, interpret=True)
    chunks = list(generate_stream(params, cfg, key, N, chunk_samples=16,
                                  batch=B, y=y, speaker=sp, interpret=True))
    got = jnp.concatenate(chunks, axis=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(one))


def test_greedy_long_matches_scan():
    """1024 greedy steps equal to the XLA scan on the CPU: the embedding
    is a row gather from the float32 tables, summed and rounded once like
    embed_tokens, so x matches the scan's bit for bit and greedy holds at
    length, not just at short horizons."""
    cfg = WaveNetConfig(num_blocks=1, max_dilation=32, residual_channels=64,
                        skip_channels=64, compute_dtype="bfloat16")
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    B, N = 4, 1024
    tk = decode_gpu.generate(params, cfg, key, N, batch=B, temperature=0.0,
                             interpret=True)
    ts = wn.generate(params, cfg, key, N, batch=B, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(tk), np.asarray(ts))


def test_embed_proj_configs_route_to_scan():
    """causal_channels != R creates w_embed_proj, which the kernel does not
    implement; such configs route to the scan, which serves them."""
    from wavenet_tpu import route
    from wavenet_tpu.generate.sampler import generate_auto

    cfg = cfg_(causal_channels=32)
    assert cfg.embed_channels != cfg.residual_channels
    assert not decode_gpu.supported(cfg)
    assert route.decode(cfg, platform="gpu") == route.SCAN
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    assert "w_embed_proj" in params
    with pytest.raises(ValueError, match="not supported"):
        decode_gpu.generate(params, cfg, jax.random.PRNGKey(1), 8,
                            interpret=True)
    toks = generate_auto(params, cfg, jax.random.PRNGKey(1), 16, batch=2,
                         interpret=True)
    ref = wn.generate(params, cfg, jax.random.PRNGKey(1), 16, batch=2)
    assert jnp.array_equal(toks, ref)
