"""The GPU decode kernel at the `full` presets' channel widths (R = 128,
S up to 256) vs the XLA scan.

One kernel now covers both channel regimes.  The contract on these wide
configs: token trajectories equal to models.wavenet.generate in greedy,
counter-RNG-sampled, primed, chunked, tiled, and conditioned modes.  All
tests run the kernel in the Pallas interpreter on the CPU, where kernel and
scan agree bit for bit; chip_smoke.py compares them on the card within a
stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavenet_tpu.config import WaveNetConfig, conditional, fastgen_bench, full
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.ops import rng
from wavenet_tpu.ops.pallas import decode_gpu


def cfg_(**kw):
    base = dict(num_blocks=1, max_dilation=8, residual_channels=128,
                skip_channels=256, compute_dtype="bfloat16")
    base.update(kw)
    return WaveNetConfig(**base)


@pytest.fixture(scope="module")
def setup():
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def test_supported_and_plans():
    from wavenet_tpu.config import full_vocoder
    # one kernel serves the wide presets and the narrow ones
    for preset in (full, full_vocoder, fastgen_bench, conditional):
        assert decode_gpu.supported(preset())
    # B=8 pads to one 16-row tile; the mel channels pad 80 -> 128
    assert decode_gpu.padded_rows(8) == 16
    assert decode_gpu.padded_rows(64) // decode_gpu.BT == 4
    assert decode_gpu.padded_mels(full_vocoder().mel.num_mels) == 128
    # the skip width splits into 128-wide weight blocks
    assert decode_gpu._parts(256) == [(0, 128), (128, 128)]
    assert decode_gpu._parts(64) == [(0, 64)]


def test_greedy_long_matches_scan(setup):
    """512 greedy steps equal to the scan — long on purpose: an embedding
    off by one bf16 ulp on some (token, prev) pairs flips greedy argmax at
    near-ties within ~50 steps."""
    cfg, params = setup
    key = jax.random.PRNGKey(1)
    B, N = 4, 512
    tk = decode_gpu.generate(params, cfg, key, N, batch=B, temperature=0.0,
                             interpret=True)
    ts = wn.generate(params, cfg, key, N, batch=B, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(tk), np.asarray(ts))


def test_sampled_matches_scan_counter_rng(setup):
    cfg, params = setup
    key = jax.random.PRNGKey(1)
    B, N = 4, 256
    seeds = rng.derive_row_seeds(jnp.int32(7), B)
    tk = decode_gpu.generate(params, cfg, key, N, batch=B, temperature=1.0,
                             interpret=True, seeds=seeds)
    ts = wn.generate(params, cfg, key, N, batch=B, temperature=1.0,
                     seeds=seeds)
    t = np.asarray(tk)
    np.testing.assert_array_equal(t, np.asarray(ts))
    assert len(np.unique(t)) > 8                 # actually sampling


def test_primed_matches_scan(setup):
    cfg, params = setup
    key = jax.random.PRNGKey(1)
    B, P, N = 2, 13, 96
    prime = jax.random.randint(jax.random.PRNGKey(3), (B, P), 0, 256)
    tk = decode_gpu.generate(params, cfg, key, N, batch=B, temperature=0.0,
                             prime_tokens=prime, interpret=True)
    ts = wn.generate(params, cfg, key, N, batch=B, temperature=0.0,
                     prime_tokens=prime)
    np.testing.assert_array_equal(np.asarray(tk), np.asarray(ts))


def test_chunked_continuation_bit_identical(setup):
    """Two decode_chunk calls with the carried state and token == one call
    (the streaming contract: the counter RNG keys by GLOBAL step), and a
    kernel chunk may hand its state to the scan and back."""
    cfg, params = setup
    B, N = 2, 128
    seeds = rng.derive_row_seeds(jnp.int32(11), B)
    tok = jnp.full((B,), 128, jnp.int32)
    st0 = wn.decode_init(cfg, B)
    _, _, one = decode_gpu.decode_chunk(params, cfg, st0, tok, seeds, N, 1.0,
                                        interpret=True)
    st, nxt, a = decode_gpu.decode_chunk(params, cfg, st0, tok, seeds, 64,
                                         1.0, interpret=True)
    _, _, b = decode_gpu.decode_chunk(params, cfg, st, nxt, seeds, 64, 1.0,
                                      interpret=True)
    np.testing.assert_array_equal(
        np.asarray(one), np.asarray(jnp.concatenate([a, b], axis=1)))
    _, _, b_scan = wn.decode_sample_chunk(params, cfg, st, nxt, None, 64, 64,
                                          temperature=1.0, seeds=seeds)
    np.testing.assert_array_equal(np.asarray(b_scan), np.asarray(b))


def test_batch_tiles_match_untiled(setup):
    cfg, params = setup
    key = jax.random.PRNGKey(2)
    B, N = 20, 64
    seeds = rng.derive_row_seeds(jnp.int32(5), B)
    whole = decode_gpu.generate(params, cfg, key, N, batch=B,
                                temperature=1.0, interpret=True, seeds=seeds)
    alone = decode_gpu.generate(params, cfg, key, N, batch=4,
                                temperature=1.0, interpret=True,
                                seeds=seeds[16:])
    np.testing.assert_array_equal(np.asarray(whole[16:]), np.asarray(alone))


def test_global_conditioning_matches_scan():
    cfg = cfg_(global_classes=4)
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    B, N = 4, 96
    speaker = jnp.asarray([0, 1, 2, 3], jnp.int32)
    seeds = rng.derive_row_seeds(jnp.int32(9), B)
    tk = decode_gpu.generate(params, cfg, key, N, batch=B, temperature=1.0,
                             speaker=speaker, interpret=True, seeds=seeds)
    ts = wn.generate(params, cfg, key, N, batch=B, temperature=1.0,
                     speaker=speaker, seeds=seeds)
    np.testing.assert_array_equal(np.asarray(tk), np.asarray(ts))
    # speakers actually condition: rows must differ
    t = np.asarray(tk)
    assert not np.array_equal(t[0], t[1])


def test_stream_wide_matches_one_shot(setup):
    """generate_stream runs wide configs through the kernel and the
    concatenated chunks equal the one-shot decode."""
    from wavenet_tpu.generate.sampler import generate_stream
    cfg, params = setup
    key = jax.random.PRNGKey(4)
    B, N = 2, 200
    seeds = rng.derive_row_seeds(jnp.int32(3), B)
    one = decode_gpu.generate(params, cfg, key, N, batch=B,
                              temperature=1.0, interpret=True, seeds=seeds)
    chunks = list(generate_stream(params, cfg, key, N, chunk_samples=48,
                                  batch=B, temperature=1.0, interpret=True,
                                  seeds=seeds))
    got = np.concatenate([np.asarray(c) for c in chunks], axis=1)
    assert got.shape == (B, N)
    np.testing.assert_array_equal(got, np.asarray(one))


def test_generate_auto_routes_wide(setup, monkeypatch):
    """On a GPU, generate_auto sends the wide configs to the kernel without
    being asked for interpret mode, and the kernel gets interpret=False."""
    from wavenet_tpu import route
    import wavenet_tpu.generate.sampler as sampler
    cfg, params = setup
    monkeypatch.setattr(route, "current_platform", lambda: "gpu")
    called = {}

    def fake(p, c, key, n, **kw):
        called.update(kw)
        return jnp.zeros((kw.get("batch", 1), n), jnp.int32)

    monkeypatch.setattr(decode_gpu, "generate", fake)
    out = sampler.generate_auto(params, cfg, jax.random.PRNGKey(0), 16,
                                batch=2)
    assert called and called["interpret"] is False and out.shape == (2, 16)


def _mel_cfg():
    from wavenet_tpu.config import MelConfig
    return MelConfig(num_mels=8, hop_length=16, win_length=64,
                     fmax=4000.0, upsample_factors=(4, 4))


def _mel_setup(key_p=0, key_m=2, B=2, total=32, **cfg_kw):
    from wavenet_tpu.models.conditioning import upsample_mel
    cfg = cfg_(mel=_mel_cfg(), **cfg_kw)
    params = wn.init_params(cfg, jax.random.PRNGKey(key_p))
    mel = jax.random.normal(jax.random.PRNGKey(key_m), (B, -(-total // 16), 8))
    y = upsample_mel(params["upsampler"], cfg.mel, mel, total)   # [B, T, M]
    # per-step gate contributions in the kernel's recipe: bf16 inputs, f32
    # accumulation
    cond = jnp.einsum("btm,lmgr->btlgr", y.astype(jnp.bfloat16),
                      params["v_cond"].astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    return cfg, params, y, cond


def test_mel_greedy_matches_xla_interpret():
    """In-kernel streamed-mel conditioning == the XLA scan decoder with
    per-step cond_t."""
    B, N = 2, 32
    cfg, params, y, cond = _mel_setup(B=B, total=N)
    st = wn.decode_init(cfg, B)
    tok = jnp.full((B,), 128, jnp.int32)
    outs = []
    for t in range(N):
        st, logits = wn.decode_step(params, cfg, st, tok, cond_t=cond[:, t])
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        outs.append(tok)
    ref = np.asarray(jnp.stack(outs, axis=1))

    got = decode_gpu.generate(params, cfg, jax.random.PRNGKey(0), N,
                              batch=B, y=y, temperature=0.0, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_mel_primed_sampled_matches_scan():
    """Teacher-forced prime + counter-RNG sampling with mel, kernel vs
    wn.generate on the same bf16-projected cond timeline."""
    B, P, N = 2, 9, 48
    total = P - 1 + N
    cfg, params, y, cond = _mel_setup(B=B, total=total)
    prime = jax.random.randint(jax.random.PRNGKey(9), (B, P), 0, 256)
    seeds = rng.derive_row_seeds(jnp.int32(21), B)
    tk = decode_gpu.generate(params, cfg, jax.random.PRNGKey(1), N, batch=B,
                             prime_tokens=prime, y=y, temperature=1.0,
                             interpret=True, seeds=seeds)
    ts = wn.generate(params, cfg, jax.random.PRNGKey(1), N, batch=B,
                     prime_tokens=prime, cond=cond, temperature=1.0,
                     seeds=seeds)
    t = np.asarray(tk)
    np.testing.assert_array_equal(t, np.asarray(ts))
    assert len(np.unique(t)) > 8                 # actually sampling


def test_mel_chunked_continuation_bit_identical():
    """Two decode_chunk calls with per-chunk y slices == one call (the
    streaming contract with mel)."""
    B, N = 2, 128
    cfg, params, y, _ = _mel_setup(B=B, total=N)
    seeds = rng.derive_row_seeds(jnp.int32(11), B)
    tok = jnp.full((B,), 128, jnp.int32)
    st0 = wn.decode_init(cfg, B)
    _, _, one = decode_gpu.decode_chunk(params, cfg, st0, tok, seeds, N, 1.0,
                                        y=y, interpret=True)
    st, nxt, a = decode_gpu.decode_chunk(params, cfg, st0, tok, seeds, 64,
                                         1.0, y=y[:, :64], interpret=True)
    _, _, b = decode_gpu.decode_chunk(params, cfg, st, nxt, seeds, 64, 1.0,
                                      y=y[:, 64:], interpret=True)
    np.testing.assert_array_equal(
        np.asarray(one), np.asarray(jnp.concatenate([a, b], axis=1)))


def test_mel_plus_speaker_matches_scan():
    """Local (streamed mel) AND global (speaker) conditioning in the same
    launch — covers the kernel's has_cond+has_gc operand ordering."""
    B, N = 3, 48
    cfg, params, y, cond = _mel_setup(B=B, total=N, global_classes=3,
                                      global_channels=8)
    speaker = jnp.asarray([0, 1, 2], jnp.int32)
    seeds = rng.derive_row_seeds(jnp.int32(17), B)
    tk = decode_gpu.generate(params, cfg, jax.random.PRNGKey(1), N, batch=B,
                             y=y, speaker=speaker, temperature=1.0,
                             interpret=True, seeds=seeds)
    ts = wn.generate(params, cfg, jax.random.PRNGKey(1), N, batch=B,
                     cond=cond, speaker=speaker, temperature=1.0,
                     seeds=seeds)
    np.testing.assert_array_equal(np.asarray(tk), np.asarray(ts))


def test_stream_wide_mel_matches_one_shot():
    """generate_stream slices the upsampled mel per kernel chunk; the
    chunks concatenate to the one-shot conditioned decode."""
    from wavenet_tpu.generate.sampler import generate_stream
    B, N = 2, 160
    cfg, params, y, _ = _mel_setup(B=B, total=N)
    seeds = rng.derive_row_seeds(jnp.int32(3), B)
    one = decode_gpu.generate(params, cfg, jax.random.PRNGKey(4), N,
                              batch=B, y=y, temperature=1.0,
                              interpret=True, seeds=seeds)
    chunks = list(generate_stream(params, cfg, jax.random.PRNGKey(4), N,
                                  chunk_samples=48, batch=B, y=y,
                                  temperature=1.0, interpret=True,
                                  seeds=seeds))
    got = np.concatenate([np.asarray(c) for c in chunks], axis=1)
    assert got.shape == (B, N)
    np.testing.assert_array_equal(got, np.asarray(one))


def _dp_mesh(n):
    from jax.sharding import Mesh
    from wavenet_tpu.parallel import distdecode
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1),
                (distdecode.DATA_AXIS, distdecode.MODEL_AXIS))


def test_wide_dp_fanout_mel_matches_single_chip():
    """The dp fan-out serves wide+mel models: y shards with the batch and
    tokens equal the single-device kernel."""
    from wavenet_tpu.parallel import distdecode
    B, N = 4, 48
    cfg, params, y, _ = _mel_setup(B=B, total=N)
    dp_toks = distdecode.generate_pallas_dp(
        params, cfg, _dp_mesh(2), seed=5, num_samples=N, batch=B, y=y,
        interpret=True)
    one = decode_gpu.generate(params, cfg, None, N, batch=B, y=y,
                              interpret=True, seeds=rng.as_row_seeds(5, B))
    np.testing.assert_array_equal(np.asarray(dp_toks), np.asarray(one))


def test_wide_dp_fanout_matches_single_chip():
    """generate_pallas_dp runs the kernel per data shard; tokens equal the
    single-device kernel over the full batch (per-row counter RNG keyed by
    GLOBAL row index), one-shot AND streamed."""
    from wavenet_tpu.parallel import distdecode
    cfg = cfg_(global_classes=4)
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    mesh = _dp_mesh(4)
    B, N = 8, 64
    speaker = jnp.arange(B, dtype=jnp.int32) % 4
    dp_toks = distdecode.generate_pallas_dp(
        params, cfg, mesh, seed=3, num_samples=N, batch=B,
        speaker=speaker, interpret=True)
    chunks = list(distdecode.generate_pallas_dp_stream(
        params, cfg, mesh, seed=3, num_samples=N, batch=B,
        chunk_samples=32, speaker=speaker, interpret=True))
    one = decode_gpu.generate(params, cfg, None, N, batch=B,
                              speaker=speaker, interpret=True,
                              seeds=rng.as_row_seeds(3, B))
    np.testing.assert_array_equal(np.asarray(dp_toks), np.asarray(one))
    got = np.concatenate([np.asarray(c) for c in chunks], axis=1)
    np.testing.assert_array_equal(got, np.asarray(one))
