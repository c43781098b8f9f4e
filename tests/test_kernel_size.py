"""Configurable causal-conv width (SURVEY.md §2 #3: "kernel-2, width
configurable").  kernel_size K > 2 runs on the XLA scan paths — model
forward, fast ring decode, naive oracle, data-parallel training — while the
GPU decode kernel, sequence parallelism, and the distributed decoder stay
contractually width-2 and must REFUSE wider configs at routing time.

The correctness spine is the same as the K=2 suite: the cached-ring decoder
(rings of length d*(K-1), taps at d..(K-1)d) must reproduce the full-window
forward step for step, and free-run the naive oracle's exact trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavenet_tpu.config import MelConfig, WaveNetConfig
from wavenet_tpu.generate.sampler import generate_naive, generate_stream
from wavenet_tpu.models import wavenet as wn


def cfg_(K=3, **kw):
    base = dict(num_blocks=2, max_dilation=8, kernel_size=K,
                residual_channels=16, skip_channels=8,
                quantization_channels=64, compute_dtype="float32")
    base.update(kw)
    return WaveNetConfig(**base)


def test_config_validation_and_rf():
    with pytest.raises(ValueError):
        WaveNetConfig(kernel_size=1)
    # RF = (K-1)*(sum(dilations)+1) + 1: dilated taps reach (K-1)*d per
    # layer and the width-K embed conv adds (K-1) more
    c3 = cfg_(K=3)
    assert c3.receptive_field == 2 * (sum(c3.dilations) + 1) + 1
    c4 = cfg_(K=4)
    assert c4.receptive_field == 3 * (sum(c4.dilations) + 1) + 1
    # round-trip through the params-JSON path
    assert WaveNetConfig.from_json(c3.to_json()) == c3


def test_params_have_extra_taps():
    cfg = cfg_(K=4)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    L, R = cfg.num_layers, cfg.residual_channels
    assert p["w_prevk"].shape == (L, 2, R, 2, R)     # taps at 2d, 3d
    assert p["embed_prevk"].shape == (2, cfg.quantization_channels,
                                      cfg.embed_channels)
    # K=2 params are unchanged (checkpoint compatibility)
    p2 = wn.init_params(cfg_(K=2), jax.random.PRNGKey(0))
    assert "w_prevk" not in p2 and "embed_prevk" not in p2


def _step_logits(p, cfg, toks):
    """Teacher-force the ring decoder over toks, collecting per-step logits."""
    st = wn.decode_init(cfg, toks.shape[0])

    def body(st, tok):
        st, logits = wn.decode_step(p, cfg, st, tok)
        return st, logits

    _, logits = jax.lax.scan(body, st, jnp.moveaxis(toks, 1, 0))
    return jnp.moveaxis(logits, 0, 1)                # [B, T, Q]


@pytest.mark.parametrize("K", [3, 4, 5])
def test_ring_decoder_matches_full_forward(K):
    """decode_step's width-K rings == forward_logits, past the full RF (the
    ring wraparound and the zero-unwritten-slot left-padding both covered)."""
    cfg = cfg_(K=K, max_dilation=4)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    T = cfg.receptive_field + 13
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, T), 0,
                              cfg.quantization_channels)
    full = wn.forward_logits(p, cfg, toks)
    step = jax.jit(_step_logits, static_argnums=1)(p, cfg, toks)
    np.testing.assert_allclose(np.asarray(step), np.asarray(full),
                               atol=1e-5, rtol=1e-5)


def test_fast_equals_naive_trajectories():
    """Free-running equality of the two independent implementations:
    greedy, same-key sampled, and primed — K=3."""
    cfg = cfg_(K=3)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    N = cfg.receptive_field + 17                     # roll past the window
    fast = wn.generate(p, cfg, jax.random.PRNGKey(5), N, batch=2,
                       temperature=0.0)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(9), N, batch=2,
                           temperature=0.0)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))

    fast = wn.generate(p, cfg, jax.random.PRNGKey(7), 48, batch=2)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(7), 48, batch=2)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))

    prime = jax.random.randint(jax.random.PRNGKey(2), (2, 11), 0,
                               cfg.quantization_channels)
    fast = wn.generate(p, cfg, jax.random.PRNGKey(3), 32, batch=2,
                       prime_tokens=prime, temperature=0.0)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(4), 32, batch=2,
                           prime_tokens=prime, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))


def test_mel_fast_equals_naive():
    """K=3 vocoder: conditioning timeline through priming + free-run, fast
    cond path vs the naive sliding feature window."""
    from wavenet_tpu.models.conditioning import project_cond, upsample_mel
    cfg = cfg_(K=3, max_dilation=4,
               mel=MelConfig(num_mels=8, hop_length=64, win_length=256,
                             upsample_factors=(8, 8)))
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    B, N, P = 2, cfg.receptive_field + 9, 7
    prime = jax.random.randint(jax.random.PRNGKey(2), (B, P), 0,
                               cfg.quantization_channels)
    total = P - 1 + N
    frames = total // cfg.mel.hop_length + 1
    mel = jax.random.normal(jax.random.PRNGKey(6),
                            (B, frames, cfg.mel.num_mels))
    y = upsample_mel(p["upsampler"], cfg.mel, mel, total)
    cond = project_cond(p, y)
    fast = wn.generate(p, cfg, jax.random.PRNGKey(3), N, batch=B,
                       prime_tokens=prime, cond=cond, temperature=0.0)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(8), N, batch=B,
                           prime_tokens=prime, y=y, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))


def test_global_cond_fast_equals_naive():
    """K=3 + per-utterance global conditioning (speaker): the gate offsets
    are time-constant and tap-independent, but the combination still gets a
    free-running oracle gate."""
    cfg = cfg_(K=3, max_dilation=4, global_classes=4, global_channels=8)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    spk = jnp.array([1, 3], jnp.int32)
    N = cfg.receptive_field + 9
    fast = wn.generate(p, cfg, jax.random.PRNGKey(5), N, batch=2,
                       speaker=spk, temperature=0.0)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(9), N, batch=2,
                           speaker=spk, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))
    # the two speakers must actually condition differently
    other = wn.generate(p, cfg, jax.random.PRNGKey(5), N, batch=2,
                        speaker=jnp.array([0, 0], jnp.int32),
                        temperature=0.0)
    assert not np.array_equal(np.asarray(fast), np.asarray(other))


def test_stream_chunks_equal_oneshot():
    """The streaming scan fallback serves K>2 and its concatenated chunks
    equal the one-shot decode (per-row counter-RNG seeds)."""
    cfg = cfg_(K=3)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    seeds = jnp.array([3, 11], jnp.int32)
    one = wn.generate(p, cfg, jax.random.PRNGKey(0), 50, batch=2,
                      temperature=0.9, seeds=seeds)
    chunks = list(generate_stream(p, cfg, jax.random.PRNGKey(0), 50,
                                  chunk_samples=16, batch=2,
                                  temperature=0.9, seeds=seeds))
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate(chunks, axis=1)), np.asarray(one))


def test_training_learns_and_grads_flow():
    """A K=3 model overfits a fixed batch on the scan path, and every param
    leaf (including the new tap tensors) receives a nonzero gradient."""
    import optax
    cfg = cfg_(K=3, compute_dtype="bfloat16")
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 129), 0,
                              cfg.quantization_channels)
    _, g = jax.value_and_grad(lambda p: wn.loss_fn(p, cfg, toks)[0])(p)
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        assert float(jnp.abs(leaf).max()) > 0, f"zero grad at {path}"

    opt = optax.adam(3e-3)
    st = opt.init(p)

    @jax.jit
    def step(p, st):
        (l, _), g = jax.value_and_grad(
            lambda p: wn.loss_fn(p, cfg, toks), has_aux=True)(p)
        up, st = opt.update(g, st)
        return optax.apply_updates(p, up), st, l

    first = None
    for _ in range(40):
        p, st, l = step(p, st)
        first = float(l) if first is None else first
    assert float(l) < 0.7 * first, (first, float(l))


def test_dataparallel_loss_matches():
    from jax.sharding import NamedSharding, PartitionSpec as P
    from wavenet_tpu.parallel.mesh import DATA_AXIS, make_mesh
    cfg = cfg_(K=3, compute_dtype="bfloat16", data_parallel=4,
               batch_size=8, train_window=64)
    mesh = make_mesh(cfg)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 65), 0,
                              cfg.quantization_channels)
    ref, _ = wn.loss_fn(p, cfg, toks)
    sharded = jax.device_put(toks, NamedSharding(mesh, P(DATA_AXIS, None)))
    got, _ = jax.jit(lambda p, t: wn.loss_fn(p, cfg, t))(p, sharded)
    np.testing.assert_allclose(float(got), float(ref), rtol=2e-5)


def test_checkpoint_roundtrip(tmp_path):
    from wavenet_tpu.models.api import WaveNet
    cfg = cfg_(K=3)
    m = WaveNet(cfg).init(jax.random.PRNGKey(0))
    m.save(str(tmp_path / "ck"), step=3)
    m2 = WaveNet.from_checkpoint(str(tmp_path / "ck"))
    assert m2.cfg.kernel_size == 3
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 65), 0,
                              cfg.quantization_channels)
    np.testing.assert_array_equal(np.asarray(m.logits(toks)),
                                  np.asarray(m2.logits(toks)))


def test_width2_only_paths_refuse():
    """Routing contracts: every width-2-only subsystem refuses K>2 configs
    instead of computing wrong answers."""
    from wavenet_tpu import route
    from wavenet_tpu.ops.pallas import decode_gpu
    from wavenet_tpu.parallel import distdecode, seqpar
    from wavenet_tpu.parallel.mesh import make_mesh
    cfg = cfg_(K=3, residual_channels=64, skip_channels=64,
               compute_dtype="bfloat16")
    assert not decode_gpu.supported(cfg)
    assert route.decode(cfg, platform="gpu") == route.SCAN
    assert decode_gpu.supported(cfg.replace(kernel_size=2))
    mesh = make_mesh(cfg.replace(data_parallel=2))
    with pytest.raises(ValueError, match="width-2"):
        distdecode.generate_sharded(
            wn.init_params(cfg, jax.random.PRNGKey(0)), cfg, mesh,
            seed=0, num_samples=8, batch=2)
    with pytest.raises(ValueError, match="width-2"):
        seqpar.check_seq_shardable(
            cfg, make_mesh(cfg.replace(seq_parallel=2)), 64)
    # the gate must fire at seq=1 too: the sp forward wires a maxd-wide
    # halo that a K>2 tap's (K-1)*maxd shift would silently clamp through
    with pytest.raises(ValueError, match="width-2"):
        seqpar.check_seq_shardable(
            cfg, make_mesh(cfg.replace(data_parallel=2)), 64)


@pytest.mark.parametrize("K", [3, 4])
def test_short_sequence_forward(K):
    """T <= tap distance: forward_logits must keep the [B, T, Q] shape and
    match the ring decoder step for step (the zero-fill taps, not an
    under-sliced pad, carry the pre-sequence history)."""
    cfg = cfg_(K=K, max_dilation=4)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    for T in (1, 2, K - 1, K):
        toks = jax.random.randint(jax.random.PRNGKey(T), (2, T), 0,
                                  cfg.quantization_channels)
        full = wn.forward_logits(p, cfg, toks)
        assert full.shape == (2, T, cfg.quantization_channels)
        step = _step_logits(p, cfg, toks)
        np.testing.assert_allclose(np.asarray(step), np.asarray(full),
                                   atol=1e-5, rtol=1e-5)


def test_serving_engine_serves_k3():
    """The microbatching serving engine serves wider-kernel models through
    the streaming scan fallback, with the deterministic-replay contract
    intact (reply == facade stream at the same seed)."""
    from wavenet_tpu.models.api import WaveNet
    from wavenet_tpu.serving import WaveNetServer
    cfg = cfg_(K=3, compute_dtype="bfloat16", sample_rate=8000)
    m = WaveNet(cfg).init(jax.random.PRNGKey(0))
    srv = WaveNetServer(m, max_batch=2, max_wait_ms=1,
                        chunk_seconds=16 / 8000,
                        length_quantum_seconds=32 / 8000)
    try:
        got = srv.submit(num_samples=32, seed=5).waveform()
    finally:
        srv.close()
    ref = np.concatenate(
        [np.asarray(c) for c in m.stream(num_samples=32, chunk_samples=16,
                                         batch=1, seeds=np.asarray([5]))],
        axis=1)
    np.testing.assert_array_equal(got, ref[0])


def test_decode_unroll_with_wide_kernel_size():
    """The scan decoder's layer-unroll knob composes with the K>2 tap loop:
    on CPU the unrolled trajectory is bit-identical (mirrors the K=2 gate
    in test_compcache; on a GPU near-tie divergence is allowed by contract)."""
    if jax.default_backend() == "gpu":
        pytest.skip("CPU-only bit-equality contract")
    cfg = cfg_(K=3)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    base = wn.generate(p, cfg, jax.random.PRNGKey(5), 48, batch=2,
                       temperature=0.9, seeds=jnp.array([3, 9], jnp.int32))
    un = wn.generate(p, cfg.replace(decode_unroll=4), jax.random.PRNGKey(5),
                     48, batch=2, temperature=0.9,
                     seeds=jnp.array([3, 9], jnp.int32))
    np.testing.assert_array_equal(np.asarray(base), np.asarray(un))


def test_k2_unchanged_bit_for_bit():
    """The K=2 fast decoder's trajectory is untouched by the generalization
    (the branch keeps the shipped graph): fast == naive still holds and the
    ring layout is the familiar sum(d)."""
    cfg = cfg_(K=2)
    offs, sum_d = wn.ring_offsets(cfg)
    assert sum_d == sum(cfg.dilations)
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    fast = wn.generate(p, cfg, jax.random.PRNGKey(5), 40, batch=2,
                       temperature=0.0)
    naive = generate_naive(p, cfg, jax.random.PRNGKey(9), 40, batch=2,
                           temperature=0.0)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(naive))
