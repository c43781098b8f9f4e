"""The router (wavenet_tpu/route.py): positive platform tests, one route
per hot path, and the interpreter only when a caller asks for it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from wavenet_tpu import route
from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def cfg_(**kw):
    base = dict(num_blocks=1, max_dilation=8, residual_channels=32,
                skip_channels=32)
    base.update(kw)
    return WaveNetConfig(**base)


@pytest.mark.parametrize("platform,interpret,want", [
    ("cpu", False, route.SCAN),
    ("cpu", True, route.KERNEL),
    ("gpu", False, route.KERNEL),
    ("gpu", True, route.KERNEL),
])
def test_decode_route_by_platform(platform, interpret, want):
    assert route.decode(cfg_(), platform=platform, interpret=interpret) == want
    assert route.stream(cfg_(), platform=platform, interpret=interpret) == want


@pytest.mark.parametrize("platform", ["rocm", "METAL", "xpu"])
def test_unknown_platform_raises(platform):
    for fn in (lambda: route.decode(cfg_(), platform=platform),
               lambda: route.stream(cfg_(), platform=platform),
               lambda: route.train_loss(cfg_(), platform=platform)):
        with pytest.raises(ValueError, match=platform):
            fn()


def test_current_platform_is_positive():
    assert route.current_platform() in route.PLATFORMS


def _mesh(dp, mp):
    devs = np.asarray(jax.devices()[:dp * mp]).reshape(dp, mp)
    return Mesh(devs, (DATA_AXIS, MODEL_AXIS))


@pytest.mark.parametrize("dp,mp,batch,want", [
    (2, 1, 4, route.KERNEL),       # data-parallel only: kernel fan-out
    (2, 2, 4, route.SCAN),         # model axis: collective decoder
    (2, 1, 3, route.SCAN),         # rows do not split evenly
])
def test_dp_decode_route(dp, mp, batch, want):
    got = route.dp_decode(cfg_(), _mesh(dp, mp), batch, platform="gpu")
    assert got == want
    # on the CPU the fan-out runs only when the interpreter is asked for
    assert route.dp_decode(cfg_(), _mesh(dp, mp), batch,
                           platform="cpu") == route.SCAN


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_train_loss_is_the_xla_loss(platform):
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 65), 0, 256)
    loss = route.train_loss(cfg, platform=platform)
    got, _ = loss(p, {"tokens": toks})
    want, _ = wn.loss_fn(p, cfg, toks)
    assert float(got) == float(want)


def test_train_loss_seq_parallel_needs_mesh():
    with pytest.raises(ValueError, match="mesh"):
        route.train_loss(cfg_(seq_parallel=2))


def test_cpu_stream_never_enters_interpreter(monkeypatch):
    """Without interpret=True the CPU streams through the scan: the kernel
    driver is never called."""
    from wavenet_tpu.generate import sampler
    from wavenet_tpu.ops.pallas import decode_gpu

    def boom(*a, **k):
        raise AssertionError("kernel route taken without interpret=True")

    monkeypatch.setattr(decode_gpu, "stream", boom)
    monkeypatch.setattr(decode_gpu, "generate", boom)
    cfg = cfg_()
    p = wn.init_params(cfg, jax.random.PRNGKey(0))
    chunks = list(sampler.generate_stream(p, cfg, jax.random.PRNGKey(1), 12,
                                          chunk_samples=5, batch=2))
    assert [c.shape for c in chunks] == [(2, 5), (2, 5), (2, 2)]
    toks = sampler.generate_auto(p, cfg, jax.random.PRNGKey(1), 12, batch=2)
    np.testing.assert_array_equal(np.asarray(jnp.concatenate(chunks, 1)),
                                  np.asarray(toks))


@pytest.mark.parametrize("unroll", [1, 40])
def test_mel_configs_take_the_kernel_on_gpu(unroll):
    """Wide and narrow mel configs take the kernel on the GPU whatever the
    scan's unroll, and on the CPU only in the interpreter."""
    from wavenet_tpu.config import MelConfig, conditional, full_vocoder
    for cfg in (full_vocoder(), conditional(),
                cfg_(residual_channels=128, mel=MelConfig()),
                cfg_(mel=MelConfig())):
        cfg = cfg.replace(decode_unroll=unroll)
        assert route.decode(cfg, platform="gpu") == route.KERNEL
        assert route.stream(cfg, platform="gpu") == route.KERNEL
        assert route.decode(cfg, platform="cpu") == route.SCAN
        assert route.decode(cfg, platform="cpu", interpret=True) == \
            route.KERNEL


def test_unsupported_config_takes_scan_on_gpu():
    for cfg in (cfg_(kernel_size=3), cfg_(compute_dtype="float32"),
                cfg_(residual_channels=24), cfg_(causal_channels=64)):
        assert route.decode(cfg, platform="gpu") == route.SCAN
