"""Deployment knobs: persistent compilation cache + decode_unroll.

decode_unroll shortens the scan decoder's serialized layer chain; its
contract is "same math per layer": trajectories must match unroll=1 on the
backend under test.  The compilation cache makes the cold compile of
unrolled shapes a per-machine (not per-process) cost; here we verify it
persists executables to disk and honours $JAX_COMPILATION_CACHE_DIR.
"""

import os

import jax
import jax.numpy as jnp
import pytest

from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.models.api import WaveNet
from wavenet_tpu.utils import compcache


def _cfg(**kw):
    base = dict(num_blocks=2, max_dilation=8, residual_channels=16,
                skip_channels=16, compute_dtype="float32",
                batch_size=2, train_window=256)
    base.update(kw)
    return WaveNetConfig(**base)


@pytest.mark.parametrize("unroll", [2, 3, 8])
def test_decode_unroll_trajectory_identical(unroll, rng):
    """unroll=k (dividing and non-dividing L=8) samples the same tokens as
    unroll=1 from the same seed, primed and unprimed.  CPU-only by design:
    on a GPU, XLA may reassociate across unrolled scan bodies, so near-tie
    trajectories can legitimately diverge between unroll settings — that is
    the documented contract (config.py decode_unroll; ARCHITECTURE.md §2)."""
    if jax.default_backend() == "gpu":
        pytest.skip("bit-equality across unroll settings is only "
                    "contractual on CPU (see config.decode_unroll)")
    cfg = _cfg()
    params = wn.init_params(cfg, rng)
    key = jax.random.PRNGKey(3)
    prime = jax.random.randint(jax.random.PRNGKey(4), (2, 40), 0,
                               cfg.quantization_channels)
    for pt in (None, prime):
        base = wn.generate(params, cfg, key, 64, batch=2, prime_tokens=pt)
        fast = wn.generate(params, cfg.replace(decode_unroll=unroll), key,
                           64, batch=2, prime_tokens=pt)
        assert jnp.array_equal(base, fast), (
            f"unroll={unroll} diverged (prime={pt is not None})")


def test_decode_unroll_validated():
    with pytest.raises(ValueError, match="decode_unroll"):
        _cfg(decode_unroll=0)


def test_decode_unroll_json_roundtrip():
    cfg = _cfg(decode_unroll=8)
    assert WaveNetConfig.from_json(cfg.to_json()).decode_unroll == 8
    # older checkpoints' config JSON (no key) loads with the default
    import json
    d = json.loads(cfg.to_json())
    del d["decode_unroll"]
    assert WaveNetConfig.from_json(json.dumps(d)).decode_unroll == 1


def test_replace_config_guards_architecture(rng):
    cfg = _cfg()
    model = WaveNet(cfg, wn.init_params(cfg, rng))
    fast = model.replace_config(decode_unroll=8)
    assert fast.cfg.decode_unroll == 8
    assert fast.params is model.params          # shared, not copied
    assert model.cfg.decode_unroll == 1         # original untouched
    with pytest.raises(ValueError, match="architecture"):
        model.replace_config(residual_channels=32)


def test_compilation_cache_persists_to_disk(tmp_path, rng):
    d = str(tmp_path / "xla_cache")
    assert compcache.enable(d, min_compile_secs=0.0) == os.path.abspath(d)
    assert compcache.enabled_dir() == os.path.abspath(d)
    cfg = _cfg()
    params = wn.init_params(cfg, rng)
    wn.generate(params, cfg, jax.random.PRNGKey(0), 8, batch=2)
    entries = os.listdir(d)
    assert entries, "no executables persisted to the compilation cache"


@pytest.mark.parametrize("env", [None, "from-env"])
def test_default_dir_honours_env(monkeypatch, tmp_path, env):
    """$JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed path
    runs/.xla_cache inside the checkout."""
    if env is None:
        monkeypatch.delenv(compcache.ENV, raising=False)
        d = compcache.default_dir()
        assert d.endswith(os.path.join("runs", ".xla_cache"))
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert os.path.dirname(os.path.dirname(d)) == repo
    else:
        monkeypatch.setenv(compcache.ENV, str(tmp_path / env))
        assert compcache.default_dir() == str(tmp_path / env)


def test_enable_under_env_sets_no_directory(monkeypatch, tmp_path):
    """With the variable set, JAX reads it itself: enable() turns the cache
    on and reports that directory without setting another in code."""
    import jax
    monkeypatch.setenv(compcache.ENV, str(tmp_path / "envcache"))
    keys = ("jax_compilation_cache_dir", "jax_enable_compilation_cache",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    try:
        got = compcache.enable()
        assert got == os.path.abspath(str(tmp_path / "envcache"))
        assert os.path.isdir(got)
        assert jax.config.jax_compilation_cache_dir == \
            before["jax_compilation_cache_dir"]
    finally:                    # leave no cache setting to later tests
        for k, v in before.items():
            jax.config.update(k, v)
