"""The .npz + JSON checkpointer (training/checkpoint.py): exact round trip,
atomic steps, retention, dtypes, error surfacing, and legacy configs."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavenet_tpu.audio.dataset import IteratorState
from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.training import checkpoint as ck


def cfg_(**kw):
    base = dict(num_blocks=1, max_dilation=4, residual_channels=16,
                skip_channels=16, batch_size=2, train_window=64)
    base.update(kw)
    return WaveNetConfig(**base)


def _state(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"w": jax.random.normal(k, (4, 3)),
            "nested": {"b": jnp.arange(5, dtype=jnp.int32),
                       "h": jax.random.normal(k, (2,)).astype(jnp.bfloat16)},
            "seq": (jnp.ones((2,)), jnp.zeros((), jnp.float32))}


def test_roundtrip_exact_with_iterator(tmp_path):
    m = ck.CheckpointManager(str(tmp_path), cfg_())
    st = _state()
    m.save(7, st, IteratorState(seed=3, step=11), wait=True)
    got, it = m.restore(jax.tree.map(jnp.zeros_like, st))
    assert it == IteratorState(seed=3, step=11)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_restore_onto_abstract_shapes(tmp_path):
    m = ck.CheckpointManager(str(tmp_path), cfg_())
    st = _state(1)
    m.save(1, st, IteratorState(seed=0, step=0))
    abstract = jax.eval_shape(lambda: st)
    got, _ = ck.CheckpointManager(str(tmp_path), cfg_()).restore(abstract)
    np.testing.assert_array_equal(np.asarray(got["w"]), np.asarray(st["w"]))


def test_keeps_newest_steps_only(tmp_path):
    m = ck.CheckpointManager(str(tmp_path), cfg_(), max_to_keep=3)
    for s in range(1, 6):
        m.save(s, _state(s), IteratorState(seed=0, step=s))
    m.wait()
    assert sorted(n for n in os.listdir(tmp_path) if n.isdigit()) == \
        ["3", "4", "5"]
    assert m.latest_step() == 5
    assert not [n for n in os.listdir(tmp_path) if "tmp" in n]
    _, it = m.restore(_state(), step=4)
    assert it.step == 4


def test_failed_save_surfaces_at_wait(tmp_path, monkeypatch):
    m = ck.CheckpointManager(str(tmp_path), cfg_())

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ck.np, "savez", broken)
    m.save(1, _state(), IteratorState(seed=0, step=0))
    with pytest.raises(RuntimeError, match="failed"):
        m.wait()
    assert m.latest_step() is None           # nothing half-written is seen


def test_restore_without_checkpoint_raises(tmp_path):
    m = ck.CheckpointManager(str(tmp_path), cfg_())
    with pytest.raises(FileNotFoundError):
        m.restore(_state())


def test_legacy_config_keys_load(tmp_path):
    """params.json from older versions carries the switches of the removed
    fused kernel; it still loads, and the manager accepts the directory."""
    cfg = cfg_()
    d = json.loads(cfg.to_json())
    d.update(fused_stack=True, pipeline_microbatch=2)
    path = tmp_path / "params.json"
    path.write_text(json.dumps(d))
    assert WaveNetConfig.from_json(json.dumps(d)) == cfg
    assert ck.CheckpointManager.load_config(str(tmp_path)) == cfg
    ck.CheckpointManager(str(tmp_path), cfg)     # architecture guard passes
