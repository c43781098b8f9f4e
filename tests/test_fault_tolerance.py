"""Failure-detection / elastic-recovery tests (SURVEY.md §5.3): a killed
training process must resume from its checkpoint EXACTLY — same params, same
upcoming batches — as an uninterrupted run."""

import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from wavenet_tpu.audio.dataset import AudioDataset
from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.training.trainer import Trainer

CFG_KW = dict(num_blocks=1, max_dilation=8, residual_channels=8,
              skip_channels=8, compute_dtype="float32",
              batch_size=2, train_window=128, learning_rate=1e-3)

CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from wavenet_tpu.audio.dataset import AudioDataset
from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.training.trainer import Trainer

cfg = WaveNetConfig(**{cfg_kw!r})
ds = AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.2)
tr = Trainer(cfg, ds, checkpoint_dir={ckpt!r})
tr.run(num_steps=5, log_every=0)
tr.save()   # durable by default: committed before this returns
print("CHECKPOINTED", flush=True)
# simulate a preemption: hard-exit mid-training (no cleanup)
os._exit(42)
"""


def test_kill_and_resume_equivalence(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = str(tmp_path / "ckpt")

    # child process trains 5 steps, checkpoints, then dies uncleanly
    script = CHILD.format(repo=repo, cfg_kw=CFG_KW, ckpt=ckpt)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert "CHECKPOINTED" in proc.stdout, proc.stderr[-2000:]
    assert proc.returncode == 42                # died as instructed

    # survivor: restore and continue 3 steps
    cfg = WaveNetConfig(**CFG_KW)
    ds = AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.2)
    tr = Trainer(cfg, ds, checkpoint_dir=ckpt)
    tr.restore()
    assert int(jax.device_get(tr.state.step)) == 5
    assert tr.iter_state.step == 5
    tr.run(num_steps=3, log_every=0)
    resumed = jax.device_get(tr.state.params)

    # oracle: uninterrupted 8 steps in-process
    tr2 = Trainer(cfg, ds)
    tr2.run(num_steps=8, log_every=0)
    straight = jax.device_get(tr2.state.params)

    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_flatten_with_path(resumed)[0],
            jax.tree_util.tree_flatten_with_path(straight)[0]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5,
                                   err_msg=str(ka))
