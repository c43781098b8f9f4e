"""Checkpoint/resume as .npz plus JSON (SURVEY.md §5.4).

Saves params + optimizer state + step + data-iterator state, with the config
JSON written alongside — mirroring the reference's params-JSON-next-to-HDF5
layout (musyoku/wavenet saves a params JSON beside Chainer HDF5 snapshots;
SURVEY.md §3.4).  Layout:

    <dir>/params.json                 the config (architecture guard)
    <dir>/<step>/state.npz            every leaf, keyed by its tree path
    <dir>/<step>/meta.json            iterator state, non-numpy leaf dtypes

A step directory is written under a temporary name and renamed into place,
so a reader sees a whole step or none.  Saves are asynchronous: the arrays
are copied to the host on the caller's thread (the train step donates its
buffers), and a background thread writes the files.  Restores place every
leaf onto the target's sharding, so a run may resume under another mesh.

Resume is EXACT: the iterator state (seed, step) makes the next batch
identical to what an uninterrupted run would have seen (SURVEY.md §5.3).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import jax
import numpy as np

from wavenet_tpu.audio.dataset import IteratorState
from wavenet_tpu.config import WaveNetConfig

# In-flight save threads per directory, so restore()/latest_step() of ANY
# manager in this process waits out a save queued by another instance —
# durability is a guarantee of the public API, not a convention callers
# must remember (SURVEY.md §5.3/§5.4).
_PENDING: Dict[str, List[threading.Thread]] = {}
_PENDING_LOCK = threading.Lock()


class _Save(threading.Thread):
    """A background write whose failure surfaces at the next wait."""

    def __init__(self, fn, *args):
        super().__init__(daemon=False)
        self._fn, self._args, self.error = fn, args, None

    def run(self):
        try:
            self._fn(*self._args)
        except BaseException as e:          # re-raised by _wait_directory
            self.error = e


def _wait_directory(directory: str) -> None:
    with _PENDING_LOCK:
        threads = _PENDING.pop(directory, [])
    for t in threads:
        t.join()
        if t.error is not None:
            raise RuntimeError(f"checkpoint save to {directory} failed"
                               ) from t.error


def _path_key(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        from jax.experimental import multihost_utils
        leaf = multihost_utils.process_allgather(leaf, tiled=True)
    return np.asarray(jax.device_get(leaf))


def _place(value: np.ndarray, target):
    sharding = getattr(target, "sharding", None)
    value = value.astype(target.dtype) if value.dtype != target.dtype \
        else value
    if sharding is None:
        return jax.numpy.asarray(value)
    return jax.make_array_from_callback(value.shape, sharding,
                                        lambda idx: value[idx])


def _steps(directory: str) -> List[int]:
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


class CheckpointManager:
    def __init__(self, directory: str, cfg: WaveNetConfig,
                 max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.cfg = cfg
        self.max_to_keep = max_to_keep
        # config JSON beside the checkpoints (reference parity)
        cfg_path = os.path.join(self.directory, "params.json")
        if os.path.exists(cfg_path):
            # a stale ARCHITECTURE config silently mis-restores (shape
            # errors at best; wrong sample_rate/quantization would not even
            # crash) — refuse to mix model shapes in one directory.
            # Training-schedule fields (lr, ema_decay, parallelism,
            # batch/window) may legitimately differ across resumes (e.g.
            # the EMA cross-compat path) and are not checked.
            with open(cfg_path) as f:
                existing = WaveNetConfig.from_json(f.read())
            diff = [k for k in self._ARCH_FIELDS
                    if getattr(existing, k) != getattr(cfg, k)]
            if diff:
                raise ValueError(
                    f"{cfg_path} was written for a different model "
                    f"architecture (fields differ: {diff}); use a fresh "
                    f"checkpoint directory")
        elif jax.process_index() == 0:
            # atomic write: other processes may construct their manager
            # concurrently and read this file — they must see nothing
            # (skip validation) or the complete JSON, never a prefix
            tmp = f"{cfg_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(cfg.to_json())
            os.replace(tmp, cfg_path)

    # every field that changes the parameter tree's SHAPES or the meaning
    # of the stored values (param_dtype changes stored dtypes; sample_rate/
    # quantization change what the numbers mean even where shapes agree)
    _ARCH_FIELDS = ("num_blocks", "max_dilation", "kernel_size",
                    "residual_channels", "skip_channels", "causal_channels",
                    "quantization_channels", "sample_rate", "param_dtype",
                    "mel", "global_classes", "global_channels")

    @staticmethod
    def _state_tree(state: Any):
        """NamedTuple states as dicts, DROPPING None-valued optional fields
        (e.g. TrainState.ema when EMA is off), so an optional field is never
        a checkpoint-format break."""
        if hasattr(state, "_asdict"):
            d = dict(state._asdict())
            return {k: v for k, v in d.items() if v is not None}
        return state

    def save(self, step: int, state: Any, iter_state: IteratorState,
             wait: bool = False) -> None:
        """Async by default: host copies are taken now, the files are
        written by a background thread."""
        flat = jax.tree_util.tree_flatten_with_path(self._state_tree(state))[0]
        arrays, dtypes = {}, {}
        for path, leaf in flat:
            key, arr = _path_key(path), _to_host(leaf)
            if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
                dtypes[key] = arr.dtype.name        # numpy has no such type
                arr = arr.view(f"u{arr.dtype.itemsize}")
            arrays[key] = arr
        meta = {"iterator": {"seed": iter_state.seed,
                             "step": iter_state.step},
                "dtypes": dtypes}
        if jax.process_index() != 0:
            return
        # one save in flight per directory: writes land in step order
        _wait_directory(self.directory)
        t = _Save(self._write, step, arrays, meta)
        t.start()
        with _PENDING_LOCK:
            _PENDING.setdefault(self.directory, []).append(t)
        if wait:
            self.wait()

    def _write(self, step: int, arrays, meta) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in _steps(self.directory)[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def restore(self, abstract_state: Any, step: Optional[int] = None
                ) -> Tuple[Any, IteratorState]:
        """Restore onto `abstract_state`'s structure, dtypes and shardings
        (arrays or ShapeDtypeStructs)."""
        # never observe a half-written/absent checkpoint this process just
        # queued: settle every in-flight save first
        _wait_directory(self.directory)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        cls = type(abstract_state) if hasattr(abstract_state, "_asdict") \
            else None
        tree = self._state_tree(abstract_state)
        step_dir = os.path.join(self.directory, str(step))
        with open(os.path.join(step_dir, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(step_dir, "state.npz")) as z:
            stored = {k: z[k] for k in z.files}
        for k, name in meta["dtypes"].items():
            stored[k] = stored[k].view(jax.numpy.dtype(name))
        if cls is not None:
            # tolerate ema presence mismatches in either direction (resume
            # an old run with EMA newly on, or with EMA turned off)
            on_disk = any(k.startswith("ema/") for k in stored)
            if "ema" in tree and not on_disk:
                tree = {k: v for k, v in tree.items() if k != "ema"}
        flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
        missing = [_path_key(p) for p, _ in flat
                   if _path_key(p) not in stored]
        if missing:
            raise ValueError(f"checkpoint {step_dir} lacks {missing[:5]}")
        rs = jax.tree_util.tree_unflatten(
            treedef, [_place(stored[_path_key(p)], leaf) for p, leaf in flat])
        if cls is not None:
            state = cls(**{f: rs.get(f) for f in cls._fields if f in rs})
            if getattr(abstract_state, "ema", None) is not None \
                    and state.ema is None:
                # EMA enabled on a pre-EMA checkpoint: start the average
                # from a COPY of the restored params (aliasing them would
                # double-donate the buffers in the donated train step)
                state = state._replace(
                    ema=jax.tree.map(jax.numpy.copy, state.params))
        else:
            state = rs
        it = meta["iterator"]
        return state, IteratorState(seed=it["seed"], step=it["step"])

    def latest_step(self) -> Optional[int]:
        _wait_directory(self.directory)
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def wait(self):
        _wait_directory(self.directory)

    @staticmethod
    def load_config(directory: str) -> WaveNetConfig:
        with open(os.path.join(directory, "params.json")) as f:
            return WaveNetConfig.from_json(f.read())
