"""Training driver: one pjit-compiled step, sharded state, deterministic data.

The reference's whole `for iteration` body (SURVEY.md §3.1) becomes ONE
jit-compiled function over the (data, seq, model) mesh; host<->device crossing
only for the input token batch and scalar metric fetch.  Gradients are
averaged across `data` implicitly by GSPMD (batch is sharded, loss is a mean),
and tensor-parallel reductions follow the sharding rules in
parallel/sharding.py.
"""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from wavenet_tpu import route
from wavenet_tpu.audio.dataset import AudioDataset, IteratorState
from wavenet_tpu.config import WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.parallel import sharding as shd
from wavenet_tpu.parallel.mesh import make_mesh


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array          # scalar int32
    # EMA of params when cfg.ema_decay is set, else None.  None is an empty
    # pytree node, so the state structure (and old checkpoints) are
    # unchanged when the feature is off.
    ema: Any = None


def make_lr_schedule(cfg: WaveNetConfig):
    peak = cfg.learning_rate
    floor = peak * cfg.lr_min_ratio
    if cfg.lr_schedule == "constant":
        sched = optax.constant_schedule(peak)
    elif cfg.lr_schedule == "cosine":
        sched = optax.cosine_decay_schedule(
            peak, cfg.lr_decay_steps, alpha=cfg.lr_min_ratio)
    elif cfg.lr_schedule == "exponential":
        sched = optax.exponential_decay(
            peak, cfg.lr_decay_steps, decay_rate=cfg.lr_min_ratio,
            end_value=floor)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.warmup_steps:
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, peak, cfg.warmup_steps), sched],
            [cfg.warmup_steps])
    return sched


def make_optimizer(cfg: WaveNetConfig) -> optax.GradientTransformation:
    tx = optax.adam(make_lr_schedule(cfg), b1=cfg.adam_b1, b2=cfg.adam_b2)
    if cfg.grad_clip_norm is not None:
        tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm), tx)
    if cfg.grad_accum > 1:
        # each update applies the MEAN grad of grad_accum microbatches, so
        # one apply == one step on a grad_accum*batch_size batch (clipping
        # and the lr schedule see only applied steps).  The accumulator
        # shards like the params (it mirrors their pytree).
        tx = optax.MultiSteps(tx, every_k_schedule=cfg.grad_accum)
    return tx


def make_train_step(cfg: WaveNetConfig, tx: optax.GradientTransformation,
                    mesh: Optional[Mesh] = None):
    """Build the jitted train step: (state, batch) -> (state, metrics).

    The loss comes from the router (`wavenet_tpu.route.train_loss`): XLA's
    plain path, or the halo-exchange shard_map when cfg.seq_parallel > 1
    (`mesh` is required then).  GSPMD shards everything else.
    """
    loss_of_batch = route.train_loss(cfg, mesh)

    def train_step(state: TrainState, batch: Dict[str, jax.Array]
                   ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        (loss, aux), grads = jax.value_and_grad(loss_of_batch, has_aux=True)(
            state.params, batch)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        ema = state.ema
        if cfg.ema_decay is not None:
            d = cfg.ema_decay
            if cfg.grad_accum > 1:
                # only count APPLIED optimizer steps toward the average:
                # on accumulation-only microsteps (params unchanged;
                # MultiSteps.mini_step has not wrapped back to 0) the decay
                # degenerates to 1.0 and ema stays put
                applied = opt_state.mini_step == 0
                d = jnp.where(applied, d, 1.0)
            ema = jax.tree.map(lambda e, p: d * e + (1.0 - d) * p,
                               state.ema, params)
        metrics = dict(aux)
        if cfg.grad_accum > 1:
            # grad_norm must reflect what the optimizer SEES (round-2
            # advisor): under MultiSteps that is the running k-microbatch
            # mean, not the raw per-microbatch gradient — recompute the
            # post-accumulation mean from the PRE-update state (acc_grads
            # resets to zero on apply steps, so it can't be read after).
            # On apply steps (mini_step wraps to 0) this equals exactly the
            # gradient the update consumed; the raw per-microbatch norm is
            # kept alongside for debugging.
            k = state.opt_state.mini_step + 1
            acc = jax.tree.map(lambda a, g: a + (g - a) / k,
                               state.opt_state.acc_grads, grads)
            metrics["grad_norm"] = optax.global_norm(acc)
            metrics["microbatch_grad_norm"] = optax.global_norm(grads)
        else:
            metrics["grad_norm"] = optax.global_norm(grads)
        return TrainState(params, opt_state, state.step + 1, ema), metrics

    return train_step


class Trainer:
    """End-to-end training orchestration (reference `train.py` equivalent,
    SURVEY.md §2 #9) with sharded state and exact-resume checkpointing."""

    def __init__(self, cfg: WaveNetConfig, dataset: AudioDataset,
                 mesh: Optional[Mesh] = None,
                 checkpoint_dir: Optional[str] = None):
        self.cfg = cfg
        self.dataset = dataset
        self.mesh = mesh if mesh is not None else make_mesh(cfg)
        shd.validate(cfg, self.mesh)
        self.checkpoint_dir = checkpoint_dir
        self.tx = make_optimizer(cfg)

        self.param_shardings = shd.param_shardings(cfg, self.mesh)
        self.batch_shardings = shd.batch_shardings(
            self.mesh, with_mel=cfg.mel is not None,
            with_speaker=cfg.global_classes is not None)
        self.iter_state = IteratorState(seed=cfg.seed, step=0)
        self._eval_step = None

        # init sharded state directly on the mesh: eval_shape + jit(out_shardings)
        def _init(key):
            params = wn.init_params(cfg, key)
            ema = params if cfg.ema_decay is not None else None
            return TrainState(params, self.tx.init(params),
                              jnp.zeros((), jnp.int32), ema)

        opt_shardings = self._opt_state_shardings(_init)
        self.state_shardings = TrainState(
            self.param_shardings, opt_shardings,
            NamedSharding(self.mesh, P()),
            self.param_shardings if cfg.ema_decay is not None else None)
        self.state: TrainState = jax.jit(
            _init, out_shardings=self.state_shardings)(
                jax.random.PRNGKey(cfg.seed))

        step = make_train_step(cfg, self.tx, mesh=self.mesh)
        self._step = jax.jit(
            step,
            in_shardings=(self.state_shardings, self.batch_shardings),
            out_shardings=(self.state_shardings, None),
            donate_argnums=(0,),
        )

        if checkpoint_dir is not None:
            from wavenet_tpu.training.checkpoint import CheckpointManager
            self.ckpt = CheckpointManager(checkpoint_dir, cfg)
        else:
            self.ckpt = None

    def _opt_state_shardings(self, init_fn):
        """Optimizer state shards like the params it mirrors (adam mu/nu are
        param-shaped pytrees embedded in the optax state); scalar counts
        replicate.  Matched by key-path suffix against the param spec tree."""
        shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
        param_spec_tree = shd.param_pspecs(self.cfg)
        flat_spec = jax.tree.flatten_with_path(
            param_spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
        spec_by_path = {jax.tree_util.keystr(k): v for k, v in flat_spec}

        def leaf_shard(path, leaf):
            ks = jax.tree_util.keystr(path)
            for pks, spec in spec_by_path.items():
                if ks.endswith(pks):
                    return NamedSharding(self.mesh, spec)
            return NamedSharding(self.mesh, P())

        return jax.tree_util.tree_map_with_path(leaf_shard, shapes.opt_state)

    # ------------------------------------------------------------------
    def run(self, num_steps: int, log_every: int = 50,
            checkpoint_every: Optional[int] = None,
            log_fn=print, metrics_fn=None) -> Dict[str, float]:
        """Train for num_steps; returns final metrics (+ throughput).

        metrics_fn(global_step, dict) is called at every log_every interval
        with the fetched scalar metrics (JSONL streaming hook)."""
        if num_steps <= 0:
            return {}
        cfg = self.cfg
        audio_seconds_per_batch = cfg.batch_size * cfg.train_window / cfg.sample_rate
        last = None
        t_start = None
        steps_timed = 0
        multihost = jax.process_count() > 1
        with self.mesh:
            for i in range(num_steps):
                batch, self.iter_state = self.dataset.sample_batch(self.iter_state)
                if multihost:
                    # every host computed the SAME deterministic global batch
                    # from (seed, step); each feeds only its local slice and
                    # the runtime assembles the global array (SURVEY.md §5.8)
                    from wavenet_tpu.parallel.distributed import local_batch_slice
                    sl = local_batch_slice(batch["tokens"].shape[0])
                    batch = {
                        k: jax.make_array_from_process_local_data(
                            self.batch_shardings[k], v[sl])
                        for k, v in batch.items()}
                self.state, metrics = self._step(self.state, batch)
                if i == 0:
                    # exclude compile and the first device->host readback
                    jax.device_get(metrics)
                    t_start = time.perf_counter()
                    steps_timed = 0
                else:
                    steps_timed += 1
                if log_every and i % log_every == 0 and i < num_steps - 1:
                    # one transfer for the whole dict, not one per scalar
                    m = {k: float(v) for k, v in
                         jax.device_get(metrics).items()}
                    log_fn(f"step {i + 1} "
                           f"loss {m['loss']:.4f} acc {m['accuracy']:.3f}")
                    if metrics_fn:
                        metrics_fn(int(jax.device_get(self.state.step)), m)
                if self.ckpt and checkpoint_every and (i + 1) % checkpoint_every == 0:
                    # async: the loop keeps training while a background
                    # thread writes; the next save waits for it, and the
                    # run-exit wait below makes the last one durable too
                    self.save(wait=False)
        jax.block_until_ready(self.state.params)
        if self.ckpt is not None:
            # durability barrier: no in-loop save is still in flight when
            # run() returns (a caller may restore through a fresh manager,
            # or the process may exit)
            self.ckpt.wait()
        dt = time.perf_counter() - t_start if steps_timed else None
        last = {k: float(v) for k, v in jax.device_get(metrics).items()}
        if log_every:
            log_fn(f"step {num_steps} loss {last['loss']:.4f} "
                   f"acc {last['accuracy']:.3f}")
        if dt:
            last["steps_per_sec"] = steps_timed / dt
            last["audio_seconds_per_sec"] = (
                steps_timed * audio_seconds_per_batch / dt)
        return last

    # ------------------------------------------------------------------
    def evaluate(self, dataset: Optional[AudioDataset] = None,
                 num_batches: int = 8, seed: int = 987) -> Dict[str, float]:
        """Mean loss/accuracy over deterministic held-out batches (the
        reference had no eval loop at all; SURVEY.md §4)."""
        ds = dataset or self.dataset
        if self._eval_step is None:
            cfg = self.cfg

            def eval_loss(params, batch):
                return wn.loss_fn(params, cfg, batch["tokens"],
                                  mel=batch.get("mel"),
                                  speaker=batch.get("speaker"))[1]

            # scalar metrics are replicated; pinning out_shardings keeps
            # GSPMD from materializing them sharded (round-2 review)
            self._eval_step = jax.jit(
                eval_loss,
                in_shardings=(self.state_shardings.params,
                              self.batch_shardings),
                out_shardings=NamedSharding(self.mesh, P()))
        it = IteratorState(seed=seed, step=0)
        sums: Dict[str, float] = {}
        with self.mesh:
            for _ in range(num_batches):
                batch, it = ds.sample_batch(it)
                m = jax.device_get(self._eval_step(self.state.params, batch))
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
        return {f"eval_{k}": v / num_batches for k, v in sums.items()}

    # ------------------------------------------------------------------
    def save(self, wait: bool = True):
        """Checkpoint the current state.  DURABLE by default: returns only
        once the checkpoint is fully committed, so any caller (including a
        fresh CheckpointManager in this or another process) can restore it
        immediately.  wait=False queues an async save — the in-loop
        checkpoint_every path uses it; restore()/latest_step() still wait
        for such saves themselves (checkpoint._wait_directory)."""
        assert self.ckpt is not None
        self.ckpt.save(
            int(jax.device_get(self.state.step)),
            self.state, self.iter_state, wait=wait)

    def restore(self, step: Optional[int] = None):
        assert self.ckpt is not None
        self.state, self.iter_state = self.ckpt.restore(
            self.state, step=step)
        return self.state
