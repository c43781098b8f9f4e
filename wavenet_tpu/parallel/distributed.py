"""Multi-host process bootstrap — the communication backend
(SURVEY.md §5.8, BASELINE P4).

There is no transport layer to configure here: `jax.distributed.initialize`
bootstraps the process group from explicit arguments, after which ALL data
movement is XLA collectives (NCCL on NVIDIA GPUs) through the mesh in
parallel/mesh.py.  This module is the thin seam that makes multi-host runs
one function call and keeps single-host/dev environments untouched.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bootstrap multi-host JAX.  No-ops when single-process.

    Pass the coordinator address (e.g. "localhost:<port>"), the process
    count and this process's id, explicitly or via JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID.
    """
    env = os.environ
    coordinator_address = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in env:
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in env:
        process_id = int(env["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return          # single process (one host with N devices)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def is_primary() -> bool:
    """True on the process that should write checkpoints config/logs."""
    return jax.process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a globally-indexed batch this host should feed.

    With `jax.make_array_from_process_local_data` each host feeds its local
    shard of the data-parallel batch; the deterministic iterator
    (audio/dataset.py) makes this reproducible: every host computes the SAME
    global batch indices from (seed, step) and takes its slice."""
    n = jax.process_count()
    i = jax.process_index()
    per = global_batch // n
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return slice(i * per, (i + 1) * per)
