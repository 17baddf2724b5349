"""Multi-process launch + data plumbing for a scenario mesh across hosts.

The reference's "distribution" is five OS processes exchanging ROS topics on
one machine (SURVEY.md §2.5 P1).  Across hosts this framework runs one SPMD
program per process:

  * `initialize()` wires `jax.distributed` (coordinator address/process id
    from env or args; with no cluster environment they must be given).
  * `global_mesh()` builds the scenario mesh over *all* devices of all
    processes; each process only ever materializes its local shard.
  * `scatter_local()` wraps `jax.make_array_from_process_local_data`: every
    process contributes its local slice of the global scenario batch — the
    only cross-host traffic besides the final gather.

Tested with several CPU processes (tests/test_multihost.py); running
several GPU hosts is not something this repository has done.

Single-host single-process remains a degenerate case of the same code path,
which is how it is exercised in CI (tests/test_parallel.py) and by
`__graft_entry__.dryrun_multichip`.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cilqr_tpu.parallel.batch import BATCH_AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up jax.distributed for a multi-process run.

    No-ops for single-process runs (num_processes None or 1, and no
    coordinator address).  Arguments default from the standard env
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID).
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    npr = num_processes if num_processes is not None else _env_int("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None else _env_int("JAX_PROCESS_ID")
    if npr in (None, 1) and addr is None:
        return  # single-process
    jax.distributed.initialize(
        coordinator_address=addr, num_processes=npr, process_id=pid
    )


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def global_mesh() -> Mesh:
    """1-D scenario mesh over every device in the slice (all hosts)."""
    return Mesh(np.asarray(jax.devices()).reshape(-1), (BATCH_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BATCH_AXIS))


def scatter_local(mesh: Mesh, local_batch: np.ndarray) -> jax.Array:
    """Assemble the global scenario batch from per-process local data.

    Each process passes its own (B_local, ...) slice; the result is a global
    (B_local * n_processes, ...) array sharded over the scenario axis with
    no cross-host copy of the payload (each host keeps what it provided).
    """
    sharding = batch_sharding(mesh)
    return jax.make_array_from_process_local_data(sharding, np.asarray(local_batch))


def put_global(sharding: NamedSharding, global_array: np.ndarray) -> jax.Array:
    """Place a host-replicated global array onto a (possibly multi-process)
    batch sharding.

    Single-process: plain ``device_put``.  Multi-process: every process holds
    the identical global array (deterministic sampling from a shared key), so
    each contributes its own contiguous leading-axis block — no cross-host
    payload moves, exactly like ``scatter_local`` but sliced from replicated host
    data.  The 1-D scenario mesh orders devices process-major, so process
    ``p`` owns rows ``[p*b, (p+1)*b)``.
    """
    if jax.process_count() == 1:
        return jax.device_put(global_array, sharding)
    arr = np.asarray(global_array)
    n = jax.process_count()
    if arr.shape[0] % n:
        raise ValueError(
            f"global batch {arr.shape[0]} not divisible by process count {n}")
    b = arr.shape[0] // n
    lo = jax.process_index() * b
    return jax.make_array_from_process_local_data(sharding, arr[lo:lo + b])


def gather_metrics(metrics) -> dict:
    """Fully-replicated metric pytree -> host floats (identical on every
    process; safe to log from process 0 only)."""
    return {k: float(np.asarray(v)) for k, v in metrics._asdict().items()}
