"""Multi-host initialization + the cross-host mesh.

The reference is strictly single-GPU single-process (SURVEY.md par. 2:
no MPI/NCCL/socket code anywhere); this module is the
distribution layer it never had. Design per SURVEY.md par. 5
"Distributed communication backend":

  * `initialize()` wraps `jax.distributed.initialize` with env-var
    defaults (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID);
  * after init, `jax.devices()` is the GLOBAL device list; build the
    ("data", "sample") mesh over it with parallel.mesh.make_mesh and
    XLA compiles the collectives (NCCL between GPUs) -- there is no
    user-level transport code, by design;
  * scene geometry is replicated per host (it is small); pixels shard
    over "data", spp over "sample"; parameter gradients psum over both
    (diff/invrender.make_sharded_train_step works unchanged on a
    multi-host mesh because shard_map + psum are transport-agnostic).

Tested without a second host by a 2-process CPU loopback
(tests/test_distributed.py): two local processes, 4 virtual CPU
devices each, one global psum + a sharded gradient step over loopback
TCP.
"""

from __future__ import annotations

import os
from typing import Optional


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for multi-host rendering/training.

    Call ONCE per process, before any other jax API touches a backend.
    Pass the arguments or set COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID environment variables.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def global_mesh(n_sample: int = 1):
    """("data", "sample") mesh over ALL global devices (call after
    initialize() on every participating process)."""
    import jax

    from tinypathtracer_tpu.parallel.mesh import make_mesh

    n = len(jax.devices())
    if n % n_sample:
        raise ValueError(f"{n} global devices not divisible by "
                         f"n_sample={n_sample}")
    return make_mesh(n_data=n // n_sample, n_sample=n_sample,
                     devices=jax.devices())
