"""Multi-host (multi-process) distribution — chains over DCN.

The replacement for the reference's IPython.parallel client/hub/
engine topology (SURVEY.md §5 "Distributed communication backend"): every
host runs the SAME program, ``jax.distributed`` stitches the processes into
one global device set, and chain parallelism shards over the *global* 1-D
mesh — chains are independent, so the only DCN traffic is the final
all-gather of the sample stacks back to every host.

Usage on each host (flags or env: COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID):

    from theano_pyglm_tpu.parallel import distributed as dist
    dist.initialize(coordinator_address, num_processes, process_id)
    mesh = dist.global_chain_mesh()
    samples, diag, _ = gibbs_sample_chains(pop, data, key, n_chains=C,
                                           mesh=mesh, ...)
    # samples already hold the FULL (n, C, ...) stacks on every host: the
    # chains driver all-gathers globally-sharded arrays as it streams them
    # to numpy (parallel/chains._to_host). No further gather is needed.

Single-process (the common case, and this repo's CI) is a no-op:
``initialize`` returns False and ``global_chain_mesh`` equals the local
``chain_mesh``. The multi-process path is exercised by
tests/test_distributed.py, which launches real coordinator+worker processes
on localhost over the CPU backend (SURVEY.md §4 "multi-chip without
hardware").
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize", "is_distributed", "global_chain_mesh", "allgather_samples"]

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Wire this process into a multi-host run. Arguments default to the
    standard env vars (JAX_COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID).
    Returns True iff a multi-process runtime was initialized (False for the
    single-process fast path). Must be called before any other JAX API
    touches the backend."""
    global _initialized
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def is_distributed() -> bool:
    return _initialized or jax.process_count() > 1


def global_chain_mesh(n_devices: Optional[int] = None):
    """1-D 'chains' mesh over the GLOBAL device set (all hosts). Falls back
    to exactly the local chain_mesh in a single-process run."""
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return jax.make_mesh(
        (len(devs),), ("chains",), devices=devs,
        axis_types=(jax.sharding.AxisType.Auto,),
    )


def allgather_samples(samples: dict) -> dict:
    """Identity — kept for API compatibility.

    The chains driver (``gibbs_sample_chains``) already all-gathers
    globally-sharded sample stacks as it streams them to host numpy
    (``parallel/chains._to_host`` uses ``process_allgather(tiled=True)``),
    so every host's ``samples`` hold the complete (n_samples, n_chains, ...)
    stacks. Gathering again here would duplicate every chain P times —
    (n, P·C, ...) with identical chain blocks — silently inflating
    downstream ESS and corrupting R̂. This function therefore returns its
    input unchanged."""
    return samples
