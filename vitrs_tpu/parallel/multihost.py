"""Multi-host (multi-process) setup — SURVEY.md §5.8: 'multi-host via
jax.distributed over DCN; nothing else changes'.

The same SPMD program from data_parallel.py runs unmodified across hosts once
`jax.distributed.initialize` has run: the mesh spans all processes' devices,
each host feeds its stride of the global batch (DataLoader(host_id,
num_hosts)), and checkpointing happens on process 0.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, **kw) -> None:
    """Idempotent jax.distributed bring-up.  With no arguments, relies on the
    cluster environment (JAX_COORDINATOR_ADDRESS or a cluster scheduler).
    Extra kwargs (e.g. initialization_timeout=) pass through."""
    if jax.distributed.is_initialized():
        return  # already initialized
    # NOTE: deliberately NOT jax.process_count() here — that would
    # initialize the local backend first, and jax.distributed.initialize
    # must run before any JAX computation/device query.
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id, **kw)
    except (RuntimeError, ValueError):
        if explicit:
            # the caller described a concrete cluster: silently degrading to
            # single-process would be the reference's expect/unwrap
            # anti-pattern INVERTED (SURVEY.md §5.3) — fail loudly instead
            raise
        # no cluster described and none found in the environment: a plain
        # single-process run — that's fine


def host_info() -> dict:
    return {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_primary() -> bool:
    """True on the process that should write checkpoints/logs."""
    return jax.process_index() == 0
