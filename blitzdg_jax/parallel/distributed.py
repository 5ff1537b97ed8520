"""Multi-host initialization and host-mesh construction.

The reference has no distributed layer at all (SURVEY.md §2.9: no
MPI/NCCL/threads; METIS maps are produced but never consumed). This
design runs one Python process per host: `jax.distributed` wires the
hosts together, XLA hands collectives to NCCL (NVLink within a host, the
network across hosts), and the SAME `shard_map` programs (halo exchange,
psum-reduced Krylov, pmax dt) run unchanged — only the `Mesh` gets bigger.

Launch recipe (one command per host; identical binary everywhere):

    # host 0 (coordinator) and every other host i of n:
    python train.py --coordinator=HOST0_IP:1234 --process-id=i --n-hosts=n

    # inside train.py, before any other JAX call:
    from blitzdg_jax.parallel import distributed_init, make_global_mesh
    distributed_init(coordinator, n_hosts, process_id)
    mesh = make_global_mesh(n_scenario=..., n_element=...)

Where a cluster environment tells `jax.distributed` the topology,
`distributed_init()` with NO arguments discovers it; elsewhere pass the
coordinator address, process count and process id explicitly.
On a single host (the degenerate case, tested) it is a no-op beyond
validating the device view: every local device is visible globally and the
mesh matches the single-process mesh bit-for-bit.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def distributed_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> dict:
    """Initialize jax.distributed for multi-host execution (idempotent).

    Single-host degenerate case: called with no arguments on a machine
    that is not part of a multi-process job, it skips
    `jax.distributed.initialize` (which would try to reach a coordinator)
    and just reports the local topology — so library code can call it
    unconditionally.

    Returns a summary dict: {n_processes, process_id, n_devices_global,
    n_devices_local}.
    """
    global _initialized
    multi = coordinator_address is not None or (
        num_processes is not None and num_processes > 1
    )
    if multi and not _initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
        _initialized = True
    return {
        "n_processes": jax.process_count(),
        "process_id": jax.process_index(),
        "n_devices_global": len(jax.devices()),
        "n_devices_local": len(jax.local_devices()),
    }


def make_global_mesh(
    n_scenario: int = 1, n_element: int | None = None, devices=None
) -> Mesh:
    """(scenario, element) mesh over ALL devices of the (possibly
    multi-host) job.

    Lay the ELEMENT axis within hosts and the SCENARIO axis across hosts
    where possible: halo ppermute traffic (every RK stage) then stays on
    the host's NVLink, while the scenario axis (embarrassingly parallel,
    no per-step collectives) is the one crossing the network.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_element is None:
        n_element = n // n_scenario
    assert n_scenario * n_element == n, (n_scenario, n_element, n)
    # jax.devices() orders by process; reshaping (scenario, element) with
    # element fastest keeps element blocks within a host when
    # n_element <= devices-per-host.
    arr = np.array(devices).reshape(n_scenario, n_element)
    return Mesh(arr, axis_names=("scenario", "element"))
