"""Multi-process entry: the torch.distributed bootstrap of the multi-process
mesh.

The port of ``mapreduce_rust_tpu/parallel/distributed.py``. Control traffic
rides the coordinator's JSON-RPC plane (coordinator/server.py); the data of
a multi-process mesh moves through ``torch.distributed`` collectives once
every process has joined one process group: the all_to_all of the shuffle
(``dist.all_to_all_single``) and the per-round sums of its flags and
overflow counters (``dist.all_reduce``, parallel/shuffle.py).

Usage (one process per rank, the same command each):

    python -m mapreduce_rust_tpu_torch run --distributed \
        --coordinator 10.0.0.1:1234 --num-processes 4 --process-id $RANK ...

after which ``run_job`` drives ``driver._stream_multihost``: each process
feeds its own shards of the global mesh (rank r owns shards
``[r * D/N, (r+1) * D/N)``) and the all_to_all crosses processes.

The backend follows the job's device: NCCL for ``cuda``, gloo for ``cpu``.
NCCL needs a card per rank (it refuses two ranks of one communicator on
one GPU); ranks that share a card pass ``backend="gloo"``, which carries
the collectives of CUDA tensors through the host. An NCCL failure is
raised as it is, never answered with gloo.
"""

from __future__ import annotations

import logging
import time

log = logging.getLogger("mapreduce_rust_tpu_torch.distributed")


def default_backend(device: str) -> str:
    """NCCL for a job on the card (``cuda``/``auto``), gloo on the CPU."""
    return "gloo" if device == "cpu" else "nccl"


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: "str | None" = None, device: str = "cuda", **kwargs) -> None:
    """Join the process group (idempotent): ``init_process_group`` over
    ``tcp://coordinator_address`` with this world size and rank. MUST run
    before the job touches the card. ``backend=None`` takes the device's
    default (``default_backend``); extra kwargs pass through to
    ``torch.distributed.init_process_group`` (e.g. ``timeout``)."""
    import torch.distributed as dist

    from mapreduce_rust_tpu_torch.runtime.trace import trace_span

    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    t0 = time.perf_counter()
    with trace_span("distributed.initialize", coordinator=coordinator_address,
                    process_id=process_id, num_processes=num_processes):
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kwargs,
        )
    log.info(
        "joined distributed cluster %s as process %d/%d in %.2fs: backend %s",
        coordinator_address, process_id, num_processes,
        time.perf_counter() - t0, backend,
    )


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank; 0 outside a process group."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The world size; 1 outside a process group."""
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def is_federated() -> bool:
    """True when this process is one of several in a process group."""
    return process_count() > 1


def cluster_info(shards: "int | None" = None) -> dict:
    """Manifest-ready identity of this process's view of the cluster, with
    the reference's keys. The devices of the reference's mesh are its
    shards here: ``global_devices`` is the mesh's shard count (one per
    process when not given) and ``local_devices`` this process's share.
    Reads no CUDA state."""
    world = process_count()
    total = shards or world
    return {
        "process_index": process_index(),
        "process_count": world,
        "global_devices": total,
        "local_devices": total // world,
        "federated": world > 1,
    }
