"""Control plane: scheduler, lease failure detector, JSON-RPC server."""

from mapreduce_rust_tpu_torch.coordinator.server import (  # noqa: F401
    DONE,
    NOT_READY,
    WAIT,
    Coordinator,
    CoordinatorClient,
)
