"""Worker runtime: pull-based task loop, map/reduce engines, spill files."""

from mapreduce_rust_tpu_torch.worker.runtime import Worker  # noqa: F401
