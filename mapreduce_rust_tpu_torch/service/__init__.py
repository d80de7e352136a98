from mapreduce_rust_tpu_torch.service.server import JobService, validate_spec

__all__ = ["JobService", "validate_spec"]
