"""Parallel tier: the mesh and its all_to_all shuffle (one process or
several), the halo exchange of the sequence-parallel stream, the per-shard
top-k, and the torch.distributed bootstrap of the multi-process mesh."""

from mapreduce_rust_tpu_torch.parallel.distributed import initialize, is_federated  # noqa: F401
from mapreduce_rust_tpu_torch.parallel.halo import make_sharded_tokenizer, shard_stream  # noqa: F401
from mapreduce_rust_tpu_torch.parallel.shuffle import (  # noqa: F401
    Mesh,
    local_batch,
    local_rows,
    make_kv_shuffle_step_fns,
    make_mesh,
    make_mh_shuffle_step_fns,
    make_round_fn,
    make_shuffle_step_fns,
    sharded_empty_state,
)
from mapreduce_rust_tpu_torch.parallel.topk import topk_candidates  # noqa: F401
