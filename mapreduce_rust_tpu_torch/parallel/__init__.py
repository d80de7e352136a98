"""Parallel tier of one process: the mesh and its all_to_all shuffle, the
halo exchange of the sequence-parallel stream, the per-shard top-k."""

from mapreduce_rust_tpu_torch.parallel.halo import make_sharded_tokenizer, shard_stream  # noqa: F401
from mapreduce_rust_tpu_torch.parallel.shuffle import (  # noqa: F401
    Mesh,
    local_batch,
    local_rows,
    make_kv_shuffle_step_fns,
    make_mesh,
    make_shuffle_step_fns,
    sharded_empty_state,
)
from mapreduce_rust_tpu_torch.parallel.topk import topk_candidates  # noqa: F401
