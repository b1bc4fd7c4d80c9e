"""The mesh of one process and the catalog-sharded top-k. Training over a
mesh and multi-process layouts wait for ROADMAP.md Queue 1 item 6.2."""

from hm_retrieval_tpu_torch.parallel.distributed_topk import (
    ShardedRows,
    make_distributed_quantized_topk,
    make_distributed_topk,
    shard_candidates,
    shard_candidates_quantized,
)
from hm_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "ShardedRows",
    "make_distributed_quantized_topk",
    "make_distributed_topk",
    "make_mesh",
    "shard_candidates",
    "shard_candidates_quantized",
]
