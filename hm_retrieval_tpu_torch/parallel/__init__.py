"""The mesh of one process: the catalog-sharded top-k, and training over a
mesh whose devices are all one device (data-parallel and row-sharded, dense
and sparse). Several cards and processes wait for ROADMAP.md Queue 1 item
6.3; ``initialize_multihost`` raises ``NotImplementedError`` and is not
exported."""

from hm_retrieval_tpu_torch.parallel.data_parallel import (
    make_dp_train_step,
    replicate_state,
)
from hm_retrieval_tpu_torch.parallel.distributed_topk import (
    ShardedRows,
    make_distributed_quantized_topk,
    make_distributed_topk,
    shard_candidates,
    shard_candidates_quantized,
)
from hm_retrieval_tpu_torch.parallel.global_negatives import (
    make_global_negatives_loss,
)
from hm_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    make_mesh,
    replicated,
    row_sharded,
    shard_batch,
)
from hm_retrieval_tpu_torch.parallel.sharded_embedding import (
    ShardedTable,
    make_sharded_lookup,
    shard_table,
)
from hm_retrieval_tpu_torch.parallel.sharded_sparse_training import (
    create_sharded_sparse_state,
    make_sharded_sparse_train_step,
    sharded_sparse_specs,
    unpad_params,
)
from hm_retrieval_tpu_torch.parallel.sharded_training import (
    create_sharded_train_state,
    make_sharded_train_step,
    param_shardings,
)
from hm_retrieval_tpu_torch.parallel.sparse_data_parallel import (
    make_dp_sparse_train_step,
    replicate_sparse_state,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "ShardedRows",
    "ShardedTable",
    "batch_sharding",
    "create_sharded_sparse_state",
    "create_sharded_train_state",
    "make_distributed_quantized_topk",
    "make_distributed_topk",
    "make_dp_sparse_train_step",
    "make_dp_train_step",
    "make_global_negatives_loss",
    "make_mesh",
    "make_sharded_lookup",
    "make_sharded_sparse_train_step",
    "make_sharded_train_step",
    "param_shardings",
    "replicate_sparse_state",
    "replicate_state",
    "replicated",
    "row_sharded",
    "shard_batch",
    "shard_candidates",
    "shard_candidates_quantized",
    "shard_table",
    "sharded_sparse_specs",
    "unpad_params",
]
