"""The device mesh, in one process or over a ``torch.distributed`` process
group (``initialize_multihost``: a card, or a block of cards, a rank): the
catalog-sharded top-k, and training over a mesh (data-parallel and
row-sharded, dense and sparse), whose cells in one process or in one rank
may be one device repeated or several distinct devices (several cards, or
a card and the host CPU), each shard on its cell's device."""

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
    initialize_multihost,
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
    "initialize_multihost",
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
