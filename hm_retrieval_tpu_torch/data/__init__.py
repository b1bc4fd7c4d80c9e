from hm_retrieval_tpu_torch.data.dataset import ShardDataset
from hm_retrieval_tpu_torch.data.device_feed import (
    chunk_batches,
    device_feed,
    device_feed_chunked,
    make_chunked_train_step,
)
from hm_retrieval_tpu_torch.data.shard_writer import MANIFEST_NAME, ShardWriter

__all__ = [
    "MANIFEST_NAME",
    "ShardDataset",
    "ShardWriter",
    "chunk_batches",
    "device_feed",
    "device_feed_chunked",
    "make_chunked_train_step",
]
