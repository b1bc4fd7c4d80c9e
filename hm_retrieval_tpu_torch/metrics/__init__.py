from hm_retrieval_tpu_torch.metrics.index_recall import IndexRecall

__all__ = ["IndexRecall"]
