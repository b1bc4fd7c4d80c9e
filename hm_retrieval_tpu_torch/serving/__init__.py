from hm_retrieval_tpu_torch.serving.service import RetrievalService

__all__ = ["RetrievalService"]
