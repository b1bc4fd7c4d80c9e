from hm_retrieval_tpu_torch.runners.checkpoint import export_model

__all__ = ["export_model"]
