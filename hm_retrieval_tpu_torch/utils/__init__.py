from hm_retrieval_tpu_torch.utils.settings import Settings

__all__ = ["Settings"]
