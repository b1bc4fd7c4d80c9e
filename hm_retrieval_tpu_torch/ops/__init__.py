from hm_retrieval_tpu_torch.ops.bin_topk import (
    LAUNCHES,
    bin_max2_first_round,
    bin_max2_round,
    bin_max_round,
    default_bins,
    exact_topk,
    reset_launches,
)
from hm_retrieval_tpu_torch.ops.topk import (
    merge_topk,
    topk_dot,
    topk_dot_chunked,
    topk_pair,
)

__all__ = [
    "LAUNCHES",
    "bin_max2_first_round",
    "bin_max2_round",
    "bin_max_round",
    "default_bins",
    "exact_topk",
    "merge_topk",
    "reset_launches",
    "topk_dot",
    "topk_dot_chunked",
    "topk_pair",
]
