"""logQ sampled-softmax correction as a dense table gather.

Counterpart of ``hm_retrieval_tpu/models/logq_correction.py``. The schema
precomputes ``logq[id] = log(P(id))`` with ``logq[0] = 0`` for OOV, so the
correction is one gather and a broadcast subtract over the query rows:

    logits[i, j] -= logq[candidate_ids[j]]
"""

from __future__ import annotations

import torch


def apply_logq_correction(
    logits: torch.Tensor,  # (Q, C)
    candidate_ids: torch.Tensor,  # (C,) int: ids of the column candidates
    logq_table: torch.Tensor,  # (V+1,) float32, [0] == 0.0
) -> torch.Tensor:
    return logits - logq_table[candidate_ids.long()][None, :]
