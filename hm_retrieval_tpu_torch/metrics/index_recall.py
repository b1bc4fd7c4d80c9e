"""Streaming Recall@K evaluation.

Counterpart of the JAX package's ``metrics/index_recall.py`` (ref:
pkg/modelling/metrics/index_recall.py:10-85). Per batch the index returns
(B, max_k) retrieved ids; the metric compares them with the (B,) true
candidate ids by the same broadcast-equal trick, counts hits per K on the
ids' device and pulls one small vector a batch to the host. Each test row is
one (query, true-candidate) event, so this is a per-transaction hit rate.

Ids are compared as int64: the indices return int32 ids, and the shards may
hold int64 ones.

- ``valid_mask``: per-row validity instead of a leading-rows count, for
  batches whose padding is interleaved rather than trailing;
- ``cross_process=True``: processes that evaluated disjoint shards sum their
  {hits, seen} once at ``results()`` with ``torch.distributed.all_reduce``,
  when a process group of more than one rank is initialised.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _batch_hits(
    retrieved: torch.Tensor,  # (B, max_k) int ids
    true_ids: torch.Tensor,  # (B,) int ids
    row_valid: torch.Tensor,  # (B,) bool: padded rows excluded
    ks: tuple,
) -> torch.Tensor:
    """(len(ks) + 1,) int64 [hit counts per K..., valid rows]: row i hits at
    K if true_ids[i] appears in retrieved[i, :K]."""
    eq = retrieved.long() == true_ids.long()[:, None]  # (B, max_k)
    # cumulative any over the k axis: a hit within the first K columns
    cum = (torch.cumsum(eq, dim=1) > 0) & row_valid[:, None]
    counts = torch.stack([cum[:, k - 1].sum() for k in ks])
    return torch.cat([counts, row_valid.sum().reshape(1)])


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


class IndexRecall:
    """Streaming accumulator over evaluation batches
    (ref: IndexRecall, index_recall.py:10-49).

    ``cross_process``: sum {hits, seen} over every rank of the default
    process group at ``results()``, for runs where each process streamed
    only its own test shards.
    """

    def __init__(self, ks: List[int], cross_process: bool = False):
        if not ks:
            raise ValueError("ks must be non-empty")
        self.ks = tuple(sorted(int(k) for k in ks))
        self.max_k = self.ks[-1]
        self.hits = np.zeros(len(self.ks), np.int64)
        self.seen = 0
        self.cross_process = bool(cross_process)

    @torch.no_grad()
    def update(
        self,
        retrieved_ids,
        true_ids,
        num_valid=None,
        valid_mask=None,
    ) -> None:
        """``num_valid``: count only the first N rows (padded tail
        batches); ``valid_mask``: per-row (B,) bool validity (padding
        interleaved). At most one of the two; defaults to the full batch.
        Tensors or arrays; the counting runs on ``retrieved_ids``' device."""
        if num_valid is not None and valid_mask is not None:
            raise ValueError("pass num_valid or valid_mask, not both")
        retrieved = _tensor(retrieved_ids)
        dev = retrieved.device
        if retrieved.shape[1] < self.max_k:
            raise ValueError(
                f"retrieved width {retrieved.shape[1]} < max k {self.max_k}"
            )
        if valid_mask is None:
            b = retrieved.shape[0]
            n = b if num_valid is None else int(num_valid)
            valid = torch.arange(b, device=dev) < n
        else:
            valid = _tensor(valid_mask).to(dev, torch.bool)
        out = _batch_hits(retrieved, _tensor(true_ids).to(dev), valid, self.ks)
        out = out.cpu().numpy()
        self.hits += out[:-1]
        self.seen += int(out[-1])

    def _totals(self):
        hits, seen = self.hits, self.seen
        dist = torch.distributed
        if (
            self.cross_process
            and dist.is_available()
            and dist.is_initialized()
            and dist.get_world_size() > 1
        ):
            # a gloo group reduces CPU tensors, an nccl group CUDA ones
            dev = (
                torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend() == "nccl"
                else torch.device("cpu")
            )
            tot = torch.from_numpy(
                np.concatenate([hits, [seen]]).astype(np.int64)
            ).to(dev)
            dist.all_reduce(tot)
            tot = tot.cpu().numpy()
            hits, seen = tot[:-1], int(tot[-1])
        return hits, seen

    def results(self) -> Dict[int, float]:
        hits, seen = self._totals()
        if seen == 0:
            return {k: 0.0 for k in self.ks}
        return {k: float(h) / seen for k, h in zip(self.ks, hits)}

    def reset(self) -> None:
        self.hits[:] = 0
        self.seen = 0

    def log_metric(self, epoch: Optional[int], writer=None) -> Dict[int, float]:
        """Log to the logger and an optional ``MetricWriter``
        (ref: index_recall.py:61-85)."""
        res = self.results()
        for k, v in res.items():
            logger.info("Epoch %s | Recall@%d = %.4f", epoch, k, v)
            if writer is not None and epoch is not None:
                writer.add_scalar(f"recall_at_{k}", v, epoch)
        return res
