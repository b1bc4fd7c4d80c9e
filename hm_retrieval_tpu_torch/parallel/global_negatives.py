"""Global-batch in-batch negatives over the data axis of a one-process mesh.

Counterpart of ``hm_retrieval_tpu/parallel/global_negatives.py`` (the
BASELINE north star: "in-batch sampled-softmax with logQ correction computed
on the global batch via cross-host all-gather of candidate embeddings"). Per
data shard d (data axis of size D, local batch b = B/D):

    q_d = query_tower(batch_d)                      # (b, E)
    c_d = candidate_tower(batch_d)                  # (b, E)
    C   = all_gather(c_d)                           # (B, E)
    ids = all_gather(ids_d)                         # (B,)
    logits_d = q_d @ C^T - logQ[ids]                # (b, B)
    row i of shard d is positive at column d*b + i
    loss_d = sum-CE over the local rows; loss = psum(loss_d)

The collectives are ``parallel/collectives.py``'s. The mesh's train steps
(``parallel/data_parallel.py``, ``sparse_data_parallel.py``,
``sharded_training.py``, ``sharded_sparse_training.py``) share
``shard_losses``; with uniform negatives (``models/mixed_negatives.py``)
shard d's logits gain its (b, M) block against the step's M sampled rows,
and the in-batch columns' correction is ``logQ + log B`` of the global B.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.parallel.collectives import all_gather, psum
from hm_retrieval_tpu_torch.parallel.mesh import DATA_AXIS, split_batch

Params = Dict[str, torch.Tensor]


def tower_forward(
    model: TwoTowerModel, tower: str, params: Params, batch, rows=None
) -> torch.Tensor:
    """``model``'s tower ``tower`` ("query_tower" / "candidate_tower") over
    ``batch``, with the tensors of ``params`` (named as in
    ``model.named_parameters()``) in place of the module's own; a
    parameter ``params`` does not name is the module's. ``rows`` replaces
    table gathers, as in ``Tower.forward``."""
    prefix = tower + "."
    own = {
        n[len(prefix):]: p
        for n, p in params.items()
        if n.startswith(prefix) and isinstance(p, torch.Tensor)
    }
    return functional_call(getattr(model, tower), own, (batch,),
                           {"rows": rows})


def shard_losses(
    model: TwoTowerModel,
    queries: Sequence[torch.Tensor],
    candidates: Sequence[torch.Tensor],
    ids: Sequence[torch.Tensor],
    negatives: Optional[Sequence[torch.Tensor]] = None,
    num_candidates: Optional[int] = None,
) -> List[torch.Tensor]:
    """Each data shard's sum-CE against the gathered candidates, in shard
    order. ``queries[d]``, ``candidates[d]``: (b, E); ``ids[d]``: (b,)
    candidate ids. ``negatives[d]``: shard d's (M, E) tower output for the
    step's uniform negatives, drawn from a catalog of ``num_candidates``."""
    all_c = all_gather(candidates)  # (B, E)
    all_ids = all_gather(ids)  # (B,)
    B = all_c.shape[0]
    corr = None
    if model.logq is not None:
        corr = model.logq[all_ids.long()]
        if negatives is not None:
            corr = corr + float(np.log(np.float32(B)))
            m = negatives[0].shape[0]
            corr_neg = float(
                np.log(np.float32(m) / np.float32(num_candidates))
            )
    losses = []
    for d, q in enumerate(queries):
        b = q.shape[0]
        logits = q @ all_c.T  # (b, B)
        if corr is not None:
            logits = logits - corr[None, :]
        if negatives is not None:
            neg = q @ negatives[d].T  # (b, M)
            if corr is not None:
                neg = neg - corr_neg
            logits = torch.cat([logits, neg], dim=1)
        # row i of shard d is positive at global column d*b + i
        cols = d * b + torch.arange(b, device=q.device)
        log_probs = torch.log_softmax(logits, dim=-1)
        rows = torch.arange(b, device=q.device)
        losses.append(-log_probs[rows, cols].sum())
    return losses


def make_global_negatives_loss(model: TwoTowerModel, mesh):
    """``loss_fn(params, batch)``: the psum of the data shards' losses,
    which equals ``model.loss`` on the same global batch. ``params`` names
    the model's parameters (``dict(model.named_parameters())``, or tensors
    standing in for them); ``batch`` is the global batch, or ``shard_batch``'s
    list. Differentiable in ``params``."""
    D = mesh.shape[DATA_AXIS]

    def loss_fn(params: Params, batch) -> torch.Tensor:
        return psum(step_losses(model, [params] * D, split_batch(batch, D)))

    return loss_fn


def step_losses(
    model: TwoTowerModel,
    replicas: Sequence[Params],
    shards: Sequence[dict],
    rows: Optional[Callable[[int, dict], dict]] = None,
    negatives: Optional[dict] = None,
    num_candidates: Optional[int] = None,
) -> List[torch.Tensor]:
    """The per-shard losses of one train step: shard d's towers over
    ``shards[d]`` with ``replicas[d]``, its copy of the replicated
    parameters, and ``rows(d, batch)`` (``{tower: {feature: rows}}``) in
    place of table gathers. With uniform ``negatives`` (one draw a step,
    shared by every shard) shard d's candidate tower also runs over them."""
    cid = model.candidate_id_col

    def towers(d, batch, names):
        r = rows(d, batch) if rows is not None else {}
        return [tower_forward(model, t, replicas[d], batch, r.get(t))
                for t in names]

    qc = [towers(d, s, ("query_tower", "candidate_tower"))
          for d, s in enumerate(shards)]
    neg = None
    if negatives is not None:
        neg = [towers(d, negatives, ("candidate_tower",))[0]
               for d in range(len(shards))]
    return shard_losses(model, [q for q, _ in qc], [c for _, c in qc],
                        [s[cid] for s in shards], neg, num_candidates)
