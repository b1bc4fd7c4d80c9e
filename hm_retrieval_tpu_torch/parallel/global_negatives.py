"""Global-batch in-batch negatives over the data axis of a mesh.

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

The collectives are ``parallel/collectives.py``'s. Shard d's towers,
logits and loss run on its data shard's device (``Mesh.data_device``): the
gathered candidates, their ids' logQ and the step's negatives are copied
there. In a process group each rank computes its own data shards (``None``
in the lists for the others') and the all-gather brings in the other
ranks' candidates. The mesh's train steps
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
from hm_retrieval_tpu_torch.parallel.collectives import (
    all_gather,
    broadcast,
    psum,
)
from hm_retrieval_tpu_torch.parallel.mesh import Mesh, split_batch

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
    mesh: Optional[Mesh] = None,
) -> List[Optional[torch.Tensor]]:
    """Each data shard's sum-CE against the gathered candidates, in shard
    order, on the shard's own device (its query's). ``queries[d]``,
    ``candidates[d]``: (b, E); ``ids[d]``: (b,) candidate ids; ``None`` for
    another rank's shards (``mesh`` given), whose loss is ``None`` too.
    ``negatives[d]``: shard d's (M, E) tower output for the step's uniform
    negatives, drawn from a catalog of ``num_candidates``."""
    # (B, E) gathered once, on the first consuming device, and broadcast to
    # the others, so its gradients come back summed in device order
    devices = list(dict.fromkeys(q.device for q in queries if q is not None))
    all_c = dict(zip(devices, broadcast(
        all_gather(candidates, mesh=mesh, device=devices[0]), devices)))
    corr = None
    if model.logq is not None:
        all_ids = all_gather(ids, mesh=mesh, device=model.logq.device)
        B = all_ids.shape[0]
        corr = model.logq[all_ids.long()]
        if negatives is not None:
            corr = corr + float(np.log(np.float32(B)))
            m = next(n for n in negatives if n is not None).shape[0]
            corr_neg = float(
                np.log(np.float32(m) / np.float32(num_candidates))
            )
    losses: List[Optional[torch.Tensor]] = []
    for d, q in enumerate(queries):
        if q is None:
            losses.append(None)
            continue
        b = q.shape[0]
        logits = q @ all_c[q.device].T  # (b, B)
        if corr is not None:
            logits = logits - corr.to(q.device)[None, :]
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
    standing in for them); ``batch`` is this process's batch (the global one
    in one process), or ``shard_batch``'s list. Differentiable in
    ``params``, which each data shard takes a copy of on its device; in a
    process group every rank gets the same loss."""

    def loss_fn(params: Params, batch) -> torch.Tensor:
        shards = split_batch(batch, mesh)
        homes = [None if b is None else mesh.data_device(d)
                 for d, b in enumerate(shards)]
        devices = list(dict.fromkeys(h for h in homes if h is not None))
        copies = {n: dict(zip(devices, broadcast(p, devices)))
                  for n, p in params.items()}
        replicas = [None if h is None else
                    {n: c[h] for n, c in copies.items()} for h in homes]
        return psum(step_losses(model, replicas, shards, mesh=mesh), mesh)

    return loss_fn


def step_losses(
    model: TwoTowerModel,
    replicas: Sequence[Params],
    shards: Sequence[dict],
    rows: Optional[Callable[[int, dict], dict]] = None,
    negatives: Optional[dict] = None,
    num_candidates: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> List[Optional[torch.Tensor]]:
    """The per-shard losses of one train step: shard d's towers over
    ``shards[d]`` with ``replicas[d]``, its copy of the replicated
    parameters, and ``rows(d, batch)`` (``{tower: {feature: rows}}``) in
    place of table gathers; ``None`` for another rank's shards. With uniform
    ``negatives`` (one draw a step, shared by every shard) shard d's
    candidate tower also runs over a copy of them on its device."""
    cid = model.candidate_id_col

    def towers(d, batch, names):
        r = rows(d, batch) if rows is not None else {}
        return [tower_forward(model, t, replicas[d], batch, r.get(t))
                for t in names]

    qc = [None if s is None else towers(d, s, ("query_tower",
                                               "candidate_tower"))
          for d, s in enumerate(shards)]
    neg = None
    if negatives is not None:
        neg = [None if s is None else
               towers(d, {k: v.to(s[cid].device)
                          for k, v in negatives.items()},
                      ("candidate_tower",))[0]
               for d, s in enumerate(shards)]
    return shard_losses(model, [x and x[0] for x in qc],
                        [x and x[1] for x in qc],
                        [s and s[cid] for s in shards], neg, num_candidates,
                        mesh)
