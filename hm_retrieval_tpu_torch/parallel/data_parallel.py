"""Data-parallel dense training over a mesh.

Counterpart of ``hm_retrieval_tpu/parallel/data_parallel.py``. There GSPMD
compiles the global-shape step with the batch split over the data axis and
inserts the candidate all-gather and the gradient psum; here the step spells
them out, as the JAX package's ``shard_map`` steps do. Per data shard d
(local batch b = B/D):

    params_d = a replica of the replicated parameters on shard d's device
               (a leaf of its own)
    loss_d   = global-negative sum-CE of shard d (parallel/global_negatives)
    loss     = psum(loss_d)                   # fixed shard order
    grads_d  = d loss / d params_d            # one autograd.grad for all d
    grads    = psum(grads_d)                  # on the first device, in order
    optimizer.update_(grads)                  # once, on the one copy

The state lives once, on the mesh's first device. Shard d's replica is a
copy on its own device (``Mesh.data_device``) that autograd differentiates;
where that is the first device, as over one device repeated, the copy is
the parameters' own storage. The same step serves
``parallel/sharded_training.py``: a ``ShardedTable`` parameter's replica is
a leaf over each of its shards where the shard lives (its column's device),
its rows come through ``psum_rows``, and the optimizer runs over the shards
as parameters of their own (``expand``), each on its device with its state
beside it (``fold``).

Mixed uniform negatives are drawn once a step, from ``(base_seed, step)`` as
``make_train_step`` draws them, on the catalog's device, and every shard's
candidate tower takes a copy of the same rows; ``step(state, batch,
negatives=rows)`` takes rows drawn elsewhere.

In a process group each rank runs the shards of its own data rows on its
own rows of the batch (``split_batch``), the losses and gradients of the
others come in through ``psum`` (in shard order: every rank the same bits),
the candidates through the all-gather, and each rank updates its copy of
the replicated state, which stays bit-identical across the ranks, and the
table shards it holds.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from hm_retrieval_tpu_torch.models.two_tower import TrainState, TwoTowerModel
from hm_retrieval_tpu_torch.parallel.collectives import psum
from hm_retrieval_tpu_torch.parallel.global_negatives import step_losses
from hm_retrieval_tpu_torch.parallel.mesh import (
    replicate_pytree,
    split_batch,
    training_device,
)
from hm_retrieval_tpu_torch.parallel.sharded_embedding import (
    ShardedTable,
    psum_rows,
)

Params = Dict[str, object]


def expand(tree: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """A dict whose ``ShardedTable`` values become one entry a shard this
    process holds, ``"<name>/<s>"``; the tensors are the same objects."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, ShardedTable):
            out.update({f"{name}/{s}": t for s, t in enumerate(v.shards)
                        if t is not None})
        else:
            out[name] = v
    return out


def fold(flat: Dict[str, torch.Tensor], like: Dict[str, object]) -> Dict:
    """Inverse of ``expand``, shaped as ``like``."""
    return {
        name: v.like([flat.get(f"{name}/{s}") for s in range(len(v.shards))])
        if isinstance(v, ShardedTable) else flat[name]
        for name, v in like.items()
    }


def map_opt_state(opt_state, fn):
    """``opt_state`` (``AdagradState`` / ``AdamState``) with ``fn`` applied
    to each of its per-parameter dicts."""
    return type(opt_state)(
        *[fn(v) if isinstance(v, dict) else v for v in opt_state]
    )


def replica(params: Params, device: Optional[torch.device] = None
            ) -> Params:
    """One data shard's replica of ``params``: leaves of their own, the
    replicated tensors copied to ``device`` (the same storage where they
    are there already, or with no ``device``), a ``ShardedTable``'s shards
    each over its storage, on its own device."""
    return {
        n: p.like([None if t is None else t.detach().requires_grad_()
                   for t in p.shards])
        if isinstance(p, ShardedTable)
        else p.detach().to(device or p.device).requires_grad_()
        for n, p in params.items()
    }


def sharded_rows(model: TwoTowerModel, params: Params, batch,
                 towers=("query_tower", "candidate_tower")) -> Dict:
    """``{tower: {feature: rows}}`` of the ``ShardedTable`` features of
    ``params`` in ``towers``, each through ``psum_rows``."""
    out = {}
    for tower in towers:
        out[tower] = {}
        for f in getattr(model, tower).features:
            p = params.get(f"{tower}.embeddings.{f.name}")
            if isinstance(p, ShardedTable) and f.name in batch:
                out[tower][f.name] = psum_rows(p, batch[f.name])
    return out


def negative_draw(catalog, num_uniform_negatives: int, base_seed: int):
    """``draw(step, negatives)``: the step's uniform negatives, drawn from
    ``(base_seed, step)`` unless given; ``None`` for an in-batch step."""
    if num_uniform_negatives > 0 and catalog is None:
        raise ValueError("uniform negatives require a CandidateCatalog")
    if num_uniform_negatives <= 0:
        def in_batch(step, negatives):
            if negatives is not None:
                raise ValueError("negatives given to an in-batch step")
            return None

        return in_batch
    from hm_retrieval_tpu_torch.models.mixed_negatives import step_seed

    generator = torch.Generator(device=catalog.device)

    def draw(step, negatives):
        if negatives is None:
            generator.manual_seed(step_seed(base_seed, step))
            negatives = catalog.sample(generator, num_uniform_negatives)
        return negatives

    return draw


def make_dp_train_step(
    model: TwoTowerModel,
    optimizer,
    mesh,
    catalog=None,
    num_uniform_negatives: int = 0,
    base_seed: int = 0,
):
    """``step(state, batch, negatives=None) -> (state, {"loss": loss})``
    over ``mesh`` (module docstring), for replicated and row-sharded
    parameters alike: the state updated in place, ``batch`` this process's
    rows (the global batch in one process) or ``shard_batch``'s list.
    Optional mixed uniform negatives as in ``make_train_step``."""
    training_device(mesh)
    draw = negative_draw(catalog, num_uniform_negatives, base_seed)
    num_candidates = catalog.num_candidates if catalog is not None else None

    def step(state: TrainState, batch, negatives=None):
        shards = split_batch(batch, mesh)
        local = [d for d, b in enumerate(shards) if b is not None]
        negatives = draw(state.step, negatives)
        replicas = [None if b is None else
                    replica(state.params, mesh.data_device(d))
                    for d, b in enumerate(shards)]
        losses = step_losses(
            model, replicas, shards,
            rows=lambda d, b: sharded_rows(model, replicas[d], b),
            negatives=negatives, num_candidates=num_candidates, mesh=mesh,
        )
        loss = psum(losses, mesh)
        leaves = {d: expand(replicas[d]) for d in local}
        names = list(leaves[local[0]])
        grads = torch.autograd.grad(
            loss, [leaves[d][n] for d in local for n in names],
            allow_unused=True, materialize_grads=True,
        )
        n = len(names)
        per_shard: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(
            shards)
        for i, d in enumerate(local):
            per_shard[d] = dict(zip(names, grads[i * n:(i + 1) * n]))
        g = psum(per_shard, mesh)
        optimizer.update_(g, map_opt_state(state.opt_state, expand),
                          expand(state.params))
        return state._replace(step=state.step + 1), {"loss": loss.detach()}

    return step


def replicate_state(state: TrainState, mesh) -> TrainState:
    """The state held once a process, on its first device."""
    return replicate_pytree(state, mesh)
