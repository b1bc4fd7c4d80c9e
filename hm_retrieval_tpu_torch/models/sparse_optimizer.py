"""Sparse embedding-table training: update only the rows a batch touches.

Counterpart of ``hm_retrieval_tpu/models/sparse_optimizer.py``. The step
gathers each table's rows, takes gradients with respect to those rows (never
the tables), and applies Adagrad to the touched rows alone:

    rows_f   = table_f[ids_f]                    # (B, E) / (B, L, E)
    loss     = f(dense_params, rows_*)           # towers recomputed
    g_rows   = dL/d rows_f
    g_sum    = sum of g_rows over equal ids      # duplicates summed first
    acc[u]   = acc[u] + g_sum * g_sum
    table[u] = table[u] - lr * g_sum * rsqrt(acc[u] + eps)

Rows outside the batch get no change at all, which is what dense Adagrad
gives them too (a zero gradient adds zero to the accumulator and moves the
row by zero). Dense (MLP and attention) params go through the factory's
optimizer.

Every shape is fixed by the batch, so the update never reads a value back
to the host (``torch.unique`` would: its output size lives there). The ids
are sorted; an inclusive segmented scan in log2(M) doubling steps sums each
run of equal ids in the same order on every run (``index_add_`` on the card
adds duplicates with float atomics, in an order that changes from run to
run); every position of a run then carries its run's total, so the writes
back send the same value to a row however many positions hold its id, and
the result does not depend on the order the writes land in.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.schema.features import Feature, FeatureKind
from hm_retrieval_tpu_torch.utils import tracing

Params = Dict[str, torch.Tensor]


class SparseAdagradState(NamedTuple):
    # {table parameter name: (V, E) accumulator}
    accumulators: Params


class SparseTrainState(NamedTuple):
    params: Params
    dense_opt_state: Any
    sparse_state: SparseAdagradState
    step: int


def is_table(name: str) -> bool:
    """``<tower>.embeddings.<feature>`` names an embedding table."""
    return name.split(".")[1] == "embeddings"


def split_dense_params(params: Params) -> Params:
    """Everything but the embedding tables: the dense stacks and the
    attention queries, which the factory's optimizer owns."""
    return {n: p for n, p in params.items() if not is_table(n)}


def merge_dense_params(dense_params: Params, params: Params) -> Params:
    """The full dict from a dense subset and the tables of ``params``
    (inverse of ``split_dense_params``)."""
    return {n: p if is_table(n) else dense_params[n] for n, p in params.items()}


def _table_features(model: TwoTowerModel) -> Dict[str, List[Feature]]:
    features = {
        "query_tower": model.query_tower.features,
        "candidate_tower": model.candidate_tower.features,
    }
    return {
        tower: [
            f
            for f in feats
            if f.kind in (FeatureKind.CATEGORICAL, FeatureKind.SEQUENCE)
        ]
        for tower, feats in features.items()
    }


def _table_name(tower: str, f: Feature) -> str:
    return f"{tower}.embeddings.{f.name}"


def _gather_rows(params: Params, model: TwoTowerModel, batch) -> Dict:
    """{tower: {feature: gathered rows}}, (B, E) or (B, L, E), each a leaf
    that autograd differentiates."""
    return {
        tower: {
            f.name: F.embedding(
                batch[f.name].long(), params[_table_name(tower, f)].detach()
            ).requires_grad_()
            for f in feats
        }
        for tower, feats in _table_features(model).items()
    }


def _segment_totals(sorted_ids: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(M, E): at every position, the sum of ``g`` over its run of equal
    ``sorted_ids``. An inclusive scan restricted to runs (fixed order: the
    same bits on every run), then each run's last value copied back over
    the run through a buffer with one spare row."""
    m = sorted_ids.shape[0]
    first = torch.ones(m, dtype=torch.bool, device=g.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(first, 0) - 1  # run index of each position
    d = 1
    while d < m:
        same = (seg[d:] == seg[:-d])[:, None]
        g = torch.cat([g[:d], torch.where(same, g[d:] + g[:-d], g[d:])])
        d *= 2
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    # each run's last position writes its total to the run's slot; every
    # other position writes to the spare row m, which is never read
    totals = g.new_zeros((m + 1, g.shape[1]))
    totals.index_copy_(0, torch.where(last, seg, m), g)
    return totals[seg]


@torch.no_grad()
def _sparse_adagrad_update(
    table: torch.Tensor,
    acc: torch.Tensor,
    ids: torch.Tensor,
    g_rows: torch.Tensor,
    lr: float,
    eps: float,
) -> None:
    """Dense-parity Adagrad on the touched rows, in place, on the table's
    device (``ids`` and ``g_rows`` are copied there; the accumulator lives
    beside the table).

    ``ids``: (M,) int (flattened for sequences); ``g_rows``: (M, E). An id
    below 0 is invalid and changes no row, as in the JAX package (the
    row-sharded step marks another shard's rows -1; torch would read index
    -1 as the last row). Invalid ids sort first; each repeats the write of
    the last position, the largest id's new row, or, when no id is valid,
    row 0 unchanged. With no invalid id the result is the same bits as
    without the mask."""
    ids, g_rows = ids.to(table.device), g_rows.to(table.device)
    sorted_ids, order = torch.sort(ids.long(), stable=True)
    valid = (sorted_ids >= 0)[:, None]
    target = torch.where(valid[:, 0], sorted_ids, sorted_ids[-1:].clamp_min(0))
    g_sum = torch.where(valid, _segment_totals(sorted_ids, g_rows[order]), 0.0)
    new_acc_rows = acc[target] + g_sum * g_sum
    update = lr * g_sum * torch.rsqrt(new_acc_rows + eps)
    new_rows = table[target] - update
    new_acc_rows = torch.where(valid, new_acc_rows, new_acc_rows[-1:])
    new_rows = torch.where(valid, new_rows, new_rows[-1:])
    acc.index_copy_(0, target, new_acc_rows)
    table.index_copy_(0, target, new_rows)


def create_sparse_train_state(
    model: TwoTowerModel, dense_optimizer, seed: int = 0
) -> SparseTrainState:
    """Initialise the model from ``seed``; the tables' accumulators start
    at 0.1 (Keras legacy ``initial_accumulator_value``), the dense
    optimizer's state covers everything else."""
    model.init_params(seed)
    params = dict(model.named_parameters())
    accumulators = {
        _table_name(tower, f): torch.full_like(
            params[_table_name(tower, f)].detach(), 0.1
        )
        for tower, feats in _table_features(model).items()
        for f in feats
    }
    return SparseTrainState(
        params=params,
        dense_opt_state=dense_optimizer.init(split_dense_params(params)),
        sparse_state=SparseAdagradState(accumulators),
        step=0,
    )


def make_sparse_train_step(
    model: TwoTowerModel,
    dense_optimizer,
    learning_rate: float,
    eps: float = 1e-7,
):
    """``step(state, batch) -> (state, {"loss": loss})`` with sparse
    Adagrad for every embedding table and ``dense_optimizer`` for the
    rest, updating the model's parameters in place. A step is the span
    ``train_step``, and its phases ``train_step.forward`` (gather and
    loss), ``.backward``, ``.dense_update`` and ``.sparse_update``."""
    tables = _table_features(model)

    def step(state: SparseTrainState, batch):
        with tracing.span("train_step"):
            return _step(state, batch)

    def _step(state: SparseTrainState, batch):
        params = state.params
        with tracing.span("train_step.forward"):
            rows = _gather_rows(params, model, batch)
            dense = split_dense_params(params)
            loss = model.loss(
                batch,
                query_rows=rows["query_tower"],
                candidate_rows=rows["candidate_tower"],
            )
        row_leaves = [r for feats in rows.values() for r in feats.values()]
        with tracing.span("train_step.backward"):
            grads = torch.autograd.grad(
                loss,
                list(dense.values()) + row_leaves,
                allow_unused=True,
                materialize_grads=True,
            )
        with tracing.span("train_step.dense_update"):
            dense_optimizer.update_(
                dict(zip(dense, grads[: len(dense)])),
                state.dense_opt_state,
                dense,
            )
        g_rows = iter(grads[len(dense):])  # in the order of row_leaves
        with tracing.span("train_step.sparse_update"):
            for tower, feats in tables.items():
                for f in feats:
                    name = _table_name(tower, f)
                    ids = batch[f.name].reshape(-1)
                    _sparse_adagrad_update(
                        params[name],
                        state.sparse_state.accumulators[name],
                        ids,
                        next(g_rows).reshape(ids.shape[0], -1),
                        learning_rate,
                        eps,
                    )
        return state._replace(step=state.step + 1), {"loss": loss.detach()}

    return step
