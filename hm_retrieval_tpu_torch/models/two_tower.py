"""Two-tower retrieval model: a query tower and a candidate tower whose
outputs are scored by dot product, and its single-device train step.

Counterpart of ``hm_retrieval_tpu/models/two_tower.py``::

    logits = Q @ C^T                      (fp32)
    logits -= logQ[candidate_ids]         (when the model carries logQ)
    loss   = -sum_i log_softmax(logits)[i, i]   (SUM-reduced in-batch CE)

The train step (``make_train_step``) takes gradients with
``torch.autograd.grad`` and updates the model's parameters in place through
a hand-written optimizer (``models/optimizer_factory.py``). It never reads a
value back to the host: the loss stays a device tensor, and the step
counter lives on the host. The sparse-table step is
``models/sparse_optimizer.py``; ``models/train_path.py`` picks between them
as the JAX runner does.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.models.logq_correction import (
    apply_logq_correction,
)
from hm_retrieval_tpu_torch.models.tower import Tower
from hm_retrieval_tpu_torch.schema.features import Feature
from hm_retrieval_tpu_torch.schema.schema import Schema

Batch = Dict[str, torch.Tensor]
Params = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    """``params`` are the model's own parameters by module name
    (``query_tower.dense.0.weight``, ...), updated in place by each step;
    ``opt_state`` mirrors optax's state over the same names; ``step`` is
    the number of steps taken, counted on the host."""

    params: Params
    opt_state: Any
    step: int


class TwoTowerModel(nn.Module):
    def __init__(
        self,
        query_features: List[Feature],
        candidate_features: List[Feature],
        candidate_id_col: str,
        joint_embedding_size: int,
        query_tower_units: Optional[List[int]] = None,
        candidate_tower_units: Optional[List[int]] = None,
        logq: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        if candidate_id_col not in [f.name for f in candidate_features]:
            raise ValueError(
                f"candidate_id_col {candidate_id_col!r} not a candidate "
                "feature"
            )
        self.device = resolve_device(device)
        self.candidate_id_col = candidate_id_col
        self.joint_embedding_size = joint_embedding_size
        self.query_tower = Tower(
            query_features,
            joint_embedding_size,
            query_tower_units,
            self.device,
        )
        self.candidate_tower = Tower(
            candidate_features,
            joint_embedding_size,
            candidate_tower_units,
            self.device,
        )
        # dense logQ table (V+1,), logq[0] = 0, or None
        self.register_buffer(
            "logq",
            None
            if logq is None
            else torch.as_tensor(np.asarray(logq, np.float32)).to(self.device),
        )

    @classmethod
    def create_from_schema(
        cls, schema: Schema, device: DeviceLike = None
    ) -> "TwoTowerModel":
        cfg = schema.model_config
        return cls(
            query_features=schema.query_features,
            candidate_features=schema.candidate_features,
            candidate_id_col=schema.candidate_id_col,
            joint_embedding_size=cfg.joint_embedding_size,
            query_tower_units=cfg.query_tower_units,
            candidate_tower_units=cfg.candidate_tower_units,
            logq=(
                schema.logq
                if schema.training_config.use_logq_correction
                else None
            ),
            device=device,
        )

    def init_params(self, seed: int = 0) -> "TwoTowerModel":
        """Random init from one CPU ``torch.Generator`` seeded with
        ``seed``: the query tower's draws, then the candidate tower's, each
        copied to the model's device. One seed gives the same weights on the
        card as on the CPU."""
        gen = torch.Generator().manual_seed(seed)
        self.query_tower.reset_parameters(gen)
        self.candidate_tower.reset_parameters(gen)
        return self

    def query_forward(self, batch: Batch, rows=None) -> torch.Tensor:
        return self.query_tower(batch, rows=rows)

    def candidate_forward(self, batch: Batch, rows=None) -> torch.Tensor:
        return self.candidate_tower(batch, rows=rows)

    def scores(
        self, batch: Batch, query_rows=None, candidate_rows=None
    ) -> torch.Tensor:
        """(B, B) fp32 dot-product score matrix."""
        q = self.query_forward(batch, rows=query_rows)
        c = self.candidate_forward(batch, rows=candidate_rows)
        return q @ c.T

    def loss(
        self, batch: Batch, query_rows=None, candidate_rows=None
    ) -> torch.Tensor:
        """In-batch sampled-softmax CE, SUM-reduced over the batch: with
        identity labels, sum_i (logsumexp(row_i) - logits[i, i]).
        ``*_rows`` optionally replace table gathers (the sparse path)."""
        logits = self.scores(
            batch, query_rows=query_rows, candidate_rows=candidate_rows
        )
        if self.logq is not None:
            logits = apply_logq_correction(
                logits, batch[self.candidate_id_col], self.logq
            )
        return -torch.log_softmax(logits, dim=-1).diagonal().sum()


def create_train_state(
    model: TwoTowerModel, optimizer, seed: int = 0
) -> TrainState:
    """Initialise the model's parameters from ``seed`` and the optimizer's
    state over all of them."""
    model.init_params(seed)
    params = dict(model.named_parameters())
    return TrainState(params, optimizer.init(params), 0)


def make_train_step(
    model: TwoTowerModel,
    optimizer,
    catalog=None,
    num_uniform_negatives: int = 0,
    base_seed: int = 0,
):
    """``step(state, batch) -> (state, {"loss": loss})``: one dense step
    over every parameter. The returned state holds the same (updated)
    tensors and ``step + 1``.

    With ``catalog`` and ``num_uniform_negatives > 0`` the loss mixes
    uniformly sampled catalog rows into the in-batch softmax
    (``models/mixed_negatives.py``). Each step's rows are drawn from a
    ``torch.Generator`` seeded on the host from ``(base_seed, step)``, so
    a resumed run replays the same stream; ``step(state, batch,
    negatives=rows)`` takes rows drawn elsewhere instead."""
    if num_uniform_negatives > 0 and catalog is None:
        raise ValueError("uniform negatives require a CandidateCatalog")

    if num_uniform_negatives > 0:
        from hm_retrieval_tpu_torch.models.mixed_negatives import (
            mixed_negatives_loss,
            step_seed,
        )

        generator = torch.Generator(device=catalog.device)

        def loss_fn(batch, step, negatives):
            if negatives is None:
                generator.manual_seed(step_seed(base_seed, step))
            return mixed_negatives_loss(
                model,
                batch,
                catalog,
                generator,
                num_uniform_negatives,
                negatives=negatives,
            )

    else:

        def loss_fn(batch, step, negatives):
            if negatives is not None:
                raise ValueError("negatives given to an in-batch step")
            return model.loss(batch)

    def step(state: TrainState, batch: Batch, negatives=None):
        names = list(state.params)
        loss = loss_fn(batch, state.step, negatives)
        grads = torch.autograd.grad(
            loss,
            [state.params[n] for n in names],
            allow_unused=True,
            materialize_grads=True,
        )
        optimizer.update_(
            dict(zip(names, grads)), state.opt_state, state.params
        )
        return state._replace(step=state.step + 1), {"loss": loss.detach()}

    return step
