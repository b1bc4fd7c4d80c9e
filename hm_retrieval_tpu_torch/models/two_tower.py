"""Two-tower retrieval model: a query tower and a candidate tower whose
outputs are scored by dot product.

Counterpart of ``hm_retrieval_tpu/models/two_tower.py`` for serving:
``create_from_schema``, ``init_params``, ``query_forward`` and
``candidate_forward``. The in-batch softmax loss with logQ correction and the
train step belong to the training slice, which is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.models.tower import Tower
from hm_retrieval_tpu_torch.schema.features import Feature
from hm_retrieval_tpu_torch.schema.schema import Schema

Batch = Dict[str, torch.Tensor]


class TwoTowerModel(nn.Module):
    def __init__(
        self,
        query_features: List[Feature],
        candidate_features: List[Feature],
        candidate_id_col: str,
        joint_embedding_size: int,
        query_tower_units: Optional[List[int]] = None,
        candidate_tower_units: Optional[List[int]] = None,
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
            device=device,
        )

    def init_params(self, seed: int = 0) -> "TwoTowerModel":
        """Random init from one ``torch.Generator`` on the model's device,
        seeded with ``seed``: the query tower's draws, then the
        candidate tower's."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.query_tower.reset_parameters(gen)
        self.candidate_tower.reset_parameters(gen)
        return self

    def query_forward(self, batch: Batch) -> torch.Tensor:
        return self.query_tower(batch)

    def candidate_forward(self, batch: Batch) -> torch.Tensor:
        return self.candidate_tower(batch)
