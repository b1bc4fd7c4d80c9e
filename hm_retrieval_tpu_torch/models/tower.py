"""Tower MLP: embedding front-end -> hidden Dense+ReLU stack -> joint layer.

Counterpart of ``hm_retrieval_tpu/models/tower.py``. Every layer, the last
included, is Dense + ReLU, and there is no L2 norm: scores are raw dot
products. Init: glorot-uniform weights and zero biases, uniform(+-0.05)
tables, zero attention queries, all drawn from an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s; parity tests
move weights across with ``models/bridge.py``).

Dense layers are ``nn.Linear``, whose weight is (d_out, d_in): the transpose
of the JAX package's (d_in, d_out) ``w``.

Tables, dense layers and attention queries are all trainable parameters, as
the JAX package updates all three. Serving runs the towers under
``torch.no_grad()``, so no served forward records a graph.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.models.embedding import (
    apply_embeddings,
    embedding_output_dim,
)
from hm_retrieval_tpu_torch.schema.features import Feature, FeatureKind


class Tower(nn.Module):
    def __init__(
        self,
        features: List[Feature],
        joint_embedding_size: int,
        hidden_units: Optional[List[int]] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.features = list(features)
        self.embeddings = nn.ParameterDict(
            {
                f.name: nn.Parameter(
                    torch.empty(f.num_embeddings, f.embedding_size, device=dev)
                )
                for f in self.features
                if f.kind != FeatureKind.NUMERIC
            }
        )
        dims = (
            [embedding_output_dim(self.features)]
            + list(hidden_units or [])
            + [joint_embedding_size]
        )
        self.dense = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, d_in, d_out, device=dev)
            for d_in, d_out in zip(dims[:-1], dims[1:])
        )
        self.attention = nn.ParameterDict(
            {
                f.name: nn.Parameter(torch.zeros(f.embedding_size, device=dev))
                for f in self.features
                if f.kind == FeatureKind.SEQUENCE and f.pooling == "attention"
            }
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Tables uniform(+-0.05) in feature order, then each dense layer's
        glorot-uniform weight; zero biases and attention queries. Each draw
        is made on the generator's device and copied into the parameter, so
        a CPU generator gives the same weights on every device. A table
        whose rows a row-sharded training state released
        (``parallel/sharded_training.py``) gets them back first."""
        for f in self.features:
            table = self.embeddings[f.name] if f.name in self.embeddings else None
            if table is not None and table.shape[0] != f.num_embeddings:
                table.data = table.data.new_empty(
                    (f.num_embeddings, table.shape[1]))
        for table in self.embeddings.values():
            _draw_uniform(table, 0.05, generator)
        for layer in self.dense:
            d_out, d_in = layer.weight.shape
            _draw_uniform(layer.weight, (6.0 / (d_in + d_out)) ** 0.5,
                          generator)
            layer.bias.zero_()
        for query in self.attention.values():
            query.zero_()

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        rows: Optional[Dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Feature dict of (B,) / (B, max_len) tensors -> (B, joint).
        ``rows`` optionally replaces table gathers (see
        ``apply_embeddings``)."""
        x = apply_embeddings(
            dict(self.embeddings),
            self.features,
            batch,
            dict(self.attention),
            rows=rows,
        )
        for layer in self.dense:
            x = torch.relu(layer(x))
        return x


def _draw_uniform(param: torch.Tensor, limit: float,
                  generator: torch.Generator) -> None:
    """``param`` <- uniform(-limit, limit) drawn on ``generator``'s device."""
    draw = torch.empty(param.shape, dtype=param.dtype, device=generator.device)
    param.copy_(draw.uniform_(-limit, limit, generator=generator))
