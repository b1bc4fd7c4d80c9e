"""The system under test, built from a configuration file: the port's
``Schema``, ``TwoTowerModel`` and index, with the benchmark's seeded
weights copied into the model's parameters. The only module of the
harness, with the kinds, that imports the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def schema(cfg: dict, logq: Optional[np.ndarray] = None, **training):
    """The port's ``Schema`` of ``cfg``: categorical features whose
    vocabularies are the ids' digits (the int-id paths never read them),
    with ``training`` as ``TrainingConfig`` fields."""
    from hm_retrieval_tpu_torch.schema import (
        Feature, ModelConfig, Schema, TrainingConfig,
    )

    features = []
    for family in ("query", "candidate"):
        for f in cfg[f"{family}_features"]:
            vocab = np.arange(1, f["rows"] + 1).astype(f"U{len(str(f['rows']))}")
            features.append(Feature(f["name"], "categorical", family,
                                    embedding_size=f["width"], vocab=vocab))
    model_config = ModelConfig(
        cfg["joint_embedding_size"], ks=list(cfg["recall_ks"]),
        query_tower_units=list(cfg["query_tower_units"]),
        candidate_tower_units=list(cfg["candidate_tower_units"]))
    tc = TrainingConfig(candidate_batch_size=cfg["candidate_batch_size"],
                        **training)
    return Schema(features, model_config, tc,
                  candidate_id_col=cfg["candidate_id"], logq=logq)


def model(sch, device):
    from hm_retrieval_tpu_torch.models import TwoTowerModel

    return TwoTowerModel.create_from_schema(sch, device=device)


@torch.no_grad()
def load_weights(mdl, weights: Dict[str, torch.Tensor]) -> None:
    """Copies each of the benchmark's leaves into the model's parameter of
    the same name; every parameter must have one."""
    params = dict(mdl.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"parameters {sorted(set(params) ^ set(weights))} "
                       "are not on both sides")
    for name, p in params.items():
        p.copy_(weights[name])


def build_index(cfg: dict, mdl, side: Dict[str, torch.Tensor], device):
    """The configuration's index over every article, built on ``device``
    from the candidate tower's embeddings of ``side`` (the catalog's
    feature columns) through ``build_from_batches``."""
    from hm_retrieval_tpu_torch import indices

    spec = dict(cfg["index"])
    cls = getattr(indices, spec.pop("class"))
    k = spec.pop("k")
    bs = cfg["candidate_batch_size"]
    host = {n: v.cpu().numpy() for n, v in side.items()}
    n = cfg["n_articles"]
    batches = ({name: col[s:s + bs] for name, col in host.items()}
               for s in range(0, n, bs))

    def embed(batch):
        return mdl.candidate_forward(
            {name: torch.from_numpy(v).to(device) for name, v in batch.items()})

    return cls.build_from_batches(k, cfg["candidate_id"], embed, batches, bs,
                                  device=device, **spec)
