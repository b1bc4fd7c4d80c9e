"""Schema aggregate: features + model config + training config + logQ table.

Own copy of the JAX package's schema artifact, read and written in the same
layout (a directory):

    schema.json   -- configs + feature metadata
    vocabs.npz    -- per-feature string vocab arrays
    logq.npy      -- dense logQ array aligned to the candidate-id vocab

Building vocabularies and logQ from dataframes is ETL and stays with the JAX
package until that stage is ported.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from hm_retrieval_tpu_torch.schema.features import Feature, FeatureFamily
from hm_retrieval_tpu_torch.schema.model_config import ModelConfig
from hm_retrieval_tpu_torch.schema.training_config import TrainingConfig

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1


@dataclass
class Schema:
    """Bundles features + configs; the cross-stage contract."""

    features: List[Feature]
    model_config: ModelConfig
    training_config: TrainingConfig
    candidate_id_col: str = "article_id"
    # Dense logQ array: logq[id] = log(P(candidate id sampled)); logq[0]=0.
    logq: Optional[np.ndarray] = field(default=None, repr=False)

    def __post_init__(self):
        names = [f.name for f in self.features]
        self._wire_shared_vocabs()
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate feature names: {dupes}")
        if self.candidate_id_col not in [
            f.name for f in self.candidate_features
        ]:
            raise ValueError(
                f"candidate_id_col {self.candidate_id_col!r} is not a "
                "candidate feature"
            )

    def _wire_shared_vocabs(self) -> None:
        """Point sequence features at their source feature's vocab."""
        by_name = {f.name: f for f in self.features}
        for f in self.features:
            if f.shared_vocab_with:
                src = by_name.get(f.shared_vocab_with)
                if src is None:
                    raise ValueError(
                        f"{f.name!r} shares vocab with unknown "
                        f"feature {f.shared_vocab_with!r}"
                    )
                if src.has_vocab:
                    f.vocab = src.vocab
                    f._token_to_id = None

    @property
    def query_features(self) -> List[Feature]:
        return [f for f in self.features if f.family == FeatureFamily.QUERY]

    @property
    def candidate_features(self) -> List[Feature]:
        return [
            f for f in self.features if f.family == FeatureFamily.CANDIDATE
        ]

    @property
    def candidate_id_feature(self) -> Feature:
        return next(
            f for f in self.features if f.name == self.candidate_id_col
        )

    def feature(self, name: str) -> Feature:
        for f in self.features:
            if f.name == name:
                return f
        raise KeyError(name)

    # ------------------------------------------------------------------
    # Serialization (JSON + npz)
    # ------------------------------------------------------------------
    def save(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        payload = {
            "version": SCHEMA_VERSION,
            "candidate_id_col": self.candidate_id_col,
            "model_config": self.model_config.to_dict(),
            "training_config": self.training_config.to_dict(),
            "features": [f.to_dict() for f in self.features],
            "has_logq": self.logq is not None,
        }
        with open(os.path.join(dirpath, "schema.json"), "w") as f:
            json.dump(payload, f, indent=2)
        vocabs = {
            f.name: f.vocab
            for f in self.features
            if f.has_vocab and not f.shared_vocab_with
        }
        np.savez_compressed(os.path.join(dirpath, "vocabs.npz"), **vocabs)
        if self.logq is not None:
            np.save(os.path.join(dirpath, "logq.npy"), self.logq)
        logger.info("Saved schema to %s", dirpath)

    @classmethod
    def load(cls, dirpath: str) -> "Schema":
        with open(os.path.join(dirpath, "schema.json")) as f:
            payload = json.load(f)
        if payload["version"] != SCHEMA_VERSION:
            raise ValueError(
                f"schema version {payload['version']} != {SCHEMA_VERSION}"
            )
        vocab_path = os.path.join(dirpath, "vocabs.npz")
        vocabs = {}
        if os.path.exists(vocab_path):
            with np.load(vocab_path, allow_pickle=False) as z:
                vocabs = {k: z[k].astype(str) for k in z.files}
        features = [
            Feature.from_dict(fd, vocab=vocabs.get(fd["name"]))
            for fd in payload["features"]
        ]
        logq = None
        if payload.get("has_logq"):
            logq = np.load(os.path.join(dirpath, "logq.npy"))
        return cls(
            features=features,
            model_config=ModelConfig.from_dict(payload["model_config"]),
            training_config=TrainingConfig.from_dict(
                payload["training_config"]
            ),
            candidate_id_col=payload["candidate_id_col"],
            logq=logq,
        )
