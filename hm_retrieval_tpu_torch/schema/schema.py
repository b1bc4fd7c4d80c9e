"""Schema aggregate: features + model config + training config + logQ table.

Own copy of the JAX package's schema artifact, read and written in the same
layout (a directory):

    schema.json   -- configs + feature metadata
    vocabs.npz    -- per-feature string vocab arrays
    logq.npy      -- dense logQ array aligned to the candidate-id vocab

Vocabularies, statistics and the logQ table are built from the port's tables
(``etl/transformations.py``: a dict of numpy columns) with numpy, as the JAX
package builds them from a DataFrame.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from hm_retrieval_tpu_torch.schema.features import (
    Feature,
    FeatureFamily,
    FeatureKind,
    value_counts,
)
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
    # Vocab + logQ building (ref: schema.py:43-55, etl/runner.py:75-78)
    # ------------------------------------------------------------------
    def build_features_from_dataframe(self, table) -> None:
        """Build every missing categorical vocab, standalone sequence vocab
        (from the tokens of every row's list) and standardization stats from
        the (train) table, then share vocabs (ref:
        pkg/schema/schema.py:43-55)."""
        for f in self.features:
            if f.kind == FeatureKind.CATEGORICAL and not f.has_vocab:
                f.build_vocab_from_dataframe(table)
                logger.info("Feature %s vocab size %d", f.name, len(f.vocab))
            elif (f.kind == FeatureKind.SEQUENCE and not f.has_vocab
                  and not f.shared_vocab_with):
                tokens, _ = value_counts(table[f.name].flat_tokens())
                if f.max_vocab_size is not None:
                    tokens = tokens[: f.max_vocab_size]
                f.vocab = tokens
                f._token_to_id = None
            elif f.kind == FeatureKind.NUMERIC and f.standardize:
                f.build_stats_from_dataframe(table)
                logger.info("Feature %s stats mean=%.4f std=%.4f", f.name,
                            f.mean, f.std)
        self._wire_shared_vocabs()

    def build_logq_from_dataframe(self, table) -> None:
        """Candidate sampling probs = count / rows over the TRAIN split only
        (ref: pkg/etl/runner.py:75-78), as a dense log table aligned to the
        candidate-id vocab; ids absent from train get log(1) = 0."""
        cid = self.candidate_id_feature
        if not cid.has_vocab:
            raise ValueError("candidate id vocab must be built before logQ")
        col = table[self.candidate_id_col]
        self.build_logq_from_value_counts(value_counts(col), len(col))

    def build_logq_from_value_counts(self, counts, total_rows: int) -> None:
        """The same table from precomputed ``(tokens, counts)`` of the
        candidate ids (the streaming schema stage accumulates them a batch
        at a time)."""
        cid = self.candidate_id_feature
        if not cid.has_vocab:
            raise ValueError("candidate id vocab must be built before logQ")
        tokens, n = counts
        probs = dict(zip(np.asarray(tokens, dtype=str).tolist(),
                         (np.asarray(n) / total_rows).tolist()))
        table = np.zeros(cid.num_embeddings, dtype=np.float32)
        # vocab token i -> id i+1
        tok_probs = np.array([probs.get(t, np.nan) for t in cid.vocab.tolist()],
                             dtype=np.float64)
        present = ~np.isnan(tok_probs)
        table[1:][present] = np.log(tok_probs[present]).astype(np.float32)
        self.logq = table

    def set_candidate_probs(self, probs: Dict[str, float]) -> None:
        """Explicit candidate-id -> prob mapping (the reference's
        ``candidate_prob_lookup`` dict, training_config.py:39)."""
        cid = self.candidate_id_feature
        table = np.zeros(cid.num_embeddings, dtype=np.float32)
        for tok, p in probs.items():
            ids = cid.encode(np.array([tok]))
            if ids[0] != 0:
                table[ids[0]] = np.log(p)
        self.logq = table

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
