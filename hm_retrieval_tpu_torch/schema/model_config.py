"""Model architecture config (own copy of the JAX package's)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelConfig:
    """Two-tower architecture knobs: joint embedding size, Recall@K
    cut-offs, hidden Dense+ReLU widths per tower, index family."""

    joint_embedding_size: int
    ks: List[int] = field(default_factory=lambda: [10, 100, 1000])
    query_tower_units: Optional[List[int]] = None
    candidate_tower_units: Optional[List[int]] = None
    index_type: str = "brute_force"

    def __post_init__(self):
        if self.joint_embedding_size <= 0:
            raise ValueError("joint_embedding_size must be positive")
        if not self.ks or any(k <= 0 for k in self.ks):
            raise ValueError("ks must be a non-empty list of positive ints")
        self.ks = sorted(int(k) for k in self.ks)
        if self.index_type not in ("brute_force", "quantized"):
            raise ValueError(
                f"unknown index_type {self.index_type!r} "
                "(expected 'brute_force' or 'quantized')"
            )

    def to_dict(self) -> dict:
        return {
            "joint_embedding_size": self.joint_embedding_size,
            "ks": list(self.ks),
            "query_tower_units": self.query_tower_units,
            "candidate_tower_units": self.candidate_tower_units,
            "index_type": self.index_type,
        }

    @classmethod
    def from_dict(cls, payload: dict) -> "ModelConfig":
        return cls(**payload)
