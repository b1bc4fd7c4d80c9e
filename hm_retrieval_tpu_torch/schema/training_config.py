"""Training config (own copy of the JAX package's).

``models/train_path.py::make_single_device_trainer`` reads the optimizer,
its kwargs, logQ, uniform negatives, the sparse-table switch and the seed;
``Schema.load``/``save`` carry the whole config so the schema artifact
round-trips unchanged. The mesh fields wait for the distributed steps.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TrainingConfig:
    train_batch_size: int = 512
    test_batch_size: int = 2048
    # Batch size used when embedding the full candidate catalog.
    candidate_batch_size: int = 10_000
    shuffle_buffer_size: int = 100_000
    epochs: int = 1
    optimizer_name: str = "adagrad"
    optimizer_kwargs: dict = field(
        default_factory=lambda: {"learning_rate": 0.05}
    )
    use_logq_correction: bool = True
    num_uniform_negatives: int = 0
    use_sparse_embedding_optimizer: bool = True
    steps_per_dispatch: int = 1
    seed: int = 0
    mesh_data_axis: str = "data"
    global_batch_negatives: bool = True
    sharded_embedding_features: list = field(default_factory=list)

    def __post_init__(self):
        if self.train_batch_size <= 0 or self.test_batch_size <= 0:
            raise ValueError("batch sizes must be positive")
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if "learning_rate" not in self.optimizer_kwargs:
            raise ValueError("optimizer_kwargs must include learning_rate")

    def to_dict(self) -> dict:
        return {
            "train_batch_size": self.train_batch_size,
            "test_batch_size": self.test_batch_size,
            "candidate_batch_size": self.candidate_batch_size,
            "shuffle_buffer_size": self.shuffle_buffer_size,
            "epochs": self.epochs,
            "optimizer_name": self.optimizer_name,
            "optimizer_kwargs": dict(self.optimizer_kwargs),
            "use_logq_correction": self.use_logq_correction,
            "num_uniform_negatives": self.num_uniform_negatives,
            "use_sparse_embedding_optimizer": (
                self.use_sparse_embedding_optimizer
            ),
            "steps_per_dispatch": self.steps_per_dispatch,
            "seed": self.seed,
            "mesh_data_axis": self.mesh_data_axis,
            "global_batch_negatives": self.global_batch_negatives,
            "sharded_embedding_features": list(
                self.sharded_embedding_features
            ),
        }

    @classmethod
    def from_dict(cls, payload: dict) -> "TrainingConfig":
        return cls(**payload)
