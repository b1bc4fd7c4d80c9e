"""Pipeline stages, as in the JAX package: ETL (``etl_runner``), the
schema build (``build_schema_runner``), shard writing
(``shard_writer_runner``), the modelling stage (``modelling_runner``,
``evaluation_runner`` and their ``build_index`` / ``evaluate``), the
popularity baseline (``baseline_modelling_runner``), the train-state
``CheckpointManager`` and ``export_model``. The first three run without
pandas."""

from hm_retrieval_tpu_torch.data.runner import shard_writer_runner
from hm_retrieval_tpu_torch.etl.runner import build_schema_runner, etl_runner
from hm_retrieval_tpu_torch.runners.baseline import baseline_modelling_runner
from hm_retrieval_tpu_torch.runners.checkpoint import (
    CheckpointManager,
    export_model,
)
from hm_retrieval_tpu_torch.runners.modelling import (
    build_index,
    evaluate,
    evaluation_runner,
    modelling_runner,
)

__all__ = [
    "CheckpointManager",
    "baseline_modelling_runner",
    "build_index",
    "build_schema_runner",
    "etl_runner",
    "evaluate",
    "evaluation_runner",
    "export_model",
    "modelling_runner",
    "shard_writer_runner",
]
