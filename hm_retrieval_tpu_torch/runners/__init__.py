"""Pipeline stages. Ported: the modelling stage (``modelling_runner``,
``evaluation_runner`` and their ``build_index`` / ``evaluate``), the
popularity baseline (``baseline_modelling_runner``), the train-state
``CheckpointManager`` and ``export_model``. The JAX package's ETL, schema
and shard stages wait for ROADMAP.md Queue 1 item 8."""

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
    "evaluate",
    "evaluation_runner",
    "export_model",
    "modelling_runner",
]
