"""Model export for serving.

Counterpart of ``export_model`` in the JAX package's
``runners/checkpoint.py``: the full model and each tower as plain npz trees
in the JAX layout, so either package loads the other's towers. The
train-state ``CheckpointManager`` is not ported yet; ``models/bridge.py``
carries a training state to and from the JAX layout.
"""

from __future__ import annotations

import logging
import os

from hm_retrieval_tpu_torch.models.bridge import params_to_numpy
from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.utils.pytree_io import save_pytree_npz

logger = logging.getLogger(__name__)


def export_model(model: TwoTowerModel, dirpath: str) -> None:
    """Writes <dirpath>/{two_tower,query_tower,candidate_tower}/params.npz."""
    tree = params_to_numpy(model)
    save_pytree_npz(tree, os.path.join(dirpath, "two_tower", "params.npz"))
    for tower in ("query_tower", "candidate_tower"):
        save_pytree_npz(tree[tower], os.path.join(dirpath, tower, "params.npz"))
    logger.info("Exported model artifacts to %s", dirpath)
