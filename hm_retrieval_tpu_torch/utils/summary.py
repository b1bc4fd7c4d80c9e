"""Host-side metric writing: TensorBoard scalars + structured logging.

Counterpart of the JAX package's ``utils/summary.py``: an
add_scalar / add_histogram / flush / close facade over tensorboardX, which
logs only when tensorboardX is absent (it is not a dependency of the port,
and a machine without it still trains and evaluates).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

try:
    from tensorboardX import SummaryWriter as _TBWriter

    _HAVE_TB = True
except ImportError:  # pragma: no cover - depends on the installation
    _HAVE_TB = False


class MetricWriter:
    """add_scalar/flush/close facade over tensorboardX."""

    def __init__(self, logdir: Optional[str], run_name: Optional[str] = None):
        self._writer = None
        if logdir is None:
            return
        if not _HAVE_TB:
            logger.info(
                "tensorboardX is not installed; metrics go to the log only"
            )
            return
        run = run_name or time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(logdir, run)
        os.makedirs(path, exist_ok=True)
        self._writer = _TBWriter(logdir=path)
        logger.info("TensorBoard metrics -> %s", path)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        """Weight histograms (the reference's Keras TensorBoard
        ``histogram_freq=1``, ref: pkg/modelling/runner.py:63-67)."""
        if self._writer is not None:
            self._writer.add_histogram(tag, np.asarray(values).ravel(), step)

    def add_params_histograms(self, model, step: int, params=None) -> None:
        """One histogram per weight of ``model`` (or of a training state's
        ``params``, row-sharded tables unpadded), tagged by its path in the
        JAX layout (``params/query_tower/dense/0/w``). Copies the weights to
        the host only when a writer is open."""
        if self._writer is None:
            return
        from hm_retrieval_tpu_torch.models.bridge import (
            flat_to_tree,
            params_to_numpy,
        )

        def walk(node, path):
            if isinstance(node, dict):
                for key, sub in node.items():
                    walk(sub, f"{path}/{key}")
            elif isinstance(node, list):
                for i, sub in enumerate(node):
                    walk(sub, f"{path}/{i}")
            else:
                self.add_histogram(path, node, step)

        if params is None:
            tree = params_to_numpy(model)
        else:
            from hm_retrieval_tpu_torch.parallel.sharded_sparse_training import (
                unpad_params,
            )

            tree = flat_to_tree(unpad_params(params, model))
        walk(tree, "params")

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
