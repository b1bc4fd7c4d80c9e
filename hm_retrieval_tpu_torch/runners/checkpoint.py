"""Train-state checkpoints and model export.

Counterpart of the JAX package's ``runners/checkpoint.py``. The JAX package
checkpoints with orbax, which the port does not use. Here each checkpoint is
one directory named by its step, holding the state as one uncompressed
``state.npz`` in the JAX layout of ``models/bridge.py::train_state_to_numpy``
(``utils/pytree_io.py`` keys) beside a small ``meta.json``. A checkpoint is
written under a temporary name and renamed into place with ``os.replace``,
so a partial write never counts as the latest.

``export_model`` writes the full model and each tower as plain npz trees in
the JAX layout, so either package loads the other's towers.

The mesh's states (``parallel/``) save and restore the same way: a
row-sharded table and its optimizer state are one (S*R, E) array in the
file, pad rows included (``models/bridge.py``), so a checkpoint restores
into a mesh of another shape whose tables have the same padded rows.

Over a process group ``save`` is collective: every rank calls it, a
row-sharded value is gathered from the ranks that hold its shards, rank 0
alone writes the checkpoint (one writer a file), synchronously, and a
barrier follows, so no rank can look for it before it is complete. Each rank
restores the shards it holds from the same file, so a checkpoint written by
a group restores into one process and the reverse.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.models.bridge import (
    flat_to_tree,
    params_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.parallel.collectives import barrier
from hm_retrieval_tpu_torch.parallel.mesh import process_count, process_index
from hm_retrieval_tpu_torch.utils.pytree_io import (
    load_pytree_npz,
    save_pytree_npz,
)

logger = logging.getLogger(__name__)

STATE_FILE = "state.npz"
META_FILE = "meta.json"
_TMP_PREFIX = ".tmp-"


class CheckpointManager:
    """Step-numbered checkpoints of a training state with latest-restore,
    keeping the newest ``max_to_keep``. ``device`` is where the states it
    restores into live (None: the card)."""

    def __init__(
        self, dirpath: str, max_to_keep: int = 3, device: DeviceLike = None
    ):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.device = resolve_device(device)
        self.dirpath = os.path.abspath(dirpath)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.dirpath, exist_ok=True)
        self._writer: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []

    def save(self, step: int, state) -> None:
        """Copy ``state`` to the host, then write it on a background thread.
        Returns once the copy is taken, so in-place steps after it cannot
        change the checkpoint; ``wait_until_finished``, ``restore`` and
        ``close`` wait for the write. Over a process group: collective, rank
        0 writes before it returns, then every rank meets at a barrier."""
        tree = train_state_to_numpy(state)  # host copies, not views
        meta = {"step": int(step), "state": type(state).__name__}
        if process_count() > 1:
            if process_index() == 0:
                self._write(int(step), tree, meta)
            barrier()
            return
        if self._writer is None:
            self._writer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint"
            )
        self._pending.append(
            self._writer.submit(self._write, int(step), tree, meta)
        )
        logger.info("Scheduled checkpoint step=%d -> %s", step, self.dirpath)

    def _write(self, step: int, tree: dict, meta: dict) -> None:
        tmp = os.path.join(self.dirpath, f"{_TMP_PREFIX}{step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        save_pytree_npz(tree, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        final = os.path.join(self.dirpath, str(step))
        if os.path.exists(final):
            if step not in self.all_steps():
                shutil.rmtree(tmp)
                # e.g. an orbax checkpoint of the JAX package at this step
                raise FileExistsError(
                    f"{final} exists and is not a checkpoint of this manager"
                )
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dirpath, str(old)))
        logger.info("Wrote checkpoint step=%d", step)

    def wait_until_finished(self) -> None:
        """Block until every scheduled save is on disk; a failed write
        raises here."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def all_steps(self) -> List[int]:
        """Steps of the complete checkpoints on disk, oldest first."""
        steps = []
        for name in os.listdir(self.dirpath):
            path = os.path.join(self.dirpath, name)
            if (
                name.isdigit()
                and os.path.isfile(os.path.join(path, STATE_FILE))
                and os.path.isfile(os.path.join(path, META_FILE))
            ):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, fresh_state):
        """Copy the latest checkpoint into ``fresh_state``'s tensors (a
        state of the same kind and shapes, on this manager's device) and
        return it with the checkpoint's step."""
        self.wait_until_finished()
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dirpath}")
        path = os.path.join(self.dirpath, str(step))
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        if meta["state"] != type(fresh_state).__name__:
            raise ValueError(
                f"checkpoint step={step} holds a {meta['state']}, not a "
                f"{type(fresh_state).__name__}"
            )
        want = self.device
        for v in fresh_state.params.values():
            p = v.local()[0] if hasattr(v, "shards") else v
            if p.device.type != want.type or want.index not in (
                None, p.device.index
            ):
                raise ValueError(
                    f"the state lives on {p.device}, the manager restores "
                    f"onto {want}"
                )
        tree = load_pytree_npz(os.path.join(path, STATE_FILE))
        state = train_state_from_numpy(fresh_state, tree)
        logger.info("Restored checkpoint step=%d", step)
        return state

    def close(self) -> None:
        """Wait for the writes in flight and stop the writer thread.
        Idempotent."""
        try:
            self.wait_until_finished()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None


def export_model(model: TwoTowerModel, dirpath: str, params=None) -> None:
    """Writes <dirpath>/{two_tower,query_tower,candidate_tower}/params.npz:
    ``model``'s weights, or a training state's ``params``, whose row-sharded
    tables are exported unpadded (``unpad_params``), the unsharded layout
    either package's serving loads."""
    if params is None:
        tree = params_to_numpy(model)
    else:
        from hm_retrieval_tpu_torch.parallel.sharded_sparse_training import (
            unpad_params,
        )

        tree = flat_to_tree(unpad_params(params, model))
    save_pytree_npz(tree, os.path.join(dirpath, "two_tower", "params.npz"))
    for tower in ("query_tower", "candidate_tower"):
        save_pytree_npz(tree[tower], os.path.join(dirpath, tower, "params.npz"))
    logger.info("Exported model artifacts to %s", dirpath)
