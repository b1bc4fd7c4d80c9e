"""Host -> device feeding with background prefetch.

Counterpart of ``hm_retrieval_tpu/data/device_feed.py``. A bounded-queue
background thread does the host work (shard reads, shuffle, numpy batch
assembly) while the device runs the current step. Every device interaction
stays on the consumer's thread: each column is pinned and copied to the card
with ``non_blocking=True``, so the copy overlaps the running step and the
host does not wait for it. With a training ``mesh`` (``parallel/mesh.py``)
the batch goes to this process's one device of the mesh and the mesh's step
splits it over this process's data rows, where the JAX package places each
data shard's rows on its devices. In a process group each rank feeds its own
rows (its ``ShardDataset`` part, ``B / P`` rows a batch), as JAX's
``make_array_from_process_local_data`` takes them.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

Batch = Dict[str, np.ndarray]


def _put(b: Batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


def _feed(batches, dev, prefetch):
    for b in _prefetch_host(batches, prefetch):
        yield _put(b, dev)


def _target(device: DeviceLike, mesh) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    from hm_retrieval_tpu_torch.parallel.mesh import (
        canonical,
        training_device,
    )

    dev = training_device(mesh)
    if device is not None and canonical(resolve_device(device)) != dev:
        raise ValueError(f"device {device} is not the mesh's device {dev}")
    return dev


def device_feed(
    batches: Iterator[Batch],
    device: DeviceLike = None,
    prefetch: int = 2,
    mesh=None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator into device tensors with ``prefetch``
    batches of host work in flight. ``device=None`` is the card, or the
    training ``mesh``'s one device; the device is resolved here, before the
    first batch."""
    return _feed(batches, _target(device, mesh), prefetch)


def chunk_batches(batches: Iterator[Batch], k: int) -> Iterator[Batch]:
    """Stack ``k`` consecutive host batches into one ``{feature: (k, B,
    ...)}`` super-batch. A RAGGED TAIL (fewer than ``k`` trailing batches)
    IS DROPPED, as the JAX package drops it; a warning is logged so short
    epochs (< k batches, which would otherwise train zero steps) are never
    silent. Feeds ``make_chunked_train_step``."""
    if k < 1:
        raise ValueError("k must be >= 1")
    stack = []
    for b in batches:
        stack.append(b)
        if len(stack) == k:
            yield {key: np.stack([s[key] for s in stack]) for key in stack[0]}
            stack = []
    if stack:
        logger.warning(
            "chunk_batches dropped a ragged tail of %d batch(es) "
            "(< steps_per_dispatch=%d); lower steps_per_dispatch or "
            "provide a step count divisible by it to train on every "
            "batch",
            len(stack),
            k,
        )


def device_feed_chunked(
    batches: Iterator[Batch],
    k: int,
    device: DeviceLike = None,
    prefetch: int = 2,
    mesh=None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """``device_feed`` over ``chunk_batches``: device-resident ``(k, B,
    ...)`` super-batches, assembled in the prefetch thread."""
    return device_feed(chunk_batches(batches, k), device, prefetch, mesh)


def _prefetch_host(batches: Iterator[Batch], prefetch: int) -> Iterator[Batch]:
    """Run ``batches`` in a background thread, ``prefetch`` items ahead.
    An exception in the thread is raised in the consumer."""
    if prefetch <= 0:
        yield from batches
        return
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    end = object()
    err: list = []

    def worker():
        try:
            for b in batches:
                q.put(b)
        except Exception as e:  # handed to the consumer below
            err.append(e)
        finally:
            q.put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            break
        yield item
    t.join()
    if err:
        raise err[0]


def make_chunked_train_step(step_fn):
    """Wrap a ``(state, batch) -> (state, {"loss": ...})`` train step into
    ``(state, stacked) -> (state, metrics)`` that runs ``stacked``'s
    leading ``k`` steps in order. The numbers equal ``k`` calls of
    ``step_fn``; the metrics carry the per-step losses and their mean, as
    the JAX package's scanned step does."""

    def chunk_step(state, stacked: Dict[str, torch.Tensor]):
        k = next(iter(stacked.values())).shape[0]
        losses = []
        for i in range(k):
            state, metrics = step_fn(
                state, {name: v[i] for name, v in stacked.items()}
            )
            losses.append(metrics["loss"])
        losses = torch.stack(losses)
        return state, {
            "loss": losses[-1],
            "loss_mean": losses.mean(),
            "losses": losses,
        }

    return chunk_step
