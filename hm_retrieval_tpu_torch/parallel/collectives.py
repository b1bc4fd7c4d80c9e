"""The collectives of a one-process mesh.

No file of the JAX package corresponds: there ``jax.lax.all_gather``,
``psum`` and ``axis_index`` run inside ``shard_map``, one
program a device. Here one process drives every shard of the mesh in turn,
so a shard's value is an entry of a list in axis order and each collective
is a plain tensor operation over that list:

- ``all_gather``: ``torch.cat`` of the shards in axis order. Its autograd
  transpose hands each shard the slice of the gradient that concerns it,
  summed over every consumer of the gathered tensor, as JAX's all_gather
  transposes to a reduce-scatter;
- ``psum``: a sum in fixed shard order (0, 1, ...), so the same inputs give
  the same bits on every run;
- ``axis_index``: the shards' indices along an axis, in order.

Item 6.3 of ROADMAP.md puts these over ``torch.distributed`` when the shards
are processes.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hm_retrieval_tpu_torch.parallel.mesh import Mesh


def all_gather(shards: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The shards concatenated along ``dim`` in axis order (JAX's
    ``all_gather(..., tiled=True)``)."""
    return torch.cat(list(shards), dim=dim)


def psum(values: Sequence):
    """The sum of ``values`` (tensors, or dicts of tensors with one set of
    keys) in shard order: ``((v0 + v1) + v2) + ...``."""
    values = list(values)
    if isinstance(values[0], dict):
        return {k: psum([v[k] for v in values]) for k in values[0]}
    out = values[0]
    for v in values[1:]:
        out = out + v
    return out


def axis_index(mesh: Mesh, axis: str) -> range:
    """The indices of the shards along ``axis``, in order."""
    return range(mesh.shape[axis])
