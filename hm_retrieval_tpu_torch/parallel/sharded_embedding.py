"""Row-sharded embedding tables with cross-shard lookup.

Counterpart of ``hm_retrieval_tpu/parallel/sharded_embedding.py``. Layout:
**contiguous blocks**. Shard s of S owns rows ``[s*R, (s+1)*R)`` where
``R = ceil(V/S)``; the table is zero-padded to S*R rows, and the owner of id
i is ``i // R``. A ``ShardedTable`` is the S (R, E) tensors, shard s on the
first device of the mesh's column s.

Two lookups, both differentiable, run for each data shard on its own ids:

- ``"psum"`` (default): every shard gathers the ids it owns (the others
  masked to its row 0 and zeroed), and the partial results are summed over
  the model axis in shard order. Exactly one term of each sum is not zero,
  so the result equals ``table[ids]`` bit for bit.
- ``"all_to_all"``: the ids are deduplicated (a Zipf-hot id takes one slot
  however often the batch repeats it), bucketed by owner with a static
  capacity ``min(B, R)`` (or ``capacity``), sent to their owners, gathered
  there, sent back and re-expanded. Demand above the capacity poisons the
  output with NaN in the table's dtype, never a silent truncation.

In one process every model shard of a data shard holds the same ids, so the
request plan, which JAX computes on each of them, is computed once, and the
exchange is the owner's gather of its bucket. A shard lives on its column's
device (``Mesh.model_device``) and the ids on their data shard's: each
lookup sends the ids, or an owner's bucket, to the shard's device, gathers
there, and brings the rows back to the ids' device, where they are summed
or re-expanded. Only the gathered rows cross between devices, never a
table.

In a process group (``parallel/mesh.py``) a rank holds only the shards of
its model columns (``None`` for the others). When the model axis spans
ranks, the ranks of a data row look up the same ids: each computes its
shards' partial rows (or, ``"all_to_all"``, its owners' buckets) and the
collectives (``parallel/collectives.py``) bring the others' in, summed in
shard order as in one process, so every rank of the row holds the same
bits, equal to one process's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hm_retrieval_tpu_torch.parallel.collectives import (
    all_gather,
    fill,
    psum,
)
from hm_retrieval_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    split_batch,
    split_rows,
)


def padded_rows(vocab_rows: int, num_shards: int) -> Tuple[int, int]:
    """(rows_per_shard, padded_total)."""
    r = -(-vocab_rows // num_shards)
    return r, r * num_shards


class ShardedTable:
    """A (S*R, E) table as S row shards of R rows, shard s owning rows
    ``[s*R, (s+1)*R)``; in a process group ``None`` for the shards another
    rank holds, and ``mesh`` the group's mesh."""

    def __init__(self, shards: Sequence[Optional[torch.Tensor]],
                 mesh: Optional[Mesh] = None):
        self.shards: List[Optional[torch.Tensor]] = list(shards)
        self.mesh = mesh
        if len({tuple(t.shape) for t in self.local()}) != 1:
            raise ValueError("row shards must share one shape")

    def local(self) -> List[torch.Tensor]:
        """The shards this process holds, in order."""
        return [t for t in self.shards if t is not None]

    def like(self, shards) -> "ShardedTable":
        """Another table over this one's mesh."""
        return ShardedTable(shards, self.mesh)

    def host(self) -> torch.Tensor:
        """The (S*R, E) table on the host, shard by shard from its device.
        Collective in a process group: each shard is broadcast from its
        owner, one at a time."""
        if all(t is not None for t in self.shards):
            return torch.cat([t.detach().cpu() for t in self.shards])
        from hm_retrieval_tpu_torch.parallel.collectives import (
            broadcast_from,
        )

        like = self.local()[0]
        return torch.cat([
            broadcast_from(t, like.shape, like.dtype, torch.device("cpu"),
                           self.mesh.col_owner(s))
            for s, t in enumerate(self.shards)
        ])

    @property
    def rows_per_shard(self) -> int:
        return self.local()[0].shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        """The padded table's shape, (S*R, E)."""
        return (len(self.shards) * self.rows_per_shard,
                self.local()[0].shape[1])

    def __repr__(self) -> str:
        return (f"ShardedTable({len(self.local())} of {len(self.shards)} x "
                f"{tuple(self.local()[0].shape)})")


def shard_table(table, mesh: Mesh) -> ShardedTable:
    """Pad a (V, E) table (numpy or a tensor) with zero rows to S*ceil(V/S)
    and place it row-sharded over the model axis: shard s a copy on
    ``mesh.model_device(s)``, where this process holds it."""
    if not isinstance(table, torch.Tensor):
        table = torch.from_numpy(np.ascontiguousarray(table))
    S = mesh.shape[MODEL_AXIS]
    padded = table.new_zeros((padded_rows(table.shape[0], S)[1],
                              table.shape[1]))
    padded[: table.shape[0]] = table
    return ShardedTable([
        part.to(mesh.model_device(s), copy=True) if mesh.column(s) else None
        for s, part in enumerate(split_rows(padded, S))
    ], mesh)


def _shards(table) -> List[torch.Tensor]:
    return table.shards if isinstance(table, ShardedTable) else list(table)


def psum_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids of any shape, on the ids' device, through the
    shards: each gathers the ids it owns on its own device, zeros the rest,
    and the S partial results are summed in shard order on the ids' device
    (across ranks, this data row's other shards from their owners).
    Differentiable in each local shard."""
    shards = _shards(table)
    local = [t for t in shards if t is not None]
    R = local[0].shape[0]
    flat = ids.reshape(-1).long()
    parts = []
    for s, shard in enumerate(shards):
        if shard is None:
            parts.append(None)
            continue
        local_ids = flat.to(shard.device) - s * R
        mine = (local_ids >= 0) & (local_ids < R)
        rows = F.embedding(torch.where(mine, local_ids, 0), shard)
        parts.append(torch.where(mine[:, None], rows, 0.0).to(ids.device))
    return psum(parts, getattr(table, "mesh", None), MODEL_AXIS).reshape(
        *ids.shape, local[0].shape[1])


def _unique_fixed(ids: torch.Tensor):
    """``jnp.unique(ids, size=len(ids), fill_value=-1,
    return_inverse=True)`` for ids >= 0, with fixed shapes: the sorted
    uniques, then -1s; and each id's index among the uniques."""
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = torch.cumsum(first, 0) - 1
    # every position of a run writes the same id to its rank
    uids = torch.full_like(sorted_ids, -1).scatter_(0, rank, sorted_ids)
    inv = torch.empty_like(rank).scatter_(0, order, rank)
    return uids, inv


def all_to_all_rows(table, ids: torch.Tensor, capacity: Optional[int] = None
                    ) -> torch.Tensor:
    """``table[ids]`` for (B,) ids, on the ids' device, through the
    deduplicated, bucketed exchange (module docstring); NaN in the table's
    dtype when an owner's distinct ids exceed the capacity."""
    shards = _shards(table)
    local = [t for t in shards if t is not None]
    S, R = len(shards), local[0].shape[0]
    B = ids.shape[0]
    dev = ids.device
    cap = min(B, R) if capacity is None else min(capacity, B, R)
    uids, inv = _unique_fixed(ids.long())  # fills (-1) sort last
    valid = uids >= 0
    owner = torch.where(valid, torch.div(uids, R, rounding_mode="floor"), S)
    order = torch.argsort(owner, stable=True)
    s_uids, s_owner, s_valid = uids[order], owner[order], valid[order]
    # position of each unique id within its owner's bucket
    pos = torch.arange(B, device=dev) - torch.searchsorted(s_owner, s_owner)
    fits = s_valid & (pos < cap)
    overflow = (s_valid & ~fits).any()
    # requests: bucket t of S, slot j of cap; what does not fit goes to a
    # spare slot that is never read
    slot = torch.where(fits, s_owner * cap + pos, S * cap)
    send_ids = torch.zeros(S * cap + 1, dtype=torch.long, device=dev)
    send_ids.scatter_(0, slot, torch.where(fits, s_uids - s_owner * R, 0))
    send_mask = torch.zeros(S * cap + 1, dtype=torch.bool, device=dev)
    send_mask.scatter_(0, slot, fits)
    send_ids = send_ids[: S * cap].view(S, cap)
    send_mask = send_mask[: S * cap].view(S, cap)
    # each owner gathers its bucket on its device and sends the rows back
    back = [None] * S
    for t, shard in enumerate(shards):
        if shard is None:
            continue
        mask = send_mask[t].to(shard.device)
        rows = F.embedding(
            torch.where(mask, send_ids[t].to(shard.device), 0), shard)
        back[t] = torch.where(mask[:, None], rows, 0.0).to(dev)
    if any(b is None for b in back):
        # the other owners' buckets, from the ranks of this data row
        mesh = table.mesh
        d = mesh.local_rows()[0]
        back = fill(back, mesh.cols_of, lambda t: int(mesh.ranks[d, t]))
    back = torch.stack(back).reshape(S * cap, -1)
    gathered = back[torch.where(fits, s_owner * cap + pos, 0)]
    gathered = torch.where(fits[:, None], gathered, 0.0)  # sorted order
    uout = gathered.new_zeros(gathered.shape).index_copy(0, order, gathered)
    out = uout[inv]  # back to batch order
    # the poison multiplier in the table's dtype: a float32 one would
    # promote a bf16 lookup to float32
    return out * torch.where(overflow, torch.nan, 1.0).to(out.dtype)


def make_sharded_lookup(
    mesh: Mesh, strategy: str = "psum", capacity: Optional[int] = None
):
    """Returns ``lookup(table, ids) -> (B, E)``.

    ``table``: a ``ShardedTable`` (or its S shards) over the model axis.
    ``ids``: the (B,) ids of this process's rows (the global ones in one
    process), or ``shard_batch``-style list of the D data shards' ids
    (``None`` for another rank's); data shard d looks up its own rows, the
    model axis cooperates, and the D results are gathered in order.
    ``capacity``: the ``all_to_all`` exchange's slots per owner after
    deduplication (default ``min(b, R)``, always exact); demand above it
    gives NaN."""
    if strategy not in ("psum", "all_to_all"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if capacity is not None and capacity < 1:
        raise ValueError("capacity must be >= 1")
    S = mesh.shape[MODEL_AXIS]

    def lookup(table, ids) -> torch.Tensor:
        shards = _shards(table)
        if len(shards) != S:
            raise ValueError(f"{len(shards)} table shards on a mesh of "
                             f"{S} model shards")
        if not isinstance(table, ShardedTable):
            table = ShardedTable(shards, mesh)
        parts = (ids if isinstance(ids, (list, tuple))
                 else [b and b["ids"] for b in split_batch({"ids": ids},
                                                            mesh)])
        rows = [None if p is None else
                psum_rows(table, p) if strategy == "psum"
                else all_to_all_rows(table, p, capacity)
                for p in parts]
        return all_gather(rows, mesh=mesh)

    return lookup
