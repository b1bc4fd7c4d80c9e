"""The collectives of a mesh, in one process or over a process group.

No file of the JAX package corresponds: there ``jax.lax.all_gather``,
``psum`` and ``axis_index`` run inside ``shard_map``, one program a device.
Here a per-shard value is a list in axis order. In one process every entry
is present and each collective is a plain tensor operation over the list:

- ``all_gather``: ``torch.cat`` of the shards in axis order. Its autograd
  transpose hands each shard the slice of the gradient that concerns it,
  summed over every consumer of the gathered tensor, as JAX's all_gather
  transposes to a reduce-scatter;
- ``psum``: a sum in fixed shard order (0, 1, ...), so the same inputs give
  the same bits on every run;
- ``axis_index``: the indices of this process's shards along an axis.

In a ``torch.distributed`` group (``parallel/mesh.py``) each rank passes the
list with its **local** shards and ``None`` for the others, and gets the
global result:

- the missing entries are exchanged (``fill``): every rank sends its local
  entries in one all-gather, and each missing entry is taken from its owner
  (the lowest rank holding it: the ranks of a data row hold the same bits);
- ``psum`` is that exchange, then the same left-to-right sum in global
  shard order as the one-process ``psum``, over the local tensors as they
  are and the others' values. So every rank holds the same bits, equal to
  the one-process ``psum`` of the same values bit for bit; a sum of per-rank
  partial sums would change the association. Its autograd is the
  one-process one: each local shard's gradient is the output's;
- ``all_gather`` across ranks is a ``torch.autograd.Function``. Its backward
  all-gathers every rank's gradient of the gathered tensor, sums, in rank
  order, those of one rank of each data row (the row's ranks run the same
  consumers), and hands each local shard its slice: the reduce-scatter of
  JAX's transpose. Every rank runs forward and backward in the same order,
  so the collectives pair up.

A rank exchanges the bytes of its tensors, in pieces of at most ``CHUNK``.
Over ``gloo`` it sends and receives host copies, by the backend's rule (the
pattern of ``metrics/index_recall.py``); over ``nccl`` the tensors stay on
the card. Every rank must pass tensors of one shape and dtype an entry.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from hm_retrieval_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

CHUNK = 1 << 28  # bytes a rank sends in one all-gather
_ALIGN = 16  # each tensor's bytes start at a multiple of this


def _dist():
    return torch.distributed


def _wire_device(like: torch.device) -> torch.device:
    """Where a tensor travels: the card under nccl, the host under gloo."""
    if _dist().get_backend() == "nccl":
        return like
    return torch.device("cpu")


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _leaves(value) -> List[torch.Tensor]:
    if isinstance(value, dict):
        return [value[k] for k in sorted(value)]
    return [value]


def _rebuild(like, leaves: List[torch.Tensor]):
    if isinstance(like, dict):
        return dict(zip(sorted(like), leaves))
    return leaves[0]


def exchange_bytes(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every rank passes tensors of the same count, shapes and dtypes; each
    gets every rank's, in rank order, on the first tensor's device (its own
    as they are, detached)."""
    dist = _dist()
    P = dist.get_world_size()
    tensors = [t.detach() for t in tensors]
    dev = tensors[0].device
    wire_dev = _wire_device(dev)
    sizes = [t.numel() * t.element_size() for t in tensors]
    total = sum(_padded(n) for n in sizes)
    send = torch.zeros(total, dtype=torch.uint8, device=wire_dev)
    off = 0
    for t, n in zip(tensors, sizes):
        send[off:off + n] = t.contiguous().reshape(-1).view(torch.uint8).to(
            wire_dev)
        off += _padded(n)
    recv = [torch.empty_like(send) for _ in range(P)]
    for lo in range(0, total, CHUNK):
        hi = min(total, lo + CHUNK)
        dist.all_gather([r[lo:hi] for r in recv], send[lo:hi])
    me = dist.get_rank()
    out = []
    for r, buf in enumerate(recv):
        if r == me:
            out.append(list(tensors))
            continue
        got, off = [], 0
        for t, n in zip(tensors, sizes):
            got.append(buf[off:off + n].view(t.dtype).reshape(t.shape).to(dev))
            off += _padded(n)
        out.append(got)
    return out


def fill(values: Sequence, keys_of: Callable[[int], List[int]],
         source: Callable[[int], int]) -> list:
    """``values`` (tensors, or dicts of tensors with one set of keys) by
    global index, ``None`` where this rank lacks the entry, with every entry
    present: a rank ``r`` holds the indices ``keys_of(r)`` and missing index
    i comes from rank ``source(i)``. A list without ``None`` is returned as
    it is, with no collective."""
    values = list(values)
    if all(v is not None for v in values):
        return values
    dist = _dist()
    me = dist.get_rank()
    mine = keys_of(me)
    like = values[mine[0]]
    leaves = [t for i in mine for t in _leaves(values[i])]
    per_rank = exchange_bytes(leaves)
    width = len(_leaves(like))
    for i, v in enumerate(values):
        if v is not None:
            continue
        src = source(i)
        pos = keys_of(src).index(i)
        got = per_rank[src][pos * width:(pos + 1) * width]
        values[i] = _rebuild(like, got)
    return values


def _data_fill(values: Sequence, mesh: Optional[Mesh]) -> list:
    """Over the data axis: row d from the rank of row d that holds this
    rank's first model column, whose values (a row-sharded table's
    gradients among them) have this rank's layout."""
    if all(v is not None for v in values):
        return list(values)
    if mesh is None:
        raise ValueError("another rank's shards need the mesh")
    col = mesh.local_cols()[0]
    return fill(values, mesh.rows_of, lambda d: int(mesh.ranks[d, col]))


class _GroupAllGather(torch.autograd.Function):
    """The data axis' all-gather across ranks, with its reduce-scatter."""

    @staticmethod
    def forward(ctx, mesh: Mesh, dim: int, present: List[int], *local):
        values: List[Optional[torch.Tensor]] = [None] * mesh.shape[DATA_AXIS]
        for d, t in zip(present, local):
            values[d] = t.detach()
        full = _data_fill(values, mesh)
        ctx.mesh, ctx.dim, ctx.present = mesh, dim, present
        ctx.sizes = [t.shape[dim] for t in full]
        return torch.cat(full, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        per_rank = exchange_bytes([grad.contiguous()])
        # one rank a data row: the row's ranks ran the same consumers
        leaders = sorted({mesh.row_owner(d)
                          for d in range(mesh.shape[DATA_AXIS])})
        total = per_rank[leaders[0]][0]
        for r in leaders[1:]:
            total = total + per_rank[r][0]
        parts = torch.split(total, ctx.sizes, dim=ctx.dim)
        return (None, None, None) + tuple(parts[d] for d in ctx.present)


def all_gather(shards: Sequence[Optional[torch.Tensor]], dim: int = 0,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The data axis' shards concatenated along ``dim`` in axis order
    (JAX's ``all_gather(..., tiled=True)``); across ranks, ``None`` for
    another rank's shards (``mesh`` required), differentiable."""
    shards = list(shards)
    if all(t is not None for t in shards):
        return torch.cat(shards, dim=dim)
    present = [d for d, t in enumerate(shards) if t is not None]
    local = [shards[d] for d in present]
    if not any(t.requires_grad for t in local):
        return torch.cat(_data_fill(shards, mesh), dim=dim)
    return _GroupAllGather.apply(mesh, dim, present, *local)


def _ordered_sum(values: Sequence):
    if isinstance(values[0], dict):
        return {k: _ordered_sum([v[k] for v in values]) for k in values[0]}
    out = values[0]
    for v in values[1:]:
        out = out + v
    return out


def psum(values: Sequence, mesh: Optional[Mesh] = None,
         axis: str = DATA_AXIS):
    """The sum of ``values`` (tensors, or dicts of tensors with one set of
    keys) in shard order: ``((v0 + v1) + v2) + ...``. Across ranks, ``None``
    for another rank's shards: over the data axis, each row's value from
    its owner; over the model axis, column s of this rank's data row from
    the rank owning that cell."""
    values = list(values)
    if any(v is None for v in values):
        if axis == DATA_AXIS:
            values = _data_fill(values, mesh)
        else:
            d = mesh.local_rows()[0]
            values = fill(values, mesh.cols_of,
                          lambda s: int(mesh.ranks[d, s]))
    return _ordered_sum(values)


def axis_index(mesh: Mesh, axis: str) -> List[int]:
    """The indices of this process's shards along ``axis``, in order (every
    index in one process)."""
    return mesh.local_rows() if axis == DATA_AXIS else mesh.local_cols()


def broadcast_from(t: Optional[torch.Tensor], shape, dtype,
                   device: torch.device, src: int) -> torch.Tensor:
    """Rank ``src``'s tensor on every rank (``t`` there, ``None``
    elsewhere), on ``device``: one copy on the wire."""
    dist = _dist()
    wire_dev = _wire_device(device)
    if dist.get_rank() == src:
        buf = t.detach().contiguous().to(wire_dev)
    else:
        buf = torch.empty(tuple(shape), dtype=dtype, device=wire_dev)
    dist.broadcast(buf, src=src)
    return buf.to(device)


def gather_processes(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape and dtype on every rank) concatenated
    along dim 0 in rank order, on every rank."""
    if _dist().get_world_size() == 1:
        return t
    return torch.cat([x[0] for x in exchange_bytes([t])])


def reduce_int(n: int, op: str) -> int:
    """``n`` reduced over the default group: ``"max"`` or ``"min"`` of an
    int64, exact (``n`` itself without a group)."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()) or (
        dist.get_world_size() == 1
    ):
        return int(n)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    x = torch.tensor([int(n)], dtype=torch.int64, device=dev)
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.MIN)
    return int(x.item())


def barrier() -> None:
    """Wait for every rank of the default group (nothing without one)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized() and (
        dist.get_world_size() > 1
    ):
        dist.barrier()

