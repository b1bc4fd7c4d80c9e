"""The collectives of a mesh, in one process or over a process group.

No file of the JAX package corresponds: there ``jax.lax.all_gather``,
``psum`` and ``axis_index`` run inside ``shard_map``, one program a device.
Here a per-shard value is a list in axis order. In one process every entry
is present, each on its shard's device (``parallel/mesh.py``), and each
collective is a plain tensor operation over the list:

- ``all_gather``: the shards copied to the consumer's device, then
  ``torch.cat`` in axis order. Its autograd transpose hands each shard the
  slice of the gradient that concerns it, copied back to the shard's device
  and summed over every consumer of the gathered tensor, as JAX's
  all_gather transposes to a reduce-scatter;
- ``psum``: every value copied to the first value's device (the first data
  shard's: the mesh's first device), then summed there in fixed shard order
  (0, 1, ...), so the same inputs give the same bits on every run, and the
  bits of the same values on one device;
- ``broadcast``: a tensor copied to each of several devices as one autograd
  node, whose backward sums the copies' gradients in a fixed order: the
  reverse of the devices', the order in which the autograd engine adds the
  gradients of one tensor's consumers on one device (the last consumer's
  first). The engine runs each device's backward on a thread of its own,
  so gradients that several devices send one tensor would otherwise be
  added in the order the threads finish; a value several devices consume
  (the gathered candidates) goes through it, so every replay keeps its
  bits, and one shard a card gives the bits of the card repeated;
- ``axis_index``: the indices of this process's shards along an axis.

A copy to the device a tensor is on is no copy, so over one device repeated
the collectives are the same operations as before any device was told
apart.

In a ``torch.distributed`` group (``parallel/mesh.py``) each rank passes the
list with its **local** shards and ``None`` for the others, and gets the
global result:

- the missing entries are exchanged (``fill``): every rank sends its local
  entries in one all-gather, each from the device it lies on, and each
  missing entry is taken from its owner (the lowest rank holding it: the
  ranks of a data row hold the same bits) and delivered to the device that
  consumes it (the gathering device, the first local value's for a sum, a
  data shard's for the lookup's buckets). A rank's cells may be several
  distinct devices, as in one process;
- ``psum`` is that exchange, then the same left-to-right sum in global
  shard order as the one-process ``psum``, over the local tensors as they
  are and the others' values. So every rank holds the same bits, equal to
  the one-process ``psum`` of the same values bit for bit; a sum of per-rank
  partial sums would change the association. Its autograd is the
  one-process one: each local shard's gradient is the output's;
- ``all_gather`` across ranks is a ``torch.autograd.Function``. Its backward
  all-gathers every rank's gradient of the gathered tensor, sums, in rank
  order, those of one rank of each data row (the row's ranks run the same
  consumers), and hands each local shard its slice on the shard's device:
  the reduce-scatter of JAX's transpose. ``gather_to_shards``, the
  candidates of the global-negative loss, gives each local data shard its
  own copy instead and sums the shards' gradients in the order one process
  over the same grid of devices sums them (``broadcast``'s), so the
  group's training steps keep that process's bits. Every rank runs forward
  and backward in the same order, so the collectives pair up.

A rank exchanges the bytes of its tensors, in pieces of at most ``CHUNK``.
Over ``gloo`` it sends and receives host copies, by the backend's rule (the
pattern of ``metrics/index_recall.py``); over ``nccl`` through the rank's
own card (``mesh.rank_card``: PyTorch's NCCL group takes one card a rank),
a tensor on another card or on the host staged to it first (a peer copy
over NVLink between cards that have it), never quietly sent over the host.
Every rank must pass tensors of one shape and dtype an entry.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from hm_retrieval_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, rank_card

CHUNK = 1 << 28  # bytes a rank sends in one all-gather
_ALIGN = 16  # each tensor's bytes start at a multiple of this


def _dist():
    return torch.distributed


def _wire_device() -> torch.device:
    """Where a tensor travels: the rank's own card under nccl, whatever
    device the tensor lies on; the host under gloo."""
    if _dist().get_backend() == "nccl":
        return rank_card()
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


def exchange_bytes(tensors: Sequence[torch.Tensor],
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> List[List[torch.Tensor]]:
    """Every rank passes tensors of the same count, shapes and dtypes, each
    staged from its own device; each gets every rank's, in rank order: its
    own as they are (detached), another rank's tensor i on ``devices[i]``
    (default: the device of this rank's tensor i)."""
    dist = _dist()
    P = dist.get_world_size()
    tensors = [t.detach() for t in tensors]
    dests = ([t.device for t in tensors] if devices is None
             else [torch.device(d) for d in devices])
    wire_dev = _wire_device()
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
        for t, n, dest in zip(tensors, sizes, dests):
            got.append(buf[off:off + n].view(t.dtype).reshape(t.shape).to(
                dest))
            off += _padded(n)
        out.append(got)
    return out


def fill(values: Sequence, keys_of: Callable[[int], List[int]],
         source: Callable[[int], int],
         device: Optional[torch.device] = None) -> list:
    """``values`` (tensors, or dicts of tensors with one set of keys) by
    global index, ``None`` where this rank lacks the entry, with every entry
    present: a rank ``r`` holds the indices ``keys_of(r)`` and missing index
    i comes from rank ``source(i)``, onto ``device`` (default: each tensor
    where the same tensor of this rank's first entry lies). A list without
    ``None`` is returned as it is, with no collective."""
    values = list(values)
    if all(v is not None for v in values):
        return values
    dist = _dist()
    me = dist.get_rank()
    mine = keys_of(me)
    like = _leaves(values[mine[0]])
    width = len(like)
    leaves = [t for i in mine for t in _leaves(values[i])]
    dests = [like[p % width].device if device is None else device
             for p in range(len(leaves))]
    per_rank = exchange_bytes(leaves, dests)
    for i, v in enumerate(values):
        if v is not None:
            continue
        src = source(i)
        pos = keys_of(src).index(i)
        got = per_rank[src][pos * width:(pos + 1) * width]
        values[i] = _rebuild(values[mine[0]], got)
    return values


def _data_fill(values: Sequence, mesh: Optional[Mesh],
               device: Optional[torch.device] = None) -> list:
    """Over the data axis: row d from the rank of row d that holds this
    rank's first model column, whose values (a row-sharded table's
    gradients among them) have this rank's layout; onto ``device`` (see
    ``fill``)."""
    if all(v is not None for v in values):
        return list(values)
    if mesh is None:
        raise ValueError("another rank's shards need the mesh")
    col = mesh.local_cols()[0]
    return fill(values, mesh.rows_of, lambda d: int(mesh.ranks[d, col]),
                device)


def one_process_order(mesh: Mesh) -> List[List[int]]:
    """The data shards grouped by the device their row starts on, in the
    order one process over ``mesh``'s grid adds their gradients of a value
    they all consume (``shard_losses``' gathered candidates): the groups
    last first (``broadcast``), and in each group the shards last first
    (the autograd engine on one device), ``[[...], ...]`` in that order."""
    D = mesh.shape[DATA_AXIS]
    homes = [mesh.devices[d, 0] for d in range(D)]
    devices = list(dict.fromkeys(homes))
    return [[d for d in reversed(range(D)) if homes[d] == dev]
            for dev in reversed(devices)]


class _GroupAllGather(torch.autograd.Function):
    """The data axis' all-gather across ranks, with its reduce-scatter: one
    output on ``device`` or, with ``consumers`` (one device for each local
    shard), a copy for each local shard on its consumer's device."""

    @staticmethod
    def forward(ctx, mesh: Mesh, dim: int, device: torch.device,
                present: List[int], consumers, *local):
        values: List[Optional[torch.Tensor]] = [None] * mesh.shape[DATA_AXIS]
        for d, t in zip(present, local):
            values[d] = t.detach()
        full = _data_fill(values, mesh, device)
        ctx.mesh, ctx.dim, ctx.present = mesh, dim, present
        ctx.device, ctx.consumers = device, consumers
        ctx.homes = [t.device for t in local]
        ctx.sizes = [t.shape[dim] for t in full]
        out = torch.cat([t.to(device) for t in full], dim=dim)
        if consumers is None:
            return (out,)
        return tuple(out.to(c, copy=True) for c in consumers)

    @staticmethod
    def backward(ctx, *grads):
        mesh, dev = ctx.mesh, ctx.device
        if ctx.consumers is None:
            per_rank = exchange_bytes([grads[0].contiguous()], [dev])
            # one rank a data row: the row's ranks ran the same consumers
            leaders = sorted({mesh.row_owner(d)
                              for d in range(mesh.shape[DATA_AXIS])})
            total = per_rank[leaders[0]][0].to(dev)
            for r in leaders[1:]:
                total = total + per_rank[r][0].to(dev)
        else:
            per_rank = exchange_bytes([g.contiguous() for g in grads],
                                      [dev] * len(grads))
            # each data shard's gradient from its row's owner, summed as one
            # process over the same grid sums them
            g = {d: per_rank[mesh.row_owner(d)][
                mesh.rows_of(mesh.row_owner(d)).index(d)].to(dev)
                for d in range(mesh.shape[DATA_AXIS])}
            sums = []
            for group in one_process_order(mesh):
                part = g[group[0]]
                for d in group[1:]:
                    part = part + g[d]
                sums.append(part)
            total = sums[0]
            for part in sums[1:]:
                total = total + part
        parts = torch.split(total, ctx.sizes, dim=ctx.dim)
        return (None,) * 5 + tuple(parts[d].to(h) for d, h in
                                   zip(ctx.present, ctx.homes))


def all_gather(shards: Sequence[Optional[torch.Tensor]], dim: int = 0,
               mesh: Optional[Mesh] = None,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """The data axis' shards concatenated along ``dim`` in axis order
    (JAX's ``all_gather(..., tiled=True)``) on ``device`` (default: the
    first shard's, across ranks the first local one's); across ranks,
    ``None`` for another rank's shards (``mesh`` required), differentiable,
    each local shard's gradient on its own device."""
    shards = list(shards)
    if all(t is not None for t in shards):
        dev = shards[0].device if device is None else device
        return torch.cat([t.to(dev) for t in shards], dim=dim)
    present = [d for d, t in enumerate(shards) if t is not None]
    local = [shards[d] for d in present]
    dev = local[0].device if device is None else torch.device(device)
    if not any(t.requires_grad for t in local):
        return torch.cat([t.to(dev) for t in _data_fill(shards, mesh, dev)],
                         dim=dim)
    return _GroupAllGather.apply(mesh, dim, dev, present, None, *local)[0]


def gather_to_shards(shards: Sequence[Optional[torch.Tensor]], mesh: Mesh,
                     device: torch.device) -> List[Optional[torch.Tensor]]:
    """Across ranks: the data axis' shards (``None`` for another rank's)
    gathered along dim 0 on ``device``, then one copy for each local shard,
    on that shard's device (its tensor's), ``None`` for the others;
    differentiable. The copies' gradients are summed over every rank's
    shards in ``one_process_order``, so the bits are those of one process
    over the same grid that gathers the shards and ``broadcast``s the
    result to the devices of its shards."""
    present = [d for d, t in enumerate(shards) if t is not None]
    local = [shards[d] for d in present]
    copies = _GroupAllGather.apply(mesh, 0, torch.device(device), present,
                                   [t.device for t in local], *local)
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for d, c in zip(present, copies):
        out[d] = c
    return out


class _Broadcast(torch.autograd.Function):
    """``x`` copied to each of ``devices``; the gradients summed on ``x``'s
    device in the reverse of the devices' order."""

    @staticmethod
    def forward(ctx, x, *devices):
        ctx.device = x.device
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = grads[-1].to(ctx.device)
        for g in reversed(grads[:-1]):
            total = total + g.to(ctx.device)
        return (total,) + (None,) * len(grads)


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """``x`` on each of ``devices`` (distinct, in the order of their first
    consumers), differentiable: ``[x]`` itself for its own device alone,
    else copies whose gradients come back summed last device first,
    ``((g[n-1] + g[n-2]) + ...) + g[0]``, as one device adds its consumers'
    gradients, whatever order the devices' backward passes finish in."""
    if len(devices) == 1 and torch.device(devices[0]) == x.device:
        return [x]
    return list(_Broadcast.apply(x, *devices))


def _ordered_sum(values: Sequence):
    if isinstance(values[0], dict):
        return {k: _ordered_sum([v[k] for v in values]) for k in values[0]}
    out = values[0]
    for v in values[1:]:
        out = out + v.to(out.device)
    return out


def psum(values: Sequence, mesh: Optional[Mesh] = None,
         axis: str = DATA_AXIS):
    """The sum of ``values`` (tensors, or dicts of tensors with one set of
    keys) in shard order, ``((v0 + v1) + v2) + ...``, on the device of
    ``v0`` (of each of its tensors, for a dict). Across ranks, ``None``
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
    wire_dev = _wire_device()
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
    x = torch.tensor([int(n)], dtype=torch.int64, device=_wire_device())
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

