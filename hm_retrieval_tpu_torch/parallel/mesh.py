"""The device mesh of one process.

Counterpart of the JAX package's ``parallel/mesh.py``. A JAX mesh in one
process is a single controller driving D x S devices; ``Mesh`` here is the
same: a (data, model) grid of torch devices that one process drives. The
sharded index puts shard s of its catalog on the devices of column s and
gathers the shards' leaderboards onto the mesh's first device.

Training over a mesh takes a mesh whose devices are all one device (the card
repeated, ``["cuda:0"] * 4``, or ``["cpu"] * 8``): data shard d runs its own
towers on rows ``[d*b, (d+1)*b)`` of the global batch, and the collectives
between the shards are in-process (``parallel/collectives.py``). A sharding
here is a ``Sharding``: a mesh and a spec in JAX's ``PartitionSpec`` terms,
``()`` replicated, ``("data",)`` split over the data axis, ``("model",
None)`` rows split over the model axis. A replicated value is held once, on
the mesh's device; a split one is the list of its shards.

Several cards and processes (``initialize_multihost``, processes that feed
disjoint shards, the all-gathers of ``_host_catalog`` and ``to_local``,
collective saves) wait for ROADMAP.md Queue 1 item 6.3: a training mesh over
more than one distinct device, and any mesh inside a process group of more
than one rank, raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
MULTI_PROCESS = "ROADMAP.md Queue 1 item 6.3 (several cards and processes)"


def require_single_process(what: str) -> None:
    """Raise ``NotImplementedError`` inside a process group of more than one
    rank: the port's mesh is the one-process layout."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and (
        dist.get_world_size() > 1
    ):
        raise NotImplementedError(
            f"{what} over {dist.get_world_size()} processes is not ported "
            f"yet: {MULTI_PROCESS}"
        )


def canonical(device) -> torch.device:
    """``device`` with its index made explicit (``"cuda"`` -> ``cuda:N``, the
    current card), so two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (data, model) grid of torch devices. ``shape`` is
    ``{"data": D, "model": S}`` as in JAX; ``devices[d, s]`` is a
    ``torch.device``."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {DATA_AXIS: devices.shape[0], MODEL_AXIS: devices.shape[1]}

    @property
    def first_device(self) -> torch.device:
        """Where the sharded index gathers its shards' leaderboards."""
        return self.devices[0, 0]

    def column(self, s: int) -> List[torch.device]:
        """The distinct devices of model shard ``s``, in data-axis order."""
        out = []
        for dev in self.devices[:, s]:
            if dev not in out:
                out.append(dev)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over the given devices, by default every visible card once.
    ``data=None`` uses every device not claimed by ``model``. A device
    appears more than once only when the list repeats it, as
    ``["cuda:0"] * 4`` (four shards on one card) or ``["cpu"] * 8``."""
    require_single_process("a mesh")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh needs a card but CUDA is not available; pass "
                "devices=['cpu'] * n to build a mesh on the CPU"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [canonical(d) for d in devices]
    for d in devs:
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {str(d)!r}")
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(d)!r} requested but CUDA is not available"
            )
    n = len(devs)
    if model <= 0 or n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} available devices")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devs):
        grid[i // model, i % model] = d
    mesh = Mesh(grid)
    logger.info("Created mesh %s over %d device(s)", mesh.shape, n)
    return mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """The JAX package joins its process group here; the port's mesh is one
    process's, so this raises ``NotImplementedError``."""
    raise NotImplementedError(
        f"initialize_multihost is not ported yet: {MULTI_PROCESS}"
    )


def training_device(mesh: Mesh) -> torch.device:
    """The one device of a training mesh. Training over a mesh is ported
    for a mesh whose devices are all one device, in one process; anything
    else raises ``NotImplementedError``."""
    require_single_process("training over a mesh")
    distinct = sorted({str(d) for d in mesh.devices.ravel()})
    if len(distinct) != 1:
        raise NotImplementedError(
            f"training over a mesh of {len(distinct)} distinct devices "
            f"{distinct} is not ported yet: {MULTI_PROCESS}"
        )
    return mesh.first_device


class Sharding(NamedTuple):
    """How a value lies on a mesh: ``spec`` in ``PartitionSpec`` terms."""

    mesh: Mesh
    spec: Tuple


REPLICATED: Tuple = ()
ROWS: Tuple = (MODEL_AXIS, None)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading axis split over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, REPLICATED)


def row_sharded(mesh: Mesh, axis: str = MODEL_AXIS) -> Sharding:
    """Row-shard a (V, E) table over the given axis."""
    return Sharding(mesh, (axis, None))


def data_axis_process_aligned(mesh: Mesh) -> bool:
    """True iff every data-axis chunk's devices belong to one process: in
    one process, always."""
    require_single_process("a mesh")
    return True


def split_rows(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``n`` equal row blocks of ``x`` in order (views); ``ValueError``
    unless ``n`` divides its rows."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} shards")
    b = x.shape[0] // n
    return [x[i * b:(i + 1) * b] for i in range(n)]


def place_global(x, sharding: Sharding):
    """Place a host (or device) array under ``sharding``: replicated, one
    tensor on the mesh's first device; split, the list of its shards, shard
    i on the first device of row (data) or column (model) i of the mesh. A
    split axis must divide the rows (``ValueError``), as JAX's
    ``device_put`` requires."""
    require_single_process("place_global")
    mesh, spec = sharding
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if not spec or spec[0] is None:
        return x.to(mesh.first_device)
    axis = spec[0]
    n = mesh.shape[axis]
    devs = (
        [mesh.devices[d, 0] for d in range(n)]
        if axis == DATA_AXIS
        else [mesh.column(s)[0] for s in range(n)]
    )
    return [part.to(dev) for part, dev in zip(split_rows(x, n), devs)]


def replicate_pytree(tree, mesh: Mesh):
    """Every tensor of ``tree`` (dicts, lists, tuples, named tuples) held
    once, on the training mesh's device; a tensor already there is returned
    as it is, so the model's own parameters stay the state's."""
    dev = training_device(mesh)

    def place(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[place(v) for v in x])
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return x

    return place(tree)


def shard_batch(batch, mesh: Mesh) -> List[dict]:
    """A batch dict (numpy arrays or tensors) as D per-shard dicts, shard d
    holding rows ``[d*b, (d+1)*b)`` on its device. The mesh's train steps
    take this list, or the whole batch, which they split the same way."""
    sharding = batch_sharding(mesh)
    cols = {k: place_global(v, sharding) for k, v in batch.items()}
    return [
        {k: parts[d] for k, parts in cols.items()}
        for d in range(mesh.shape[DATA_AXIS])
    ]


def split_batch(batch, n: int) -> List[dict]:
    """A whole batch dict as ``n`` per-shard dicts of row views, or a list
    of ``n`` shard dicts (``shard_batch``'s) as it is. ``ValueError``
    unless ``n`` divides the batch."""
    if isinstance(batch, (list, tuple)):
        if len(batch) != n:
            raise ValueError(f"{len(batch)} batch shards for {n} data shards")
        return list(batch)
    cols = {k: split_rows(v, n) for k, v in batch.items()}
    return [{k: parts[d] for k, parts in cols.items()} for d in range(n)]
