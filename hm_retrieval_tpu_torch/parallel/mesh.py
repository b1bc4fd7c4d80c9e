"""The device mesh, in one process or over a process group.

Counterpart of the JAX package's ``parallel/mesh.py``. A JAX mesh is a
(data, model) grid of devices that one controller drives, in one process or
spanning every process of a ``jax.distributed`` group. ``Mesh`` here is the
same grid of torch devices, and each cell also names the rank that owns it:

- in one process every cell is this process's, and the cells may be
  several distinct devices (``["cuda:0", "cuda:1"]``, a card and the host
  CPU ``["cuda:0", "cpu"]``) or one device repeated (``["cuda:0"] * 4``,
  ``["cpu"] * 8``). The collectives between the shards are in-process
  (``parallel/collectives.py``): they copy a tensor to the device that
  consumes it, and a copy to the device a tensor is on is no copy, so the
  repeated device is the case of the same code in which every copy is a
  no-op;
- in a ``torch.distributed`` group of P ranks (``initialize_multihost``)
  each rank passes ``make_mesh`` its **local** devices, by default its
  block of the host's cards (``rank_devices``: all of them split evenly
  over the host's ranks, as ``jax.local_devices()`` gives them, or one card
  a rank where the ranks are at least as many), and the grid is every
  rank's devices in rank order. A rank's cells may be one device repeated
  or several distinct devices (several cards, or a card and the host CPU,
  ``["cuda:0", "cpu"]``), as in one process. A rank computes only its own
  cells; the collectives exchange the shards between ranks, each from its
  own device and onto the device that consumes it.

Training over the mesh places its work by the per-cell device map:

- data shard d (its rows, its copy of the replicated parameters, its towers,
  loss and gradients) runs on ``Mesh.data_device(d)``, the device of its
  first cell in this process;
- row shard s of a table, and its optimizer state, live on
  ``Mesh.model_device(s)``, the first device of column s here;
- replicated state is held once a process, on ``Mesh.first_device``, where
  the gradients' psum lands and the optimizer updates it once. JAX
  replicates it on every device.

Each rank's cells are the product of its data rows and its model columns:
either whole data rows (the data axis split over processes, each feeding
its own rows) or a part of one data row (the model axis spanning processes,
the ranks of the row feeding the same rows). ``make_mesh`` refuses any other
layout. A sharding here is a ``Sharding``: a mesh and a spec in JAX's
``PartitionSpec`` terms, ``()`` replicated, ``("data",)`` split over the
data axis, ``("model", None)`` rows split over the model axis. A replicated
value is held once a process, on its first device; a split one is the list
of its shards in axis order, each on its cell's device, ``None`` where
another rank holds the shard.
"""

from __future__ import annotations

import logging
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

# the devices ``initialize_multihost`` chose for this rank, its first card
# first: the one ``torch.cuda.set_device`` names and NCCL sends from
_rank_devices: List[torch.device] = []


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The default group's size (1 without one)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def choose_backend(device_type: str, ranks_on_host: int,
                   cards_on_host: int) -> str:
    """``"nccl"`` only when each rank has cards of its own (one or a block
    of them); ``"gloo"`` on the CPU and when ranks share a card (NCCL
    refuses two ranks on one device)."""
    if device_type == "cuda" and 0 < ranks_on_host <= cards_on_host:
        return "nccl"
    return "gloo"


def rank_devices(local_rank: int, ranks_on_host: Optional[int] = None,
                 device: DeviceLike = None) -> List[torch.device]:
    """A rank's devices, by default its block of the host's cards:

    - fewer ranks than cards, the ranks dividing them: rank i of n on c
      cards takes ``cuda:{i*c/n} .. cuda:{(i+1)*c/n - 1}`` (2 ranks on 4
      cards: ``[cuda:0, cuda:1]`` and ``[cuda:2, cuda:3]``), as
      ``jax.local_devices()`` gives each process its chips;
    - at least as many ranks as cards (or ``ranks_on_host`` None): the one
      card ``cuda:{local_rank % cards}``, ranks sharing it over gloo;
    - any other split raises ``ValueError``: no rank gets fewer cards than
      another without saying so.

    Without a card it raises ``RuntimeError``; ``device="cpu"`` runs the
    rank on the CPU, ``device="cuda:i"`` on that one card."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a rank needs a card but CUDA is not available; pass "
            "device='cpu' to run the rank on the CPU"
        )
    if device is not None and torch.device(device).index is not None:
        return [torch.device(device)]
    cards = torch.cuda.device_count()
    if ranks_on_host is None or ranks_on_host >= cards:
        return [torch.device("cuda", local_rank % cards)]
    if cards % ranks_on_host:
        raise ValueError(
            f"{ranks_on_host} ranks on a host of {cards} cards: the ranks "
            "must divide the cards (each takes an equal block) or be at "
            "least as many; pass device='cuda:i' to pin a rank to one card"
        )
    per = cards // ranks_on_host
    return [torch.device("cuda", local_rank * per + j) for j in range(per)]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> Optional[torch.device]:
    """Join the default process group; returns this rank's first device
    (its NCCL card; the whole list is ``local_devices()``), or None for a
    single-process run.

    - explicit arguments: all three, ``coordinator_address`` as
      ``host:port`` (``tcp://``), or a URL such as ``file:///path`` used as
      it is; the ranks on this host are ``num_processes``;
    - no arguments: torchrun's environment (``MASTER_ADDR``,
      ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
      ``LOCAL_WORLD_SIZE``);
    - neither: a single-process run, logged, as the JAX function stays
      single-process without a cluster environment.

    Partial arguments raise ``ValueError``. A second call, with the group
    already formed, is logged and returns the rank's first device. The
    backend is ``choose_backend``'s: NCCL only when each rank of the host
    has cards of its own. ``device``: None, the rank's block of cards
    (``rank_devices``, ``ValueError`` before the group forms when the
    host's ranks neither divide its cards nor are at least as many), the
    first of them set as this process's ``torch.cuda`` device; "cpu", the
    CPU; "cuda:i", that one card."""
    global _rank_devices
    dist = torch.distributed
    given = [a is not None for a in
             (coordinator_address, num_processes, process_id)]
    if any(given) and not all(given):
        raise ValueError(
            "pass coordinator_address, num_processes and process_id "
            "together, or none of them (torchrun's environment)"
        )
    if dist.is_initialized():
        logger.info("torch.distributed already initialized: process %d of "
                    "%d", dist.get_rank(), dist.get_world_size())
        return _rank_devices[0] if _rank_devices else None
    if all(given):
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
        local_rank, on_host = rank, world
    elif all(k in os.environ for k in TORCHRUN_ENV):
        url = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        logger.info("single-process run (no process group arguments and no "
                    "torchrun environment)")
        return None
    devs = rank_devices(local_rank, on_host, device)
    dev = devs[0]
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, on_host, cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=world)
    _rank_devices = devs
    logger.info("process %d of %d on %s (%s)", rank, world,
                [str(d) for d in devs], backend)
    return dev


def local_devices() -> List[torch.device]:
    """The devices ``initialize_multihost`` gave this rank, its first card
    first (empty before it or in a single-process run)."""
    return list(_rank_devices)


def rank_card() -> torch.device:
    """The card this rank's NCCL communicator uses: its first card, the one
    ``initialize_multihost`` set as its ``torch.cuda`` device (the current
    card where it did not run). A thread of the autograd engine runs with
    another current card, so the collectives ask this, not
    ``torch.cuda.current_device()``."""
    for d in _rank_devices:
        if d.type == "cuda":
            return d
    return torch.device("cuda", torch.cuda.current_device())


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
    ``torch.device`` and ``ranks[d, s]`` the rank that owns the cell (all 0
    in one process)."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray = None,
                 process_index: int = 0):
        self.devices = devices
        self.shape = {DATA_AXIS: devices.shape[0], MODEL_AXIS: devices.shape[1]}
        self.ranks = (np.zeros(devices.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64))
        self.process_index = int(process_index)
        self.process_count = int(self.ranks.max()) + 1

    def is_local(self, d: int, s: int) -> bool:
        return int(self.ranks[d, s]) == self.process_index

    def rows_of(self, rank: int) -> List[int]:
        """The data rows in which ``rank`` owns a cell."""
        return [d for d in range(self.shape[DATA_AXIS])
                if (self.ranks[d] == rank).any()]

    def cols_of(self, rank: int) -> List[int]:
        """The model columns in which ``rank`` owns a cell."""
        return [s for s in range(self.shape[MODEL_AXIS])
                if (self.ranks[:, s] == rank).any()]

    def local_rows(self) -> List[int]:
        return self.rows_of(self.process_index)

    def local_cols(self) -> List[int]:
        return self.cols_of(self.process_index)

    def row_owner(self, d: int) -> int:
        """The lowest rank of data row ``d``: the one whose copy of a value
        of the row every rank takes (the row's ranks hold the same bits)."""
        return int(self.ranks[d].min())

    def col_owner(self, s: int) -> int:
        """The lowest rank holding model column ``s``."""
        return int(self.ranks[:, s].min())

    @property
    def first_device(self) -> torch.device:
        """This process's first device: where the sharded index gathers its
        shards' leaderboards, and where a replicated value lives."""
        d, s = next(zip(*np.nonzero(self.ranks == self.process_index)))
        return self.devices[d, s]

    def data_device(self, d: int) -> torch.device:
        """Where data shard ``d`` runs in this process: the device of its
        first cell here (its rows, its replica, towers, loss and
        gradients)."""
        s = next(s for s in range(self.shape[MODEL_AXIS])
                 if self.is_local(d, s))
        return self.devices[d, s]

    def model_device(self, s: int) -> torch.device:
        """Where row shard ``s`` of a table and its optimizer state live in
        this process: the first device of column ``s`` here."""
        return self.column(s)[0]

    def column(self, s: int) -> List[torch.device]:
        """The distinct devices of model shard ``s`` that this process
        owns, in data-axis order (empty where another rank holds it)."""
        out = []
        for d in range(self.shape[DATA_AXIS]):
            dev = self.devices[d, s]
            if self.is_local(d, s) and dev not in out:
                out.append(dev)
        return out

    def __repr__(self) -> str:
        extra = (f", ranks={self.ranks.tolist()}"
                 if self.process_count > 1 else "")
        return f"Mesh({self.shape}, devices={self.devices.tolist()}{extra})"


def _check_layout(ranks: np.ndarray) -> None:
    """Each rank's cells are its rows times its columns, and a rank with a
    part of a data row holds no other row (``ValueError`` otherwise)."""
    for r in range(int(ranks.max()) + 1):
        rows = [d for d in range(ranks.shape[0]) if (ranks[d] == r).any()]
        cols = [s for s in range(ranks.shape[1]) if (ranks[:, s] == r).any()]
        product = (ranks[np.ix_(rows, cols)] == r).all()
        count = int((ranks == r).sum())
        if not product or count != len(rows) * len(cols) or (
            len(cols) < ranks.shape[1] and len(rows) > 1
        ):
            raise ValueError(
                f"rank {r}'s cells {np.argwhere(ranks == r).tolist()} are "
                "neither whole data rows nor a part of one data row; choose "
                "(data, model) so that each rank's devices fill whole rows "
                "or one row spans several ranks"
            )


def _gather_devices(local: List[str]) -> List[List[str]]:
    dist = torch.distributed
    out: List[Optional[List[str]]] = [None] * dist.get_world_size()
    dist.all_gather_object(out, local)
    return out


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over the given devices. In one process: by default every
    visible card once; a device appears more than once only when the list
    repeats it, as ``["cuda:0"] * 4`` (four shards on one card) or
    ``["cpu"] * 8``. In a process group of P ranks, collective: each rank
    passes its own devices (by default its block of cards from
    ``initialize_multihost``; explicitly, e.g. ``["cuda:0", "cpu"]``, a
    card and the host), every rank the same number, and the grid is every
    rank's devices in rank order. ``data=None`` uses every device not
    claimed by ``model``."""
    P = process_count()
    if devices is None:
        if P > 1 and _rank_devices:
            devices = list(_rank_devices)
        elif not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh needs a card but CUDA is not available; pass "
                "devices=['cpu'] * n to build a mesh on the CPU"
            )
        elif P > 1:
            devices = [f"cuda:{torch.cuda.current_device()}"]
        else:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [canonical(d) for d in devices]
    for d in devs:
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {str(d)!r}")
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(d)!r} requested but CUDA is not available"
            )
    owners = [0] * len(devs)
    if P > 1:
        per_rank = _gather_devices([str(d) for d in devs])
        if len({len(x) for x in per_rank}) != 1:
            raise ValueError(
                f"ranks passed {[len(x) for x in per_rank]} devices; every "
                "rank must pass the same number"
            )
        devs = [torch.device(d) for x in per_rank for d in x]
        owners = [r for r, x in enumerate(per_rank) for _ in x]
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
    ranks = np.asarray(owners, dtype=np.int64).reshape(data, model)
    _check_layout(ranks)
    mesh = Mesh(grid, ranks, process_index())
    logger.info("Created mesh %s over %d device(s) of %d process(es)",
                mesh.shape, n, P)
    return mesh


def training_device(mesh: Mesh) -> torch.device:
    """The first device of this process's cells, where the replicated
    training state lives, once this process is known to be able to train
    over ``mesh``: a CUDA cell needs CUDA (``RuntimeError``). A rank's
    cells may be several distinct devices, in one process or in a group."""
    local = mesh.devices[mesh.ranks == mesh.process_index]
    for name in sorted({str(d) for d in local}):
        if torch.device(name).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"the mesh's device {name!r} needs a card but CUDA is not "
                "available; build the mesh on devices=['cpu'] * n"
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
    """True iff every data row's cells belong to one process (the JAX
    rule): processes that feed disjoint rows need it. In one process,
    always."""
    return all(len(set(mesh.ranks[d].tolist())) == 1
               for d in range(mesh.shape[DATA_AXIS]))


def split_rows(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``n`` equal row blocks of ``x`` in order (views); ``ValueError``
    unless ``n`` divides its rows."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} shards")
    b = x.shape[0] // n
    return [x[i * b:(i + 1) * b] for i in range(n)]


def place_global(x, sharding: Sharding):
    """Place a host (or device) array under ``sharding``: replicated, one
    tensor on this process's first device; split, the list of its shards
    in axis order, shard i on its cell's device (``Mesh.data_device`` over
    the data axis, ``Mesh.model_device`` over the model axis) and ``None``
    where another rank holds it. Split over the data axis, ``x`` is this
    process's rows (all of them in one process), as JAX's
    ``make_array_from_process_local_data`` takes them; split over the model
    axis, ``x`` is the whole array on every rank. A split axis must divide
    the rows (``ValueError``)."""
    mesh, spec = sharding
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if not spec or spec[0] is None:
        return x.to(mesh.first_device)
    axis = spec[0]
    n = mesh.shape[axis]
    out: List[Optional[torch.Tensor]] = [None] * n
    if axis == DATA_AXIS:
        rows = mesh.local_rows()
        for d, part in zip(rows, split_rows(x, len(rows))):
            out[d] = part.to(mesh.data_device(d))
        return out
    for s, part in enumerate(split_rows(x, n)):
        if mesh.column(s):
            out[s] = part.to(mesh.model_device(s))
    return out


def replicate_pytree(tree, mesh: Mesh):
    """Every tensor of ``tree`` (dicts, lists, tuples, named tuples) held
    once a process, on its first device; a tensor already there is
    returned as it is, so the model's own parameters stay the state's.
    Every rank must hold the same values (a seeded init, a restore)."""
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


def shard_batch(batch, mesh: Mesh) -> List[Optional[dict]]:
    """A batch dict (numpy arrays or tensors) as D per-shard dicts, shard d
    holding its rows on ``mesh.data_device(d)``, ``None`` for another rank's
    rows. In one process the batch is the global one; in a group, this
    process's rows. The mesh's train steps take this list, or the batch,
    which they split the same way."""
    sharding = batch_sharding(mesh)
    cols = {k: place_global(v, sharding) for k, v in batch.items()}
    return [
        None if d not in mesh.local_rows()
        else {k: parts[d] for k, parts in cols.items()}
        for d in range(mesh.shape[DATA_AXIS])
    ]


def split_batch(batch, mesh: Mesh) -> List[Optional[dict]]:
    """This process's batch dict as the mesh's D per-shard dicts, shard d's
    rows on ``mesh.data_device(d)`` (views where they are there already;
    ``None`` for another rank's rows), or a list of D shard dicts
    (``shard_batch``'s, the feed's) as it is. ``ValueError`` unless this
    process's rows divide the batch."""
    D = mesh.shape[DATA_AXIS]
    if isinstance(batch, (list, tuple)):
        if len(batch) != D:
            raise ValueError(f"{len(batch)} batch shards for {D} data shards")
        return list(batch)
    rows = mesh.local_rows()
    cols = {k: split_rows(v, len(rows)) for k, v in batch.items()}
    out: List[Optional[dict]] = [None] * D
    for i, d in enumerate(rows):
        dev = mesh.data_device(d)
        out[d] = {k: parts[i].to(dev) for k, parts in cols.items()}
    return out
