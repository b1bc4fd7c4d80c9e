"""The device mesh of one process.

Counterpart of the part of the JAX package's ``parallel/mesh.py`` that the
sharded index reads: the axis names and ``make_mesh``. A JAX mesh in one
process is a single controller driving D x S devices; ``Mesh`` here is the
same: a (data, model) grid of torch devices that one process drives. The
sharded index puts shard s of its catalog on the devices of column s and
gathers the shards' leaderboards onto the mesh's first device.

The layouts over several processes (processes that own disjoint shards, the
all-gathers of ``_host_catalog`` and ``to_local``, collective saves) and
training over a mesh wait for ROADMAP.md Queue 1 item 6.2; a mesh asked for
inside a process group of more than one rank raises
``NotImplementedError``.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
MULTI_PROCESS = "ROADMAP.md Queue 1 item 6.2 (training and multi-process meshes)"


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
