"""Weight bridge between the JAX package's parameter pytree and the port's
modules.

The JAX layout, as numpy arrays (``utils/pytree_io.py`` keys)::

    {"embeddings": {feature: (V+1, E)},
     "dense": [{"w": (d_in, d_out), "b": (d_out,)}, ...],
     "attention": {feature: (E,)}}          # attention-pooled sequences only

and for a two-tower model ``{"query_tower": ..., "candidate_tower": ...}``.
``nn.Linear`` keeps its weight as (d_out, d_in), so ``w`` is transposed on
the way in and on the way out.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike
from hm_retrieval_tpu_torch.models.tower import Tower
from hm_retrieval_tpu_torch.models.two_tower import TwoTowerModel
from hm_retrieval_tpu_torch.schema.features import Feature

Module = Union[Tower, TwoTowerModel]


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src_t = torch.from_numpy(np.require(src, np.float32, ["C", "W"]))
    if tuple(src_t.shape) != tuple(dst.shape):
        raise ValueError(
            f"{name}: shape {tuple(src_t.shape)} does not match the "
            f"module's {tuple(dst.shape)}"
        )
    dst.copy_(src_t)


@torch.no_grad()
def params_from_numpy(module: Module, tree: dict) -> Module:
    """Copy a JAX-layout numpy tree into ``module`` in place."""
    if isinstance(module, TwoTowerModel):
        params_from_numpy(module.query_tower, tree["query_tower"])
        params_from_numpy(module.candidate_tower, tree["candidate_tower"])
        return module
    if set(tree["embeddings"]) != set(module.embeddings):
        raise ValueError(
            f"embedding tables {sorted(tree['embeddings'])} do not match "
            f"the tower's {sorted(module.embeddings)}"
        )
    for name, table in module.embeddings.items():
        _copy(table, tree["embeddings"][name], f"embeddings/{name}")
    if len(tree["dense"]) != len(module.dense):
        raise ValueError(
            f"{len(tree['dense'])} dense layers in the tree, "
            f"{len(module.dense)} in the tower"
        )
    for i, (layer, lt) in enumerate(zip(module.dense, tree["dense"])):
        _copy(layer.weight, np.asarray(lt["w"]).T, f"dense/{i}/w")
        _copy(layer.bias, lt["b"], f"dense/{i}/b")
    attention = tree.get("attention", {})
    if set(attention) != set(module.attention):
        raise ValueError(
            f"attention queries {sorted(attention)} do not match the "
            f"tower's {sorted(module.attention)}"
        )
    for name, query in module.attention.items():
        _copy(query, attention[name], f"attention/{name}")
    return module


def params_to_numpy(module: Module) -> dict:
    """The module's weights as a JAX-layout numpy tree."""
    if isinstance(module, TwoTowerModel):
        return {
            "query_tower": params_to_numpy(module.query_tower),
            "candidate_tower": params_to_numpy(module.candidate_tower),
        }

    def np_(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    tree = {
        "embeddings": {n: np_(t) for n, t in module.embeddings.items()},
        "dense": [
            {"w": np_(layer.weight).T.copy(), "b": np_(layer.bias)}
            for layer in module.dense
        ],
    }
    if len(module.attention):
        tree["attention"] = {n: np_(t) for n, t in module.attention.items()}
    return tree


def tower_from_numpy(
    features: List[Feature], tree: dict, device: DeviceLike = None
) -> Tower:
    """A ``Tower`` whose layer widths are read off ``tree`` (as the JAX
    serving path does: the params carry the architecture), loaded with
    its weights."""
    widths = [np.asarray(layer["w"]).shape[1] for layer in tree["dense"]]
    tower = Tower(features, widths[-1], widths[:-1], device)
    return params_from_numpy(tower, tree)
