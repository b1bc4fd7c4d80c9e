"""Weight bridge between the JAX package's parameter pytree and the port's
modules.

The JAX layout, as numpy arrays (``utils/pytree_io.py`` keys)::

    {"embeddings": {feature: (V+1, E)},
     "dense": [{"w": (d_in, d_out), "b": (d_out,)}, ...],
     "attention": {feature: (E,)}}          # attention-pooled sequences only

and for a two-tower model ``{"query_tower": ..., "candidate_tower": ...}``.
``nn.Linear`` keeps its weight as (d_out, d_in), so ``w`` is transposed on
the way in and on the way out.

Training states cross too (``train_state_to_numpy`` /
``train_state_from_numpy``), as numpy trees in the JAX layout:

    TrainState:       {"params": tree, "opt_state": opt, "step": int32}
    SparseTrainState: {"params": tree, "dense_opt_state": opt,
                       "accumulators": {tower: {feature: (V+1, E)}},
                       "step": int32}

where ``opt`` carries optax's field names over trees shaped like the params
it covers (all of them, or the dense subtree without "embeddings"):
``{"sum_of_squares": tree}`` for Adagrad, ``{"count": int32, "mu": tree,
"nu": tree}`` for Adam. Optimizer state of a weight is transposed as the
weight is.

The mesh's states (``parallel/``) cross in the same layout: a row-sharded
table, its accumulator or its dense optimizer state (a ``ShardedTable``) is
one (S*R, E) array, the shards in order and the pad rows included, as the
JAX package's sharded global array reads back (in a process group, the
shards gathered from their owners: collective). Loading one splits the rows
over the state's shards, each rank copying the shards it holds, so a state
of another mesh with the same padded rows takes it.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike
from hm_retrieval_tpu_torch.models.optimizer_factory import (
    AdagradState,
    AdamState,
)
from hm_retrieval_tpu_torch.models.sparse_optimizer import SparseTrainState
from hm_retrieval_tpu_torch.models.tower import Tower
from hm_retrieval_tpu_torch.models.two_tower import TrainState, TwoTowerModel
from hm_retrieval_tpu_torch.schema.features import Feature

Module = Union[Tower, TwoTowerModel]


def _np(t) -> np.ndarray:
    """A numpy copy: steps update parameters in place, so a view of a CPU
    tensor would change under its reader. A ``ShardedTable`` gives its
    shards' rows in order."""
    if hasattr(t, "shards"):
        return t.host().numpy()
    return t.detach().to("cpu", copy=True).numpy()


def _copy(dst, src: np.ndarray, name: str) -> None:
    src_t = torch.from_numpy(np.require(src, np.float32, ["C", "W"]))
    if tuple(src_t.shape) != tuple(dst.shape):
        raise ValueError(
            f"{name}: shape {tuple(src_t.shape)} does not match the "
            f"module's {tuple(dst.shape)}"
        )
    shards = getattr(dst, "shards", None)
    if shards is None:
        dst.copy_(src_t)
        return
    r = dst.rows_per_shard
    for s, shard in enumerate(shards):
        if shard is not None:  # another rank's shard: it copies its own
            shard.copy_(src_t[s * r:(s + 1) * r])


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

    tree = {
        "embeddings": {n: _np(t) for n, t in module.embeddings.items()},
        "dense": [
            {"w": _np(layer.weight).T.copy(), "b": _np(layer.bias)}
            for layer in module.dense
        ],
    }
    if len(module.attention):
        tree["attention"] = {n: _np(t) for n, t in module.attention.items()}
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


# ----------------------------------------------------------------------
# Training state
# ----------------------------------------------------------------------
def flat_to_tree(flat: Dict[str, torch.Tensor], full: bool = True) -> dict:
    """Module-named tensors (``query_tower.dense.0.weight``, ...) as a
    JAX-layout numpy tree. ``full``: every tower holds "embeddings" and
    "dense", as a params tree does (False: the dense subtree)."""
    tree: dict = {}
    for name, t in flat.items():
        tower, kind, key, *field = name.split(".")
        node = tree.setdefault(
            tower, {"embeddings": {}, "dense": []} if full else {"dense": []}
        )
        if kind == "dense":
            layers = node["dense"]
            layers.extend({} for _ in range(int(key) + 1 - len(layers)))
            if field == ["weight"]:
                layers[int(key)]["w"] = _np(t).T.copy()
            else:
                layers[int(key)]["b"] = _np(t)
        else:
            node.setdefault(kind, {})[key] = _np(t)
    return tree


def tree_to_flat(tree: dict) -> Dict[str, np.ndarray]:
    """Inverse of ``flat_to_tree``."""
    flat = {}
    for tower, node in tree.items():
        for kind, sub in node.items():
            if kind == "dense":
                for i, layer in enumerate(sub):
                    flat[f"{tower}.dense.{i}.weight"] = np.asarray(layer["w"]).T
                    flat[f"{tower}.dense.{i}.bias"] = np.asarray(layer["b"])
            else:
                for key, a in sub.items():
                    flat[f"{tower}.{kind}.{key}"] = np.asarray(a)
    return flat


def _load_flat(dst: Dict[str, torch.Tensor], src: Dict[str, np.ndarray], what):
    if set(dst) != set(src):
        raise ValueError(
            f"{what}: {sorted(src)} do not match the state's {sorted(dst)}"
        )
    for name, t in dst.items():
        _copy(t, src[name], f"{what}/{name}")


def _opt_to_numpy(opt_state, full: bool) -> dict:
    if isinstance(opt_state, AdagradState):
        return {"sum_of_squares": flat_to_tree(opt_state.sum_of_squares, full)}
    if isinstance(opt_state, AdamState):
        return {
            "count": np.int32(_np(opt_state.count)),
            "mu": flat_to_tree(opt_state.mu, full),
            "nu": flat_to_tree(opt_state.nu, full),
        }
    raise TypeError(f"unknown optimizer state {type(opt_state).__name__}")


def _opt_from_numpy(opt_state, tree: dict) -> None:
    if isinstance(opt_state, AdagradState):
        _load_flat(
            opt_state.sum_of_squares,
            tree_to_flat(tree["sum_of_squares"]),
            "sum_of_squares",
        )
    elif isinstance(opt_state, AdamState):
        opt_state.count.fill_(int(tree["count"]))
        _load_flat(opt_state.mu, tree_to_flat(tree["mu"]), "mu")
        _load_flat(opt_state.nu, tree_to_flat(tree["nu"]), "nu")
    else:
        raise TypeError(f"unknown optimizer state {type(opt_state).__name__}")


def train_state_to_numpy(state: Union[TrainState, SparseTrainState]) -> dict:
    """The state as a JAX-layout numpy tree (see the module docstring)."""
    out = {"params": flat_to_tree(state.params)}
    if isinstance(state, SparseTrainState):
        out["dense_opt_state"] = _opt_to_numpy(state.dense_opt_state, False)
        accumulators: dict = {}
        for name, acc in state.sparse_state.accumulators.items():
            tower, _, feature = name.split(".")
            accumulators.setdefault(tower, {})[feature] = _np(acc)
        out["accumulators"] = accumulators
    else:
        out["opt_state"] = _opt_to_numpy(state.opt_state, True)
    out["step"] = np.int32(state.step)
    return out


@torch.no_grad()
def train_state_from_numpy(
    state: Union[TrainState, SparseTrainState], tree: dict
) -> Union[TrainState, SparseTrainState]:
    """Copy a JAX-layout numpy tree into ``state``'s tensors in place;
    returns the state with the tree's step."""
    _load_flat(state.params, tree_to_flat(tree["params"]), "params")
    if isinstance(state, SparseTrainState):
        _opt_from_numpy(state.dense_opt_state, tree["dense_opt_state"])
        _load_flat(
            state.sparse_state.accumulators,
            {
                f"{tower}.embeddings.{feature}": a
                for tower, feats in tree["accumulators"].items()
                for feature, a in feats.items()
            },
            "accumulators",
        )
    else:
        _opt_from_numpy(state.opt_state, tree["opt_state"])
    return state._replace(step=int(tree["step"]))
