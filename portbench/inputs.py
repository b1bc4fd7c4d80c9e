"""What the benchmark makes from the seed and hands to both sides: the
weights, the catalog's side features, logQ and the id streams.

Everything is drawn on the run's device with a ``torch.Generator`` there
(logQ's 105,542 Dirichlet draws on the host with numpy), in a few large
calls, so one seed gives the same inputs to the program and to the plain
reference. Nothing here imports the program.

Parameter names are the program's own (``query_tower.dense.0.weight``, a
dense weight stored (out, in) as ``nn.Linear`` keeps it), so the harness
copies each leaf into the program's parameter of the same name.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# Streams of one seed; each gets a generator of its own.
STREAMS = ("weights", "catalog", "logq", "order", "train", "check")


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of the run's ``seed`` (any integer)."""
    seq = np.random.SeedSequence([seed % 2**63, STREAMS.index(stream)])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def tower_layout(cfg: dict, tower: str) -> Tuple[List[dict], List[int]]:
    """(features, dense widths from the concatenated input to the joint
    layer) of ``"query"`` or ``"candidate"``."""
    feats = cfg[f"{tower}_features"]
    dims = ([sum(f["width"] for f in feats)] + list(cfg[f"{tower}_tower_units"])
            + [cfg["joint_embedding_size"]])
    return feats, dims


def leaf_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in draw order: each tower's
    tables (one row more than the vocabulary: row 0 is the OOV row), then
    its dense weights and biases."""
    out = []
    for tower in ("query", "candidate"):
        feats, dims = tower_layout(cfg, tower)
        for f in feats:
            out.append((f"{tower}_tower.embeddings.{f['name']}",
                        (f["rows"] + 1, f["width"]), "table"))
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            out.append((f"{tower}_tower.dense.{i}.weight", (d_out, d_in),
                        "glorot"))
            out.append((f"{tower}_tower.dense.{i}.bias", (d_out,), "zero"))
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter as fp32 views of one buffer on ``device``: one
    uniform draw for all of it, then each leaf scaled in place to its
    range (tables +-table_uniform, dense weights +-sqrt(6 / (in + out)),
    biases 0)."""
    shapes = leaf_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    flat = torch.rand(total, generator=generator(seed, "weights", device),
                      device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in shapes:
        n = int(np.prod(shape))
        leaf = flat[at:at + n].view(shape)
        at += n
        if init == "zero":
            leaf.zero_()
            limit = None
        elif init == "table":
            limit = float(cfg["init"]["table_uniform"])
        else:
            limit = (6.0 / (shape[0] + shape[1])) ** 0.5
        if limit is not None:
            leaf.mul_(2 * limit).sub_(limit)
        out[name] = leaf
    return out


def catalog_features(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """(n_articles,) int32 ids of every candidate feature, article by
    article: the id feature is 1..n_articles; each side feature is drawn
    uniformly from its 1..rows."""
    n = cfg["n_articles"]
    gen = generator(seed, "catalog", device)
    out = {}
    for f in cfg["candidate_features"]:
        if f["name"] == cfg["candidate_id"]:
            out[f["name"]] = torch.arange(1, n + 1, dtype=torch.int32,
                                          device=device)
        else:
            out[f["name"]] = torch.randint(1, f["rows"] + 1, (n,),
                                           generator=gen, device=device,
                                           dtype=torch.int32)
    return out


def article_probs(cfg: dict, seed: int) -> np.ndarray:
    """(n_articles,) float64 sampling probabilities, Dirichlet(alpha)."""
    rng = np.random.default_rng(sub_seed(seed, "logq"))
    n = cfg["n_articles"]
    return rng.dirichlet(np.full(n, float(cfg["logq_dirichlet_alpha"])))


def logq_table(probs: np.ndarray) -> np.ndarray:
    """(n_articles + 1,) float32 logQ, entry 0 (OOV) = 0."""
    return np.concatenate([[0.0], np.log(probs)]).astype(np.float32)


def customer_batches(n_customers: int, batch: int, seed: int) -> np.ndarray:
    """(n_batches, batch) int32: a seeded permutation of the customer ids
    1..n_customers cut into consecutive slices, its head appended to fill
    the last one. Every seed gives the same shape."""
    rng = np.random.default_rng(sub_seed(seed, "order"))
    order = rng.permutation(n_customers).astype(np.int32) + 1
    n_batches = -(-n_customers // batch)
    pad = n_batches * batch - n_customers
    return np.concatenate([order, order[:pad]]).reshape(n_batches, batch)


def draw_articles(probs: np.ndarray, n: int, gen: torch.Generator,
                  device) -> torch.Tensor:
    """(n,) int64 article rows drawn from ``probs`` by the inverse of their
    float64 CDF at uniform draws: the same rows for the same generator on
    every run (``torch.multinomial`` on a card is not)."""
    cdf = torch.as_tensor(np.cumsum(probs), dtype=torch.float64, device=device)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u * cdf[-1], right=True).clamp_(
        max=len(probs) - 1)


def train_pool(cfg: dict, traffic: dict, probs: np.ndarray, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """{feature: (pool_batches, batch) int32} on ``device``: customer ids
    uniform over 1..n_customers, article ids drawn from ``probs``, and
    each article's side features looked up from the catalog's."""
    gen = generator(seed, "train", device)
    P, B = traffic["pool_batches"], traffic["batch"]
    pool = {}
    for f in cfg["query_features"]:
        pool[f["name"]] = torch.randint(1, f["rows"] + 1, (P, B), generator=gen,
                                        device=device, dtype=torch.int32)
    art = draw_articles(probs, P * B, gen, device) + 1
    side = catalog_features(cfg, seed, device)
    for name, ids in side.items():
        pool[name] = ids[art - 1].view(P, B)
    return pool
