"""The yardstick: published peaks of one H100 SXM and the operations and
bytes of the work, counted from shapes.

A frozen copy of the port's bound arithmetic (``chip_smoke.py``'s
``pass_bound_ms`` and ``roofline_ms``, which ``bin_max_bench.py`` uses):
one streaming pass of kernels 1-2 reads the query block and the padded
catalog once, writes its (B, L) outputs, and reads the thresholds when it
has them; its least time is the larger of those bytes over HBM bandwidth
and 2·B·n_pad·E operations over the bf16 tensor-core peak. Peaks are
NVIDIA's data sheet's, dense, at the full 700 W.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,  # outside the tensor cores
    "float8": 1979e12,
    "int8": 1979e12,
}


def bin_max_pass_bound_s(B: int, E: int, n_pad: int, L: int, keep: int,
                         thresholds: bool) -> float:
    """Least seconds of one bf16 bin-max pass over B query rows."""
    nbytes = B * E * 2 + n_pad * E * 2 + 2 * keep * B * L * 4
    if thresholds:
        nbytes += 2 * B * L * 4
    return max(nbytes / HBM_BYTES_PER_S,
               2 * B * n_pad * E / PEAK_FLOPS["bfloat16"])


def dense_dims(cfg: dict, tower: str) -> List[Tuple[int, int]]:
    """(d_in, d_out) of each dense layer of a tower."""
    dims = ([sum(f["width"] for f in cfg[f"{tower}_features"])]
            + list(cfg[f"{tower}_tower_units"]) + [cfg["joint_embedding_size"]])
    return list(zip(dims[:-1], dims[1:]))


def matmul_flops(B: int, layers: Iterable[Tuple[int, int]]) -> int:
    return sum(2 * B * d_in * d_out for d_in, d_out in layers)


def retrieve_ideal_s(cfg: dict, B: int) -> float:
    """Least seconds of one served batch: the query tower's matmuls in fp32
    and one 2·B·N·E scoring of the real catalog in bf16."""
    n, E = cfg["n_articles"], cfg["joint_embedding_size"]
    return (matmul_flops(B, dense_dims(cfg, "query")) / PEAK_FLOPS["float32"]
            + 2 * B * n * E / PEAK_FLOPS["bfloat16"])


def train_step_flops(cfg: dict, B: int) -> int:
    """fp32 matmul operations of one in-batch step: each tower's layers
    forward and backward (3 products of 2·B·in·out each, the input's
    gradient included, since it flows to the tables' rows), and 3 of
    2·B·B·E for the logits."""
    towers = sum(3 * matmul_flops(B, dense_dims(cfg, t))
                 for t in ("query", "candidate"))
    return towers + 3 * 2 * B * B * cfg["joint_embedding_size"]


def train_ideal_s(cfg: dict, B: int) -> float:
    return train_step_flops(cfg, B) / PEAK_FLOPS["float32"]
