"""Plain PyTorch reference of the two-tower model, its exact top-k and its
training step.

It follows the model's description and not the program's code: table rows
gathered by index and concatenated in feature order, every dense layer
``relu(x @ W.T + b)`` (the last included, no normalisation), raw
dot-product scores, the in-batch softmax cross-entropy summed over the batch with
``logQ[candidate]`` subtracted from every column, and Adagrad as optax
applies it (accumulator from 0.1, ``p -= lr * g / sqrt(acc + eps)``) to
every leaf, tables included: a dense gradient of a table is zero outside
the batch's rows, so its rows outside the batch do not move. fp32 with
TF32 off, unless a control asks for a lower precision. Imports neither
JAX nor anything of the program.

A dense layer is ``torch.nn.functional.linear``, PyTorch's own, which on
the card adds the bias before the product is rounded. ``x @ W.T + b``
rounds twice and so differs by an fp32 ulp here and there; where that
moves a query's element across a bf16 rounding boundary, the bf16 scores
of that row move by up to 1e-3 of its best score, as much as the int8
index's error (E = 128).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from portbench.compare import first_grad_norms
from portbench.inputs import tower_layout

Params = Dict[str, torch.Tensor]

@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """fp32 products in full fp32 (``tf32=False``) or in TF32 inside the
    block; the previous settings are restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def tower(cfg: dict, params: Params, name: str,
          ids: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, joint) output of tower ``name`` (``"query"``/``"candidate"``)
    for the (B,) id columns ``ids``."""
    feats, dims = tower_layout(cfg, name)
    x = torch.cat([params[f"{name}_tower.embeddings.{f['name']}"][
        ids[f["name"]].long()] for f in feats], dim=1)
    for i in range(len(dims) - 1):
        w = params[f"{name}_tower.dense.{i}.weight"]
        b = params[f"{name}_tower.dense.{i}.bias"]
        x = torch.relu(torch.nn.functional.linear(x, w, b))
    return x


def catalog(cfg: dict, params: Params, side: Dict[str, torch.Tensor],
            block: int = 16384) -> torch.Tensor:
    """(n_articles, joint) candidate-tower embeddings of articles 1..N, in
    blocks of ``block`` articles."""
    n = cfg["n_articles"]
    return torch.cat([
        tower(cfg, params, "candidate", {k: v[s:s + block]
                                         for k, v in side.items()})
        for s in range(0, n, block)])


def scores(q: torch.Tensor, c: torch.Tensor,
           operands: torch.dtype) -> torch.Tensor:
    """(B, N) fp32 scores of ``q`` and ``c`` with both operands rounded to
    ``operands`` first, the product summed in fp32."""
    return q.to(operands).float() @ c.to(operands).float().T


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def loss(cfg: dict, params: Params, batch: Dict[str, torch.Tensor],
         logq: Optional[torch.Tensor]) -> torch.Tensor:
    """SUM-reduced in-batch softmax cross-entropy of one batch."""
    q = tower(cfg, params, "query", batch)
    c = tower(cfg, params, "candidate", batch)
    logits = q @ c.T
    if logq is not None:
        logits = logits - logq[batch[cfg["candidate_id"]].long()][None, :]
    return -torch.log_softmax(logits, dim=1).diagonal().sum()


def adagrad_steps(cfg: dict, params: Params, batches: List[Dict[str, torch.Tensor]],
                  logq: Optional[torch.Tensor], lr: float, acc0: float,
                  eps: float, tf32: bool = False, half_batch: bool = False):
    """Runs one Adagrad step a batch on ``params`` (updated in place).
    Returns (losses, {leaf: norm of the first step's gradient, read from
    the accumulator after it as ``compare.first_grad_norms`` reads the
    program's}). ``half_batch`` is a planted fault: each step sees
    the first half of its batch, the loss scaled by 2 (the mean taken over
    the rest)."""
    acc = {n: torch.full_like(p, acc0) for n, p in params.items()}
    losses, first = [], None
    for batch in batches:
        if half_batch:
            half = next(iter(batch.values())).shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        with matmul_precision(tf32):
            value = loss(cfg, leaves, batch, logq)
            if half_batch:
                value = value * 2
            grads = torch.autograd.grad(value, list(leaves.values()))
        losses.append(float(value.detach()))
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                acc[n].add_(g * g)
                p.sub_(lr * g / torch.sqrt(acc[n] + eps))
        if first is None:
            first = first_grad_norms(acc, acc0)
    return losses, first
