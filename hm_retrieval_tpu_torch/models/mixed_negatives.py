"""Mixed-negative training: in-batch plus uniformly sampled negatives.

Counterpart of ``hm_retrieval_tpu/models/mixed_negatives.py``. The logits
run over ``[B in-batch | M uniform]`` candidate columns, labels the identity
on the first B. The corrections subtract the log expected count of each
column's candidate among the negatives, both or neither:

    in-batch column j:  log B + logQ[j]
    uniform  column u:  log(M / N)

Uniform negatives are random rows of the candidate catalog, drawn with an
explicit ``torch.Generator``. The JAX package draws them with
``jax.random``; the streams differ by design, and the parity tests pass the
JAX-drawn rows in (``negatives=``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device

Batch = Dict[str, torch.Tensor]


class CandidateCatalog:
    """The unique-candidate feature columns, on the device."""

    def __init__(
        self, columns: Dict[str, np.ndarray], device: DeviceLike = None
    ):
        if not columns:
            raise ValueError("catalog must have at least one column")
        n = {len(v) for v in columns.values()}
        if len(n) != 1:
            raise ValueError("catalog columns must share length")
        self.device = resolve_device(device)
        self.num_candidates = n.pop()
        self.columns = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in columns.items()
        }

    def sample(self, generator: torch.Generator, m: int) -> Batch:
        """``m`` rows drawn uniformly with replacement."""
        idx = torch.randint(
            0,
            self.num_candidates,
            (m,),
            generator=generator,
            device=self.device,
        )
        return {k: v[idx] for k, v in self.columns.items()}


def step_seed(base_seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a fixed function of
    ``(base_seed, step)``, computed on the host."""
    words = np.random.SeedSequence([base_seed, step]).generate_state(2)
    return int(words[0]) << 32 | int(words[1])


def mixed_negatives_loss(
    model,
    batch: Batch,
    catalog: CandidateCatalog,
    generator: Optional[torch.Generator],
    num_uniform: int,
    negatives: Optional[Batch] = None,
) -> torch.Tensor:
    """Sum-reduced softmax CE over [in-batch | uniform] candidates.
    ``negatives``: rows drawn elsewhere, used instead of sampling."""
    q = model.query_forward(batch)  # (B, E)
    c_in = model.candidate_forward(batch)  # (B, E)
    if negatives is None:
        negatives = catalog.sample(generator, num_uniform)
    c_neg = model.candidate_forward(negatives)  # (M, E)

    B = q.shape[0]
    logits_in = q @ c_in.T
    logits_neg = q @ c_neg.T
    # Both corrections or neither: the relative offset between the two
    # column groups is what matters.
    if model.logq is not None:
        log_b = float(np.log(np.float32(B)))
        corr_in = model.logq[batch[model.candidate_id_col].long()] + log_b
        logits_in = logits_in - corr_in[None, :]
        corr_neg = float(
            np.log(np.float32(num_uniform) / np.float32(catalog.num_candidates))
        )
        logits_neg = logits_neg - corr_neg

    logits = torch.cat([logits_in, logits_neg], dim=1)
    log_probs = torch.log_softmax(logits, dim=-1)
    return -log_probs[:, :B].diagonal().sum()
