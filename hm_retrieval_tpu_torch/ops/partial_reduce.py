"""PartialReduce: approximate top-k by bin maxima, as ``lax.approx_max_k``.

Counterpart of ``jax.lax.approx_max_k`` at each of the JAX package's four
calls (``hm_retrieval_tpu/ops/exact_topk.py:63``,
``hm_retrieval_tpu/indices/brute_force.py:238``,
``hm_retrieval_tpu/indices/quantized.py:473``,
``hm_retrieval_tpu/parallel/distributed_topk.py:283``). On a TPU that
operation runs in three steps: XLA picks a power-of-two reduction ``2^r``
and a width ``L`` (``ApproxTopKReductionOutputSize`` at the TPU's lane
tiling, 128 for a rank-2 operand), the hardware reduces each row to ``L``
bin maxima, and the top-k of those maxima is sorted out of them. The port computes what the TPU
computes, on every device: on the CPU, XLA takes an exact fallback instead,
so the JAX package's answers there are the exact top-k (a deliberate
difference, ROADMAP.md Queue 3).

- ``reduction_size(n, k, recall_target)``: XLA's ``(L, r)``.
- ``partial_reduce(x, L, r, split)``: bin ``j`` of a row holds columns
  ``j, j + L, j + 2L, ...``, the row padded with -inf to ``L * 2^r``; each
  bin gives its largest value and, among equal values, its lowest column. A
  bin of -inf alone gives -inf and its first column, which is >= n for a bin
  of padding alone (``ids_at`` maps it to ``MISSING_ID``). The hand-written
  CUDA kernel (``csrc/partial_reduce.cu``) on the card, with each bin's walk
  split into ``split`` segments (``split_plan``'s by default) whose partials
  merge to the one walk's answer bit for bit; ``partial_reduce_plain`` for a
  CPU tensor, and ``partial_reduce_split_plain`` the plain model of the
  split, for the tests. This is the strided bin layout of the repository's
  own bin-max kernels; XLA's TPU layout is not observable off a TPU.
- ``split_plan(B, L, r, sm_count)``: the segments a bin's walk is cut into,
  a power of two: doubled while every thread keeps at least ``MIN_STEPS``
  loads (one round of the kernel's unrolled walk, so a split always saves
  a round of memory latency) and the ``B * L * split`` threads still fit
  the ``sm_count * RESIDENT_THREADS`` the card holds at once, at most
  ``MAX_SPLIT``; 1 where ``B * L`` already fills the card or ``2^r`` is 8
  or less.
- ``approx_max_k(x, k, recall_target, aggregate_to_topk)``: the stable
  descending sort of the ``L`` maxima (``topk_pair``), so ties between bins
  are ordered by bin, not by column. At ``r = 0`` nothing is reduced and
  no kernel launches: the answer is the exact stable top-k. ``L < k``
  raises.

The wrapper runs the plain version only for a CPU tensor; for a CUDA tensor
it launches the kernel or raises, and adds one to ``LAUNCHES`` per launch.
While ``utils/debugging.py``'s NaN checks are on it raises on a NaN in its
outputs.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hm_retrieval_tpu_torch.ops import _build
from hm_retrieval_tpu_torch.ops.topk import topk_pair
from hm_retrieval_tpu_torch.utils.debugging import check_outputs

TILING = 128  # XLA's TPU lane tiling for a rank-2 operand

MAX_SPLIT = 32  # segments a bin: a block of 32 bins x 32 segments
MIN_STEPS = 8  # loads a segment walks at least: the kernel's unrolled round
RESIDENT_THREADS = 2048  # threads one SM of the H100 holds at once

# Launches of the CUDA kernel since the last reset_launches().
LAUNCHES: Dict[str, int] = {"partial_reduce": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reduction_size(n: int, k: int, recall_target: float) -> Tuple[int, int]:
    """(L, r): the bins and the log2 of the reduction XLA picks for a row of
    ``n`` entries, top-``k`` at ``recall_target`` (the expected recall of the
    top-k, ``(1 - 1/L)^(k - 1)``, is about ``recall_target``). ``(n, 0)``
    means no reduction. ``recall_target`` is taken in float32, as XLA takes
    it."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target={recall_target} must be in (0, 1]")
    if n <= TILING:
        return n, 0
    cap = (-(-n // TILING) - 1).bit_length()  # ceil(log2(ceil(n / 128)))
    if k == 1:
        r = cap  # the maximum is exact at any reduction
    elif recall_target == 1.0:
        return n, 0
    else:
        rt = float(np.float32(recall_target))
        m = min(max(int((1.0 - k) / math.log(rt)), TILING), n)
        r = (n // m).bit_length() - 1  # floor(log2(n // m))
        if r == 0:
            return n, 0
        r = min(r, cap)
    return TILING * -(-n // (TILING << r)), r


def partial_reduce_plain(x: torch.Tensor, L: int, r: int):
    """Plain version of the kernel: the bins walked in increasing order
    with a strict >, from (-inf, first column). Returns ((B, L) fp32 values,
    (B, L) int32 columns)."""
    B, n = x.shape
    T = 1 << r
    padded = torch.full((B, L * T), float("-inf"), dtype=torch.float32,
                        device=x.device)
    padded[:, :n] = x
    padded = padded.view(B, T, L)
    cols = torch.arange(L, dtype=torch.int32, device=x.device)
    best = torch.full((B, L), float("-inf"), dtype=torch.float32,
                      device=x.device)
    arg = cols.expand(B, L)
    for t in range(T):
        s = padded[:, t]
        gt = s > best
        best = torch.where(gt, s, best)
        arg = torch.where(gt, cols + t * L, arg)
    return best, arg


def partial_reduce_split_plain(x: torch.Tensor, L: int, r: int, split: int):
    """Plain model of the kernel's split walk, for the tests: each bin's
    ``2^r`` columns cut into ``split`` contiguous segments, each walked in
    increasing order with a strict > from (-inf, its first column), then
    the partials merged in increasing segment order, x beating y iff
    x.v > y.v or (x.v == y.v and x.col < y.col). Equals
    ``partial_reduce_plain`` bit for bit."""
    B, n = x.shape
    T = 1 << r
    _check_split(split, r, limit=T)
    steps = T // split
    padded = torch.full((B, L * T), float("-inf"), dtype=torch.float32,
                        device=x.device)
    padded[:, :n] = x
    padded = padded.view(B, split, steps, L)
    cols = (torch.arange(split, dtype=torch.int32, device=x.device)[:, None]
            * (steps * L)
            + torch.arange(L, dtype=torch.int32, device=x.device))
    best = torch.full((B, split, L), float("-inf"), dtype=torch.float32,
                      device=x.device)
    arg = cols.expand(B, split, L)
    for u in range(steps):
        s = padded[:, :, u]
        gt = s > best
        best = torch.where(gt, s, best)
        arg = torch.where(gt, cols + u * L, arg)
    v, c = best[:, 0], arg[:, 0]
    for seg in range(1, split):
        sv, sc = best[:, seg], arg[:, seg]
        beats = (sv > v) | ((sv == v) & (sc < c))
        v = torch.where(beats, sv, v)
        c = torch.where(beats, sc, c)
    return v, c


def split_plan(B: int, L: int, r: int, sm_count: int) -> int:
    """Segments a bin's walk is cut into for a (B, L) launch over bins of
    ``2^r`` columns on a card of ``sm_count`` SMs: the power of two doubled
    while the ``B * L * split`` threads still fit what the card holds at
    once, up to ``MAX_SPLIT`` and no further than ``MIN_STEPS`` loads a
    thread."""
    T = 1 << r
    most = min(MAX_SPLIT, max(1, T // MIN_STEPS))
    split = 1
    while (2 * split <= most
           and B * L * 2 * split <= sm_count * RESIDENT_THREADS):
        split *= 2
    return split


def _check_split(split: int, r: int, limit: int) -> None:
    if split < 1 or split & (split - 1) or split > min(limit, 1 << r):
        raise ValueError(
            f"split={split} must be a power of two in [1, "
            f"{min(limit, 1 << r)}] at r={r}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "partial_reduce": [_P] * 3 + [_I] * 5 + [_P],
    "partial_reduce_launch_info": [_P],
}


def _kernel(name: str):
    fn = getattr(_build.load("partial_reduce"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, L: int, r: int, split: Optional[int] = None):
    if x.dim() != 2:
        raise ValueError(f"x must be (B, n), got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if L <= 0 or not 0 <= r <= 30:
        raise ValueError(f"need L > 0 and 0 <= r <= 30, got L={L}, r={r}")
    if L << r < x.shape[1] or L << r >= 2**31:
        raise ValueError(
            f"L * 2^r = {L << r} must cover n={x.shape[1]} and stay < 2^31")
    if split is not None:
        _check_split(split, r, limit=MAX_SPLIT)
    if x.is_cuda:
        if not x.is_contiguous():
            raise ValueError("the CUDA kernel takes a contiguous x")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


def launch_info(device=None) -> Dict[str, int]:
    """The kernel's largest registers and local (spilled) bytes a thread
    over its instances, its most threads and shared bytes a block and its
    largest split. Builds the kernel; needs a card."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = _kernel("partial_reduce_launch_info")(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"partial_reduce_launch_info: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "max_threads",
                     "shared_bytes", "max_split"), out))


def partial_reduce(x: torch.Tensor, L: int, r: int,
                   split: Optional[int] = None):
    """The (B, L) bin maxima of (B, n) fp32 ``x`` over bins of ``2^r``
    columns, and their columns: ((B, L) fp32, (B, L) int32). ``split``: the
    segments the kernel cuts each bin's walk into (``split_plan``'s when
    None); the answer is the same at every split."""
    _check(x, L, r, split)
    if not x.is_cuda:
        return check_outputs("partial_reduce", partial_reduce_plain(x, L, r))
    B, n = x.shape
    if split is None:
        split = split_plan(B, L, r, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    with torch.cuda.device(x.device):
        vals = torch.empty((B, L), dtype=torch.float32, device=x.device)
        rows = torch.empty((B, L), dtype=torch.int32, device=x.device)
        if B:
            err = _kernel("partial_reduce")(
                x.data_ptr(), vals.data_ptr(), rows.data_ptr(), B, n, L, r,
                split, torch.cuda.current_stream(x.device).cuda_stream,
            )
            if err != 0:
                raise RuntimeError(
                    f"partial_reduce: kernel launch failed, CUDA error {err}")
            LAUNCHES["partial_reduce"] += 1
    return check_outputs("partial_reduce", (vals, rows))


def approx_max_k(
    x: torch.Tensor,
    k: int,
    recall_target: float = 0.95,
    aggregate_to_topk: bool = True,
):
    """Approximate top-k of each row of (B, n) fp32 ``x``: the stable top-k
    of its ``L`` bin maxima, ((B, k) fp32 values, (B, k) int32 columns).
    With ``aggregate_to_topk=False`` the (B, L) bin maxima and their columns
    in bin order. Raises ``ValueError`` when k > n, or when
    ``recall_target`` leaves fewer than k bins."""
    if x.dim() != 2:
        raise ValueError(f"x must be (B, n), got shape {tuple(x.shape)}")
    B, n = x.shape
    if not 0 < k <= n:
        raise ValueError(f"k={k} must be in [1, n={n}]")
    L, r = reduction_size(n, k, recall_target)
    if L < k:
        raise ValueError(
            f"recall_target={recall_target} reduces n={n} to L={L} bins, "
            f"fewer than k={k}; use a higher recall_target")
    if r == 0:
        _check(x, L, r)  # the device rule holds with no launch too
        vals = x
        cols = torch.arange(n, dtype=torch.int32, device=x.device).expand(B, n)
    else:
        vals, cols = partial_reduce(x, L, r)
    if not aggregate_to_topk:
        return vals, cols
    return topk_pair(vals, cols, k)
