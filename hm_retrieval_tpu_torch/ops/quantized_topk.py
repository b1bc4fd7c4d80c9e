"""Top-k survivor selection over an int8 catalog: one pass, or exact rounds.

Counterpart of the int8 parts of ``hm_retrieval_tpu/ops/pallas_retrieval.py``:
the three single passes ``bin_max2_scaled_single_pass`` (no fold),
``bin_max2_scaled_fold_pass`` (fold tournament) and
``bin_max2_raw_fold_pass`` (one global scale, raw dot products), the two
rounds passes ``bin_max2_scaled_first_round`` and ``bin_max2_scaled_round``,
``pallas_quantized_topk`` (``quantized_topk``) and
``pallas_quantized_topk_global`` (``quantized_topk_global``).

One pass streams the catalog once. Sub-tile ``u`` is catalog rows
``u*L .. u*L + L - 1`` (bin ``b`` is row ``u*L + b``); ``F`` consecutive
sub-tiles make a chunk. Per (query row, bin) cell, the F scores of a chunk
are max-reduced in increasing slot order, and the winner enters the cell's
lexicographic top-2 under (score desc, index asc). A merge of the 2L cells
per query row gives the survivors. The scores are
``(q . codes) * scale + bias`` (bias 0 or -inf, which also masks invalid and
padded rows), or the raw ``q . codes`` for a catalog with one global scale.

With ``max_rounds > 1`` the survivors are instead the exact top-k of the
dequantized scores: ``bin_topk._topk_rounds`` refines each block of
``Q_BLOCK`` query rows with the rounds passes (F = 1, rows >= n_valid
masked and chunks wholly past them not streamed, round r > 1 below round
r-1's thresholds) until nothing hidden can enter the top k, or
``max_rounds`` passes have run.

The three single passes (per-row scales without and with the fold
tournament, and the raw pass of the global-scale index) and the two rounds
passes are the int8 instances of the exact passes' hand-written CUDA
template (``csrc/bin_max2.cu``), which splits each cell's walk over whole
fold chunks. Beside them are their plain PyTorch versions.
A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises, and adds one to ``LAUNCHES[<kernel>]`` per
launch; while ``utils/debugging.py``'s NaN checks are on, it also raises on a
NaN in its outputs.

Widths. The kernels step through E 16 columns at a time, so the drivers pad
the query and their copies of the codes with zero columns to
``padded_width(E)`` on every device (a zero column adds exact zeros), while
the plan is taken at the real E: L and F decide which rows survive a single
pass, and the JAX package plans with the real E. Up to a padded E of 576
the int8 passes run the template's whole-E instances, past it its K-sliced
walks (the codes in slices of 128 columns, the query resident in shared
memory up to 3,296, re-read with each slice past it; the same fp32
scores); ``KERNEL_MAX_E``
(8,192, above the JAX one pass's widest, 6,672 at k_over = 40) is the
widest padded E the wrappers take, the single passes' and the rounds'
alike.

The plan. Fold F and bin count L decide which rows survive a single pass,
so the port picks what the JAX package picks: ``single_pass_plan`` is the
arithmetic of the JAX package's ``_single_pass_policy``,
``pick_bins(first_pass=True)`` and ``vmem_estimate_first``, with its off-TPU
budget of 15,000,000 bytes. That budget is the JAX package's choice, kept so
that both packages select the same survivors; it is not a rule about
Hopper's memory. The port launches one single pass for the whole batch, not
one per ``q_block``: in a single pass every query row's cells are
independent of the other rows', so ``q_block`` changes the result only
through L, which the plan fixes. The rounds cannot: their stop rule and
their ``max_rounds`` cap hold per block, so they run one loop per block of
``Q_BLOCK`` rows, at the JAX package's rounds L, ``default_bins(k)``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from hm_retrieval_tpu_torch.ops import _build
from hm_retrieval_tpu_torch.ops.bin_topk import (
    BIG_IDX,
    BIN_CHOICES,
    KERNEL_K_STEP,
    KERNEL_MAX_E,
    MAX_ROUNDS,
    NEG_INF,
    Q_BLOCK,
    _padded,
    _topk_rounds,
    _walk,
    bin_cells_plain,
    default_bins,
    padded_width,
    plain_scores,
)
from hm_retrieval_tpu_torch.ops.topk import topk_pair
from hm_retrieval_tpu_torch.utils.debugging import check_outputs

# Bins per block of the int8 kernels (BN of csrc/bin_max2.cu), which the
# wrappers check L against.
INT8_KERNEL_BIN_TILE = 32
# The JAX package's off-TPU VMEM budget (pallas_retrieval.VMEM_BUDGET).
PLAN_BUDGET = 15_000_000
# (q_block, fold) candidates of _single_pass_policy, in its order.
_POLICY = ((256, 16), (512, 8), (1024, 2), (1024, 1), (512, 1), (256, 1),
           (128, 1))
_DEFAULT_Q_BLOCK = 128

# Launches of each CUDA kernel since the last reset_launches().
LAUNCHES: Dict[str, int] = {
    "bin_max2_scaled_single_pass": 0,
    "bin_max2_scaled_fold_pass": 0,
    "bin_max2_raw_fold_pass": 0,
    "bin_max2_scaled_first_round": 0,
    "bin_max2_scaled_round": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# The plan: the JAX package's choice of (q_block, fold, L)
# ---------------------------------------------------------------------------


def _first_pass_bytes(B: int, E: int, L: int, fold: int) -> int:
    """``vmem_estimate_first`` of the JAX package."""
    return 4 * B * L * (fold + 4) + 4 * B * E + 2 * 2 * fold * L * E


def first_pass_bins(
    B: int, E: int, k: int, target: Optional[int] = None, fold: int = 1
) -> Optional[int]:
    """``pick_bins(B, E, k, 2, target, first_pass=True, fold=fold)`` of the
    JAX package at its off-TPU budget: the smallest bin count >= ``target``
    (default 8k) among those >= k that fit, else the largest that fits, or
    None when none does."""
    feasible = [
        L for L in BIN_CHOICES
        if L >= k and _first_pass_bytes(B, E, L, fold) <= PLAN_BUDGET
    ]
    if not feasible:
        return None
    target = 8 * k if target is None else target
    for L in feasible:
        if L >= target:
            return L
    return feasible[-1]


def pallas_feasible(k_eff: int, dim: int) -> bool:
    """``_pallas_feasible`` of the JAX package: a single-pass bin layout
    exists for ``k_eff`` survivors at a 256-row query block."""
    return first_pass_bins(256, dim, k_eff) is not None


def single_pass_plan(
    B: int, E: int, k: int, N: int, fold: Optional[int] = None
) -> Tuple[int, int, Optional[int]]:
    """(q_block, fold, L) that the JAX package's single-pass drivers take
    for a batch of B rows, width E, k survivors over N catalog rows, where
    ``fold`` may be fixed by the caller. L is None when no bin count
    fits."""
    chosen = (_DEFAULT_Q_BLOCK, 1)
    for qb_c, f_c in _POLICY:
        if fold is not None and fold != f_c:
            continue
        if f_c > 1 and f_c * max(k, 512) * 2 > N:
            continue  # the fold chunk would be mostly padding
        if first_pass_bins(min(B, qb_c), E, k, max(k, 512), f_c) is not None:
            chosen = (qb_c, f_c)
            break
    q_block = chosen[0]
    fold = chosen[1] if fold is None else fold
    L = first_pass_bins(min(B, q_block), E, k, max(k, 512), fold)
    return q_block, fold, L


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def single_pass_plain(
    q: torch.Tensor,
    codes: torch.Tensor,
    L: int,
    F: int,
    scales: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
):
    """Plain version of all three passes (``scales`` given: scaled). One
    fp32 product of the operands upcast, then ``*scale + bias``, then the
    chunks in increasing order with the fold tournament and the top-2
    cascade written out element-wise. Returns (m1, a1, m2, a2), each (B, L),
    with catalog rows as ids."""
    B = q.shape[0]
    n_rows = codes.shape[0]
    dev = q.device
    scores = plain_scores(q, codes)
    if scales is not None:
        scores = scores * scales + bias
    scores = scores.view(B, n_rows // L, L)
    m1 = torch.full((B, L), NEG_INF, dtype=torch.float32, device=dev)
    m2 = m1.clone()
    a1 = torch.full((B, L), BIG_IDX, dtype=torch.int32, device=dev)
    a2 = a1.clone()
    bins = torch.arange(L, dtype=torch.int32, device=dev)
    for c in range(n_rows // (F * L)):
        u0 = c * F
        s = scores[:, u0]
        sid = (bins + u0 * L).expand(B, L)
        for t in range(1, F):
            st = scores[:, u0 + t]
            take = st > s
            s = torch.where(take, st, s)
            sid = torch.where(take, bins + (u0 + t) * L, sid)
        gt1 = s > m1
        gt2 = s > m2
        m2 = torch.where(gt1, m1, torch.where(gt2, s, m2))
        a2 = torch.where(gt1, a1, torch.where(gt2, sid, a2))
        m1 = torch.where(gt1, s, m1)
        a1 = torch.where(gt1, sid, a1)
    return m1, a1, m2, a2


def scaled_round_plain(
    q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    bias: torch.Tensor,
    L: int,
    n_valid: int,
    thr_s: Optional[torch.Tensor] = None,
    thr_i: Optional[torch.Tensor] = None,
):
    """Plain version of both rounds passes (thresholds given: a refinement
    round): the fp32 product of the operands upcast, ``*scale + bias``, then
    the cells chunk by chunk (``bin_topk.bin_cells_plain``)."""
    scores = plain_scores(q, codes) * scales + bias
    return bin_cells_plain(scores, L, n_valid, thr_s, thr_i)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "bin_max2_scaled_single_pass": [_P] * 8 + [_I] * 5 + [_P],
    "bin_max2_scaled_fold_pass": [_P] * 8 + [_I] * 6 + [_P],
    "bin_max2_raw_fold_pass": [_P] * 6 + [_I] * 6 + [_P],
    "bin_max2_scaled_first_round": [_P] * 8 + [_I] * 6 + [_P],
    "bin_max2_scaled_round": [_P] * 10 + [_I] * 6 + [_P],
}



def _kernel(name: str):
    fn = getattr(_build.load("bin_max2"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(q, codes, L, F, scales, bias, thr_s=None, thr_i=None):
    if q.dim() != 2 or codes.dim() != 2:
        raise ValueError("q must be (B, E) and codes (N, E)")
    B, E = q.shape
    n_rows, E_c = codes.shape
    if E != E_c:
        raise ValueError(f"embedding widths differ: q {E}, codes {E_c}")
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if L <= 0 or F <= 0 or n_rows <= 0 or n_rows % (F * L):
        raise ValueError(
            f"catalog rows {n_rows} must be a positive multiple of "
            f"F*L = {F}*{L}"
        )
    tensors = [q, codes]
    if scales is not None:
        for name, t in (("scales", scales), ("bias", bias)):
            if t.shape != (n_rows,) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 of shape ({n_rows},)")
        tensors += [scales, bias]
    if thr_s is not None:
        if thr_s.shape != (B, L) or thr_i.shape != (B, L):
            raise ValueError(f"thresholds must be ({B}, {L})")
        if thr_s.dtype != torch.float32 or thr_i.dtype != torch.int32:
            raise TypeError("thr_s must be float32 and thr_i int32")
        tensors += [thr_s, thr_i]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if q.is_cuda:
        if q.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernels take bf16 q, got {q.dtype}")
        if E % KERNEL_K_STEP or E > KERNEL_MAX_E:
            raise ValueError(
                f"the CUDA kernels need E % {KERNEL_K_STEP} == 0 and E <= "
                f"{KERNEL_MAX_E}, got E={E}"
            )
        if L % INT8_KERNEL_BIN_TILE:
            raise ValueError(
                "the CUDA kernels need L % "
                f"{INT8_KERNEL_BIN_TILE} == 0, got {L}"
            )
        for t in tensors:
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("CUDA inputs must be contiguous, 16B-aligned")
    elif q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")


def _launch(name, q, codes, L, tensors=(), ints=(), walk=0):
    """Launch ``name`` on (q, codes, *tensors) into four (B, L) outputs,
    with the int arguments (B, E, catalog rows, L, *ints, walk) (``walk``
    as ``bin_topk``'s wrappers take it)."""
    B, E = q.shape
    with torch.cuda.device(q.device):
        m1 = torch.empty((B, L), dtype=torch.float32, device=q.device)
        a1 = torch.empty((B, L), dtype=torch.int32, device=q.device)
        m2 = torch.empty_like(m1)
        a2 = torch.empty_like(a1)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(name)(
            q.data_ptr(),
            codes.data_ptr(),
            *(t.data_ptr() for t in tensors),
            m1.data_ptr(),
            a1.data_ptr(),
            m2.data_ptr(),
            a2.data_ptr(),
            B,
            E,
            codes.shape[0],
            L,
            *ints,
            _walk(walk),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return check_outputs(name, (m1, a1, m2, a2))


def bin_max2_scaled_single_pass(
    q: torch.Tensor,
    codes_padded: torch.Tensor,
    scales: torch.Tensor,
    bias: torch.Tensor,
    L: int,
    walk: int = 0,
):
    """One pass, no fold: top-2 per (row, bin) of (q . codes)*scale + bias
    over the whole padded catalog (bias -inf on every invalid row). Returns
    (m1, a1, m2, a2), each (B, L): fp32 scores, int32 catalog rows."""
    _check(q, codes_padded, L, 1, scales, bias)
    if not q.is_cuda:
        return check_outputs(
            "bin_max2_scaled_single_pass",
            single_pass_plain(q, codes_padded, L, 1, scales, bias))
    return _launch(
        "bin_max2_scaled_single_pass", q, codes_padded, L, (scales, bias),
        walk=walk,
    )


def bin_max2_scaled_fold_pass(
    q: torch.Tensor,
    codes_padded: torch.Tensor,
    scales: torch.Tensor,
    bias: torch.Tensor,
    L: int,
    F: int,
    walk: int = 0,
):
    """As ``bin_max2_scaled_single_pass``, after an F -> 1 max tournament
    per bin within each chunk of F*L rows."""
    _check(q, codes_padded, L, F, scales, bias)
    if not q.is_cuda:
        return check_outputs(
            "bin_max2_scaled_fold_pass",
            single_pass_plain(q, codes_padded, L, F, scales, bias))
    return _launch(
        "bin_max2_scaled_fold_pass", q, codes_padded, L, (scales, bias), (F,),
        walk=walk,
    )


def bin_max2_raw_fold_pass(q: torch.Tensor, codes: torch.Tensor, L: int, F: int,
                           walk: int = 0):
    """As the fold pass on the raw dot products q . codes: no scale, no
    bias, no mask. ``codes`` holds full chunks of real rows only."""
    _check(q, codes, L, F, None, None)
    if not q.is_cuda:
        return check_outputs("bin_max2_raw_fold_pass",
                             single_pass_plain(q, codes, L, F))
    return _launch("bin_max2_raw_fold_pass", q, codes, L, (), (F,),
                   walk=walk)


def _check_rounds(q, codes_padded, scales, bias, L, n_valid, thr_s, thr_i):
    _check(q, codes_padded, L, 1, scales, bias, thr_s, thr_i)
    if not 0 <= n_valid <= codes_padded.shape[0]:
        raise ValueError(
            f"n_valid={n_valid} outside [0, {codes_padded.shape[0]}]"
        )


def bin_max2_scaled_first_round(
    q: torch.Tensor,
    codes_padded: torch.Tensor,
    scales: torch.Tensor,
    bias: torch.Tensor,
    L: int,
    n_valid: int,
    walk: int = 0,
):
    """Round 1 of the int8 rounds: top-2 per (row, bin) of
    (q . codes)*scale + bias over the rows < n_valid. Returns
    (m1, a1, m2, a2), each (B, L): fp32 scores, int32 catalog rows."""
    _check_rounds(q, codes_padded, scales, bias, L, n_valid, None, None)
    if not q.is_cuda:
        return check_outputs(
            "bin_max2_scaled_first_round",
            scaled_round_plain(q, codes_padded, scales, bias, L, n_valid))
    return _launch(
        "bin_max2_scaled_first_round", q, codes_padded, L, (scales, bias),
        (n_valid,), walk=walk,
    )


def bin_max2_scaled_round(
    q: torch.Tensor,
    codes_padded: torch.Tensor,
    scales: torch.Tensor,
    bias: torch.Tensor,
    thr_s: torch.Tensor,
    thr_i: torch.Tensor,
    L: int,
    n_valid: int,
    walk: int = 0,
):
    """A refinement round of the int8 rounds: as round 1, among elements
    strictly below (thr_s, thr_i) under (score desc, index asc)."""
    _check_rounds(q, codes_padded, scales, bias, L, n_valid, thr_s, thr_i)
    if not q.is_cuda:
        return check_outputs("bin_max2_scaled_round", scaled_round_plain(
            q, codes_padded, scales, bias, L, n_valid, thr_s, thr_i))
    return _launch(
        "bin_max2_scaled_round", q, codes_padded, L,
        (scales, bias, thr_s, thr_i), (n_valid,), walk=walk,
    )


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _resolve_bins(B, E, k, N, L, fold):
    _, fold, planned = single_pass_plan(B, E, k, N, fold)
    if L is None:
        L = planned
        if L is None:
            raise ValueError(
                f"no feasible bin count for B={B}, E={E}, k={k}; use the "
                "scan engine instead"
            )
    if k > L:
        raise ValueError(f"k={k} must be <= L={L}")
    return fold, L


def quantized_topk(
    queries: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
    L: Optional[int] = None,
    max_rounds: int = MAX_ROUNDS,
    compute_dtype: torch.dtype = torch.bfloat16,
    fold: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Top-k survivors of Q @ (codes * scales)^T over the int8 catalog: the
    JAX package's ``pallas_quantized_topk``. Rows >= ``n_valid`` and rows
    with a -inf ``bias`` are never selected; with fewer than k such rows the
    tail slots hold -inf / ``BIG_IDX``.

    ``max_rounds=1``: one pass at ``single_pass_plan``'s fold and L.
    Otherwise the rounds, exact over the dequantized scores for every
    block of ``Q_BLOCK`` query rows whose stop rule holds within
    ``max_rounds`` passes (L = ``default_bins(k)``; ``fold > 1`` raises).

    Operands are cast to ``compute_dtype`` (bf16, fp32 sums); the CUDA
    kernels take bf16 only, and ``torch.float32`` is a CPU-only choice.
    The plan takes the real E; the passes get q and the codes padded with
    zero columns to ``padded_width(E)``.
    Returns (values (B, k) fp32, catalog rows (B, k) int32, rounds = the
    maximum over query blocks, 1 for the single pass)."""
    B, E = queries.shape
    N = codes.shape[0]
    n_valid = N if n_valid is None else n_valid
    if n_valid > N:
        raise ValueError(f"n_valid={n_valid} > catalog rows {N}")
    if k > n_valid:
        raise ValueError(f"k={k} > n_valid={n_valid}")
    rounds = max_rounds != 1
    if rounds:
        if fold is not None and fold > 1:
            raise ValueError(
                "fold > 1 applies to single-pass mode (max_rounds=1) only"
            )
        fold = 1
        if L is None:
            L = default_bins(k)
        if k > L:
            raise ValueError(f"k={k} must be <= L={L}")
    else:
        fold, L = _resolve_bins(B, E, k, N, L, fold)
    chunk = fold * L
    # The rounds mask rows >= n_valid themselves, so they stream only the
    # chunks that hold a valid row; the single pass streams every row.
    n_pad = -(-(n_valid if rounds else N) // chunk) * chunk
    width = padded_width(E)
    codes_p = _padded(codes[:n_pad], n_pad, width)
    scales_p = _padded(scales[:n_pad].to(torch.float32), n_pad)
    bias_p = torch.zeros(n_pad, dtype=torch.float32, device=queries.device)
    if bias is not None:
        bias_p[: min(N, n_pad)] = bias[:n_pad].to(torch.float32)
    q = _padded(queries.to(compute_dtype), B, width)
    if rounds:
        vs, idxs, most = [], [], 0
        for s in range(0, B, Q_BLOCK):
            qb = q[s : s + Q_BLOCK]
            v, i, r = _topk_rounds(
                lambda: bin_max2_scaled_first_round(
                    qb, codes_p, scales_p, bias_p, L, n_valid
                ),
                lambda ts, ti: bin_max2_scaled_round(
                    qb, codes_p, scales_p, bias_p, ts, ti, L, n_valid
                ),
                k,
                max_rounds,
            )
            vs.append(v)
            idxs.append(i)
            most = max(most, r)
        return torch.cat(vs), torch.cat(idxs), most
    # validity and padding ride the bias as -inf: the single pass has no mask
    bias_p[n_valid:] = NEG_INF
    if fold > 1:
        m1, a1, m2, a2 = bin_max2_scaled_fold_pass(
            q, codes_p, scales_p, bias_p, L, fold
        )
    else:
        m1, a1, m2, a2 = bin_max2_scaled_single_pass(
            q, codes_p, scales_p, bias_p, L
        )
    v, i = topk_pair(torch.cat([m1, m2], dim=1), torch.cat([a1, a2], dim=1), k)
    return v, i, 1


def quantized_topk_global(
    queries: torch.Tensor,
    codes: torch.Tensor,
    global_scale: float,
    k: int,
    n_valid: Optional[int] = None,
    L: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    fold: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Top-k of Q @ (codes * global_scale)^T over a catalog with one scale:
    the JAX package's ``pallas_quantized_topk_global``. The full chunks of
    real rows (``n_full``, a multiple of F*L) stream through the raw pass;
    the tail of fewer than F*L rows is scored by one plain fp32 product and
    pre-reduced to its top-k; the k winners are scaled once at the end.
    Nothing is launched when ``n_valid < F*L``. The plan takes the real E;
    the pass gets q and the codes padded to ``padded_width(E)``.
    Returns (values (B, k) fp32, catalog rows (B, k) int32, rounds = 1)."""
    B, E = queries.shape
    N = codes.shape[0]
    n_valid = N if n_valid is None else n_valid
    if n_valid > N:
        raise ValueError(f"n_valid={n_valid} > catalog rows {N}")
    if k > n_valid:
        raise ValueError(f"k={k} > n_valid={n_valid}")
    # the JAX driver plans with N = n_valid
    fold, L = _resolve_bins(B, E, k, n_valid, L, fold)
    chunk = fold * L
    n_full = (n_valid // chunk) * chunk
    q = queries.to(compute_dtype).contiguous()
    vals, ids = [], []
    if n_full:
        width = padded_width(E)
        m1, a1, m2, a2 = bin_max2_raw_fold_pass(
            _padded(q, B, width), _padded(codes[:n_full], n_full, width), L,
            fold,
        )
        vals += [m1, m2]
        ids += [a1, a2]
    T = n_valid - n_full
    if T:
        ts = plain_scores(q, codes[n_full:n_valid].to(compute_dtype))
        ti = torch.arange(
            n_full, n_valid, dtype=torch.int32, device=q.device
        ).expand(B, T)
        if T > k:  # keeps the final merge O(2L + k) wide
            ts, ti = topk_pair(ts, ti, k)
        vals.append(ts)
        ids.append(ti)
    v, i = topk_pair(torch.cat(vals, dim=1), torch.cat(ids, dim=1), k)
    g = torch.tensor(global_scale, dtype=torch.float32, device=q.device)
    return v * g, i, 1
