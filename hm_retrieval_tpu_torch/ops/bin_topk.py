"""Exact top-k of Q @ C^T by streaming top-2-per-bin rounds.

Counterpart of the exact path of ``hm_retrieval_tpu/ops/pallas_retrieval.py``
(``bin_max2_first_round``, ``bin_max2_round``, ``_topk_rounds``,
``pallas_exact_topk``). Each round streams the catalog once; bin ``b`` of
chunk ``c`` is catalog row ``c*L + b``, and each (query row, bin) cell keeps
its lexicographic top-2 under (score desc, index asc). Round 1 takes every
valid row; round r > 1 takes only rows strictly below the threshold the
previous round revealed (that round's second element per cell). A merge
keeps a (B, k) leaderboard, and the rounds stop once every hidden element is
provably below the k-th value, which gives the exact top-k values in
1 + (collision depth / 2) rounds.

The two passes are hand-written CUDA kernels (``csrc/bin_max2.cu``). Beside
each is its plain PyTorch version. A wrapper runs the plain version only
for CPU tensors; for CUDA tensors it launches the kernel or raises, and adds
one to ``LAUNCHES[<kernel>]`` per launch.

The bin count ``L`` is an explicit argument. Its default, ``default_bins``,
is the value the JAX package's ``pick_bins`` gives for query blocks of at
most 128 rows and E <= 256 (8 * k rounded up to a lane-aligned size), so the
port and the reference take the same rounds at the same ``L``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch

from hm_retrieval_tpu_torch.ops import _build
from hm_retrieval_tpu_torch.ops.topk import topk_pair

NEG_INF = float("-inf")
BIG_IDX = 2**31 - 1  # index of a never-filled slot
BIN_CHOICES = (256, 384, 512, 768, 1024, 1536, 2048)
Q_BLOCK = 128  # query rows per refinement loop
MAX_ROUNDS = 8  # streaming passes per query block, at most
# Kernel tiling that the wrappers check for (csrc/bin_max2.cu): bins per
# block, and the widest E whose staged tiles fit in shared memory.
KERNEL_BIN_TILE = 32
KERNEL_MAX_E = 512

# Launches of each CUDA kernel since the last reset_launches().
LAUNCHES: Dict[str, int] = {"bin_max2_first_round": 0, "bin_max2_round": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def default_bins(k: int) -> int:
    """Smallest lane-aligned L >= 8k, else the largest (2048); L >= k."""
    if k > BIN_CHOICES[-1]:
        raise ValueError(
            f"k={k} exceeds the largest bin count {BIN_CHOICES[-1]}"
        )
    for L in BIN_CHOICES:
        if L >= 8 * k:
            return L
    return BIN_CHOICES[-1]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_fp32():
    """fp32 matrix products on the card in full fp32 (TF32 off) inside the
    block, whatever the caller's setting; the setting is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def plain_scores(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, N) fp32 scores of the operands upcast to fp32. A product of two
    bf16 values (or of bf16 and an int8 code) is exact in fp32, so only the
    summation order differs from the kernel's. TF32 is switched off for the
    product on the card."""
    with full_fp32():
        return q.to(torch.float32) @ c.to(torch.float32).T


def bin_max2_plain(
    q: torch.Tensor,
    c_padded: torch.Tensor,
    L: int,
    n_valid: int,
    thr_s: Optional[torch.Tensor] = None,
    thr_i: Optional[torch.Tensor] = None,
):
    """Plain version of both passes (thresholds given: refinement round).
    One product at fixed shape, then the chunks in increasing order, the
    same element-wise steps as the kernels."""
    B = q.shape[0]
    n_pad = c_padded.shape[0]
    dev = q.device
    scores = plain_scores(q, c_padded).view(B, n_pad // L, L)
    m1 = torch.full((B, L), NEG_INF, dtype=torch.float32, device=dev)
    m2 = m1.clone()
    a1 = torch.full((B, L), BIG_IDX, dtype=torch.int32, device=dev)
    a2 = a1.clone()
    bins = torch.arange(L, dtype=torch.int32, device=dev)
    for ch in range(n_pad // L):
        s = scores[:, ch]
        flat = bins + ch * L
        ok = (flat < n_valid).expand(B, L)
        if thr_s is not None:
            ok = ok & ((s < thr_s) | ((s == thr_s) & (flat > thr_i)))
        s = torch.where(ok, s, NEG_INF)
        gt1 = s > m1
        gt2 = s > m2
        m2 = torch.where(gt1, m1, torch.where(gt2, s, m2))
        a2 = torch.where(gt1, a1, torch.where(gt2, flat, a2))
        m1 = torch.where(gt1, s, m1)
        a1 = torch.where(gt1, flat, a1)
    return m1, a1, m2, a2


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "bin_max2_first_round": [_P] * 6 + [_I] * 5 + [_P],
    "bin_max2_round": [_P] * 8 + [_I] * 5 + [_P],
}


def _kernel(name: str):
    fn = getattr(_build.load("bin_max2"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(q, c_padded, L, thr_s, thr_i):
    if q.dim() != 2 or c_padded.dim() != 2:
        raise ValueError("q must be (B, E) and c_padded (N_pad, E)")
    B, E = q.shape
    n_pad, E_c = c_padded.shape
    if E != E_c:
        raise ValueError(f"embedding widths differ: q {E}, c {E_c}")
    if L <= 0 or n_pad % L:
        raise ValueError(f"N_pad={n_pad} must be a positive multiple of L={L}")
    tensors = [q, c_padded]
    if thr_s is not None:
        if thr_s.shape != (B, L) or thr_i.shape != (B, L):
            raise ValueError(f"thresholds must be ({B}, {L})")
        if thr_s.dtype != torch.float32 or thr_i.dtype != torch.int32:
            raise TypeError("thr_s must be float32 and thr_i int32")
        tensors += [thr_s, thr_i]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if q.is_cuda:
        if q.dtype != torch.bfloat16 or c_padded.dtype != torch.bfloat16:
            raise TypeError(
                "the CUDA kernels take bf16 q and c_padded, got "
                f"{q.dtype} and {c_padded.dtype}"
            )
        if E % 16 or E > KERNEL_MAX_E:
            raise ValueError(
                f"the CUDA kernels need E % 16 == 0 and E <= {KERNEL_MAX_E}"
                f", got E={E}"
            )
        if L % KERNEL_BIN_TILE:
            raise ValueError(
                f"the CUDA kernels need L % {KERNEL_BIN_TILE} == 0, got {L}"
            )
        for t in tensors:
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("CUDA inputs must be contiguous, 16B-aligned")
    elif q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")


def _launch(name, q, c_padded, L, n_valid, thr=()):
    B, E = q.shape
    n_pad = c_padded.shape[0]
    with torch.cuda.device(q.device):
        m1 = torch.empty((B, L), dtype=torch.float32, device=q.device)
        a1 = torch.empty((B, L), dtype=torch.int32, device=q.device)
        m2 = torch.empty_like(m1)
        a2 = torch.empty_like(a1)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(name)(
            q.data_ptr(),
            c_padded.data_ptr(),
            *(t.data_ptr() for t in thr),
            m1.data_ptr(),
            a1.data_ptr(),
            m2.data_ptr(),
            a2.data_ptr(),
            B,
            E,
            n_pad,
            L,
            n_valid,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return m1, a1, m2, a2


def bin_max2_first_round(
    q: torch.Tensor, c_padded: torch.Tensor, L: int, n_valid: int
):
    """Round 1: top-2 per (row, bin) of every row < n_valid. Returns
    (m1, a1, m2, a2), each (B, L): fp32 scores, int32 catalog rows."""
    _check(q, c_padded, L, None, None)
    if not q.is_cuda:
        return bin_max2_plain(q, c_padded, L, n_valid)
    return _launch("bin_max2_first_round", q, c_padded, L, n_valid)


def bin_max2_round(
    q: torch.Tensor,
    c_padded: torch.Tensor,
    thr_s: torch.Tensor,
    thr_i: torch.Tensor,
    L: int,
    n_valid: int,
):
    """Refinement round: top-2 per cell among elements strictly below
    (thr_s, thr_i) under (score desc, index asc)."""
    _check(q, c_padded, L, thr_s, thr_i)
    if not q.is_cuda:
        return bin_max2_plain(q, c_padded, L, n_valid, thr_s, thr_i)
    return _launch(
        "bin_max2_round", q, c_padded, L, n_valid, (thr_s, thr_i)
    )


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _dominated(nthr_s: torch.Tensor, lead_v: torch.Tensor, k: int):
    """Every hidden element of bin b is <=_lex that bin's next threshold,
    so max_b nthr_s[b] < the k-th value means nothing hidden can enter
    the top-k values (ties at the k-th value cannot change them)."""
    return (nthr_s.amax(dim=1) < lead_v[:, k - 1]).all()


def _topk_rounds(
    q: torch.Tensor,
    c_padded: torch.Tensor,
    k: int,
    L: int,
    n_valid: int,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Refinement loop for ONE query block. The host reads one pair of
    flags per refinement round (improved, done if the leaderboard is
    kept), and the done flag once more after a merge."""
    m1, a1, m2, a2 = bin_max2_first_round(q, c_padded, L, n_valid)
    lead_v, lead_i = topk_pair(
        torch.cat([m1, m2], dim=1), torch.cat([a1, a2], dim=1), k
    )
    thr_s, thr_i = m2, a2
    done = bool(_dominated(thr_s, lead_v, k))
    rounds = 1
    while not done and rounds < MAX_ROUNDS:
        m1, a1, m2, a2 = bin_max2_round(q, c_padded, thr_s, thr_i, L, n_valid)
        vals = torch.cat([m1, m2], dim=1)
        idxs = torch.cat([a1, a2], dim=1)
        # A revealed element <= the k-th value cannot change the top-k
        # values, so a round that reveals none above it skips the merge.
        improved = (vals > lead_v[:, k - 1 : k]).any()
        improved, done = torch.stack(
            [improved, _dominated(m2, lead_v, k)]
        ).tolist()
        if improved:
            # one width-(k + 2L) sort merges leaderboard and revealed
            lead_v, lead_i = topk_pair(
                torch.cat([lead_v, vals], dim=1),
                torch.cat([lead_i, idxs], dim=1),
                k,
            )
            done = bool(_dominated(m2, lead_v, k))
        thr_s, thr_i = m2, a2
        rounds += 1
    return lead_v, lead_i, rounds


def exact_topk(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    k: int,
    L: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Exact top-k of Q @ C^T via streaming bin-max rounds.

    Operands are cast to ``compute_dtype`` (bf16, with fp32 accumulation);
    the CUDA kernels take bf16 only, and ``torch.float32`` is a CPU-only
    choice that runs the plain versions at full precision. Queries run in
    blocks of ``Q_BLOCK`` rows, each with its own refinement loop of at
    most ``MAX_ROUNDS`` passes.

    Returns (values (B, k) fp32, catalog rows (B, k) int32, rounds = the
    maximum over query blocks)."""
    B, E = queries.shape
    N = candidates.shape[0]
    if candidates.device != queries.device:
        raise ValueError("queries and candidates must be on one device")
    if L is None:
        L = default_bins(k)
    if k > L:
        raise ValueError(f"k={k} must be <= L={L}")
    if k > N:
        raise ValueError(f"k={k} > N={N}")
    n_pad = -(-N // L) * L
    q = queries.to(compute_dtype).contiguous()
    c_padded = torch.zeros(
        (n_pad, E), dtype=compute_dtype, device=candidates.device
    )
    c_padded[:N] = candidates.to(compute_dtype)
    vs, idxs, rounds = [], [], 0
    for s in range(0, B, Q_BLOCK):
        v, i, r = _topk_rounds(q[s : s + Q_BLOCK], c_padded, k, L, N)
        vs.append(v)
        idxs.append(i)
        rounds = max(rounds, r)
    return torch.cat(vs), torch.cat(idxs), rounds
