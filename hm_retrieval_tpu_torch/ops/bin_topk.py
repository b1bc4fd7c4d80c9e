"""Exact top-k of Q @ C^T by streaming top-k-per-bin rounds.

Counterpart of the exact path of ``hm_retrieval_tpu/ops/pallas_retrieval.py``
(``bin_max2_first_round``, ``bin_max2_round``, ``bin_max_round``,
``_topk_rounds``, ``_topk_rounds_lockstep``, ``pallas_exact_topk``). Each
round streams the catalog once; bin ``b`` of chunk ``c`` is catalog row
``c*L + b``, and each (query row, bin) cell keeps its lexicographic top-2
(``keep_per_bin=2``) or top-1 under (score desc, index asc). Round 1 takes
every valid row; round r > 1 takes only rows strictly below the threshold
the previous round revealed (that round's weakest element per cell). A merge
keeps a (B, k) leaderboard, and the rounds stop once every hidden element is
provably below the k-th value, which gives the exact top-k values in
1 + (collision depth / keep) rounds, unless ``MAX_ROUNDS`` passes come
first: a query block then returns its leaderboard as it stands, as the JAX
package does.

The three passes are hand-written CUDA kernels (``csrc/bin_max2.cu``, whose
template also holds the int8 rounds and the three int8 single passes of
``ops/quantized_topk.py``). Beside
them is their plain PyTorch version. A wrapper runs the plain version only
for CPU tensors; for CUDA tensors it launches the kernel or raises (a
refused cluster launch included), and adds one to ``LAUNCHES[<kernel>]`` per
launch. While ``utils/debugging.py``'s NaN checks are on, each wrapper also
raises on a NaN in its outputs (the dispatch mode sees no ``ctypes``
launch). The kernels split each cell's chunk walk over the blocks of a
cluster, whose size the launcher picks from the card's occupancy, and over
warps, and merge the parts under the explicit (score desc, index asc)
order, which gives what one walk in increasing chunk order gives:
``bin_cells_plain``. ``_topk_rounds`` takes its two passes as closures, so
it also drives the int8 rounds of ``ops/quantized_topk.py``; it counts its
blocks, rounds and host reads, and times each read, with
``utils/tracing.py`` (``topk_rounds.*``).

The kernels step through E 16 columns at a time, so ``exact_topk`` pads
the query and its catalog copy with zero columns to a multiple of 16 on
every device (``padded_width``): a zero column adds an exact zero to every
score, so no answer changes. Up to a padded E of 512 a pass runs the
template's whole-E instances; past it, up to 3,296, its resident walk (the
block's query tile stays in shared memory, the catalog streams in slices
of 128 columns; a block holds 128, 64 or 32 query rows as the width
allows), and up to ``KERNEL_MAX_E`` (8,192, above the JAX kernels' widest,
7,296 for the exact index at B = 1, k = 10) its re-read walk, which stages
the query's slices with the catalog's. Every walk gives the same fp32
scores bit for bit. A width past ``KERNEL_MAX_E`` is the callers' to route
elsewhere (``BruteForceIndex`` takes its ``"partial_reduce"`` path).

The bin count ``L`` is an explicit argument. Its default, ``default_bins``,
is the value the JAX package's ``pick_bins`` gives for query blocks of at
most 128 rows and E <= 256 (4 * keep_per_bin * k rounded up to a
lane-aligned size), so the port and the reference take the same rounds at
the same ``L``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from hm_retrieval_tpu_torch.ops import _build
from hm_retrieval_tpu_torch.ops.topk import topk_pair
from hm_retrieval_tpu_torch.utils import tracing
from hm_retrieval_tpu_torch.utils.debugging import check_outputs

NEG_INF = float("-inf")
BIG_IDX = 2**31 - 1  # index of a never-filled slot
BIN_CHOICES = (256, 384, 512, 768, 1024, 1536, 2048)
Q_BLOCK = 128  # query rows per refinement loop
MAX_ROUNDS = 8  # streaming passes per query block, at most
# Kernel tiling that the wrappers check for (csrc/bin_max2.cu, every
# instance): bins per block, the k step that E must be a multiple of, and
# the widest padded E the wrappers take (the re-read walk takes any E;
# past this cap the indices route to their other engines).
KERNEL_BIN_TILE = 32
KERNEL_K_STEP = 16
KERNEL_MAX_E = 8192
# The catalog kinds of the template, in the order of its C enum.
CATALOGS = ("bf16", "scaled", "raw")
# The template's walks over E, in the order of its C enum: whole-E
# sub-tiles; K slices of the catalog with the query resident; K slices of
# the catalog and the query. A wrapper's ``walk`` selector is 0 (E and the
# catalog's kind choose), 1 (resident) or 2 (re-read).
WALKS = ("whole", "resident", "reread")

# Launches of each CUDA kernel since the last reset_launches().
LAUNCHES: Dict[str, int] = {
    "bin_max2_first_round": 0,
    "bin_max2_round": 0,
    "bin_max_round": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def padded_width(E: int) -> int:
    """E rounded up to a multiple of the kernels' k step."""
    return -(-E // KERNEL_K_STEP) * KERNEL_K_STEP


def _padded(t: torch.Tensor, rows: int, width: Optional[int] = None):
    """``t`` with zero rows up to ``rows`` and, for a matrix, zero columns
    up to ``width``; ``t`` itself (contiguous) when nothing is added."""
    shape = (rows,) if t.dim() == 1 else (rows, width or t.shape[1])
    if tuple(t.shape) == shape:
        return t.contiguous()
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def default_bins(k: int, keep_per_bin: int = 2) -> int:
    """Smallest lane-aligned L >= 4 * keep_per_bin * k, else the largest
    (2048); L >= k."""
    if k > BIN_CHOICES[-1]:
        raise ValueError(
            f"k={k} exceeds the largest bin count {BIN_CHOICES[-1]}"
        )
    for L in BIN_CHOICES:
        if L >= 4 * keep_per_bin * k:
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


def bin_cells_plain(
    scores: torch.Tensor,
    L: int,
    n_valid: int,
    thr_s: Optional[torch.Tensor] = None,
    thr_i: Optional[torch.Tensor] = None,
    keep: int = 2,
):
    """The cells of one pass over (B, n_pad) fp32 ``scores``, walked chunk
    by chunk in increasing order with the kernels' element-wise steps: rows
    >= n_valid and, with thresholds, rows not strictly below the cell's
    (thr_s, thr_i) score -inf, then the top-2 (or top-1) cascade. Returns
    (m1, a1, m2, a2), or (m1, a1) for ``keep=1``, each (B, L)."""
    B, n_pad = scores.shape
    dev = scores.device
    scores = scores.view(B, n_pad // L, L)
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
        if keep == 2:
            gt2 = s > m2
            m2 = torch.where(gt1, m1, torch.where(gt2, s, m2))
            a2 = torch.where(gt1, a1, torch.where(gt2, flat, a2))
        m1 = torch.where(gt1, s, m1)
        a1 = torch.where(gt1, flat, a1)
    return (m1, a1, m2, a2) if keep == 2 else (m1, a1)


def bin_max2_plain(
    q: torch.Tensor,
    c_padded: torch.Tensor,
    L: int,
    n_valid: int,
    thr_s: Optional[torch.Tensor] = None,
    thr_i: Optional[torch.Tensor] = None,
):
    """Plain version of the top-2 passes (thresholds given: refinement
    round): one product at fixed shape, then ``bin_cells_plain``."""
    return bin_cells_plain(plain_scores(q, c_padded), L, n_valid, thr_s, thr_i)


def bin_max_plain(
    q: torch.Tensor,
    c_padded: torch.Tensor,
    thr_s: torch.Tensor,
    thr_i: torch.Tensor,
    L: int,
    n_valid: int,
):
    """Plain version of the top-1 pass: (m, a), each (B, L)."""
    return bin_cells_plain(
        plain_scores(q, c_padded), L, n_valid, thr_s, thr_i, keep=1
    )


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "bin_max2_first_round": [_P] * 6 + [_I] * 6 + [_P],
    "bin_max2_round": [_P] * 8 + [_I] * 6 + [_P],
    "bin_max_round": [_P] * 6 + [_I] * 6 + [_P],
    "bin_max_launch_info": [_I] * 7 + [_P],
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
        if E % KERNEL_K_STEP or E > KERNEL_MAX_E:
            raise ValueError(
                f"the CUDA kernels need E % {KERNEL_K_STEP} == 0 and E <= "
                f"{KERNEL_MAX_E}, got E={E}"
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


def launch_info(
    B: int, E: int, L: int, keep: int = 2, threshold: bool = True,
    catalog: str = "bf16", fold: int = 1, device=None,
) -> Dict[str, object]:
    """The launch shape the kernel of a pass (keep 1 or 2, with or without
    thresholds; ``catalog`` one of ``CATALOGS``: ``"scaled"``, the per-row
    int8 passes of ``ops/quantized_topk.py``, keep 2: the rounds, or the
    single pass without thresholds; ``"raw"``, the global-scale single
    pass; for both, ``fold`` > 1 selects the tournament's kernel) takes over
    B query rows, as its launcher computes it: the
    cluster size it picks, warps, ring and shared bytes, the compiler's
    registers and local (spilled) bytes a thread, the launch's clusters
    (bin tiles x row groups), ``resident``: the clusters of 1, 2, 4 and
    8 blocks the card holds at once, ``walk``: the walk over E it runs (one
    of ``WALKS``) and ``query_rows``: the query rows a block holds. Builds
    the kernels; needs a card."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 14)()
    with torch.cuda.device(device):
        err = _kernel("bin_max_launch_info")(
            keep, int(threshold), CATALOGS.index(catalog), fold, B, E, L,
            ctypes.addressof(out)
        )
    if err != 0:
        raise RuntimeError(f"bin_max_launch_info: CUDA error {err}")
    keys = ("cluster", "warps_per_block", "warp_groups", "ring_stages",
            "smem_bytes", "registers", "local_bytes", "clusters")
    info = dict(zip(keys, out))
    info["resident"] = {1 << i: out[8 + i] for i in range(4)}
    info["walk"] = WALKS[out[12]]
    info["query_rows"] = out[13]
    return info


def _walk(walk: int) -> int:
    if walk not in (0, 1, 2):
        raise ValueError(f"walk must be 0, 1 or 2, got {walk!r}")
    return int(walk)


def _launch(name, q, c_padded, L, n_valid, thr=(), keep=2, walk=0):
    B, E = q.shape
    n_pad = c_padded.shape[0]
    with torch.cuda.device(q.device):
        outs = []
        for _ in range(keep):
            outs.append(torch.empty((B, L), dtype=torch.float32, device=q.device))
            outs.append(torch.empty((B, L), dtype=torch.int32, device=q.device))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(name)(
            q.data_ptr(),
            c_padded.data_ptr(),
            *(t.data_ptr() for t in thr),
            *(t.data_ptr() for t in outs),
            B,
            E,
            n_pad,
            L,
            n_valid,
            _walk(walk),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return check_outputs(name, tuple(outs))


# ``walk`` (every wrapper of this module and of quantized_topk.py): 1 runs
# bin_max2.cu's resident walk, 2 its re-read walk, at any E where it fits,
# for the checks that hold the walks to one another bit for bit; the
# drivers never pass it, and 0 lets E and the catalog's kind choose. The
# plain version ignores it.


def bin_max2_first_round(
    q: torch.Tensor, c_padded: torch.Tensor, L: int, n_valid: int,
    walk: int = 0,
):
    """Round 1: top-2 per (row, bin) of every row < n_valid. Returns
    (m1, a1, m2, a2), each (B, L): fp32 scores, int32 catalog rows."""
    _check(q, c_padded, L, None, None)
    if not q.is_cuda:
        return check_outputs("bin_max2_first_round",
                             bin_max2_plain(q, c_padded, L, n_valid))
    return _launch("bin_max2_first_round", q, c_padded, L, n_valid,
                   walk=walk)


def bin_max2_round(
    q: torch.Tensor,
    c_padded: torch.Tensor,
    thr_s: torch.Tensor,
    thr_i: torch.Tensor,
    L: int,
    n_valid: int,
    walk: int = 0,
):
    """Refinement round: top-2 per cell among elements strictly below
    (thr_s, thr_i) under (score desc, index asc)."""
    _check(q, c_padded, L, thr_s, thr_i)
    if not q.is_cuda:
        return check_outputs(
            "bin_max2_round",
            bin_max2_plain(q, c_padded, L, n_valid, thr_s, thr_i))
    return _launch(
        "bin_max2_round", q, c_padded, L, n_valid, (thr_s, thr_i),
        walk=walk,
    )


def bin_max_round(
    q: torch.Tensor,
    c_padded: torch.Tensor,
    thr_s: torch.Tensor,
    thr_i: torch.Tensor,
    L: int,
    n_valid: int,
    walk: int = 0,
):
    """Single-keep pass: the top-1 per cell among elements strictly below
    (thr_s, thr_i); round 1 passes +inf / -1. Returns (m, a), each (B, L)."""
    _check(q, c_padded, L, thr_s, thr_i)
    if not q.is_cuda:
        return check_outputs(
            "bin_max_round",
            bin_max_plain(q, c_padded, thr_s, thr_i, L, n_valid))
    return _launch(
        "bin_max_round", q, c_padded, L, n_valid, (thr_s, thr_i), keep=1,
        walk=walk,
    )


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _dominated(nthr_s: torch.Tensor, lead_v: torch.Tensor, k: int):
    """Every hidden element of bin b is <=_lex that bin's next threshold,
    so max_b nthr_s[b] < the k-th value means nothing hidden can enter
    the top-k values (ties at the k-th value cannot change them)."""
    return (nthr_s.amax(dim=1) < lead_v[:, k - 1]).all()


def _revealed(cells):
    """(values, rows, next thr_s, next thr_i) of a pass's cells: both
    slots and the second as the threshold for keep 2, the one slot for
    keep 1."""
    if len(cells) == 2:
        m, a = cells
        return m, a, m, a
    m1, a1, m2, a2 = cells
    return torch.cat([m1, m2], dim=1), torch.cat([a1, a2], dim=1), m2, a2


def _to_host(flags: torch.Tensor):
    """``flags`` read on the host (a wait for the card there): counted as
    ``topk_rounds.host_syncs`` and timed as the span ``topk_rounds.sync``."""
    tracing.count("topk_rounds.host_syncs")
    with tracing.span("topk_rounds.sync"):
        return flags.tolist()


def _topk_rounds(
    first: Callable[[], tuple],
    refine: Callable[[torch.Tensor, torch.Tensor], tuple],
    k: int,
    max_rounds: int = MAX_ROUNDS,
    skip_unimproved: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Refinement loop of one query block: ``first()`` is round 1 and
    ``refine(thr_s, thr_i)`` a round below the given thresholds, each
    returning the pass's cells, (m1, a1, m2, a2) or (m, a). With
    ``skip_unimproved`` a round that reveals nothing above the k-th value
    skips its merge; the host then reads one pair of flags per refinement
    round (improved, done if the leaderboard is kept), and the done flag
    once more after a merge. The stop test holds for every row the passes
    cover. Counts ``topk_rounds.blocks`` (one a call) and
    ``topk_rounds.rounds``."""
    vals, idxs, thr_s, thr_i = _revealed(first())
    lead_v, lead_i = topk_pair(vals, idxs, k)
    done = _to_host(_dominated(thr_s, lead_v, k))
    rounds = 1
    while not done and rounds < max_rounds:
        vals, idxs, thr_s, thr_i = _revealed(refine(thr_s, thr_i))
        improved = True
        if skip_unimproved:
            # A revealed element <= the k-th value cannot change the top-k
            # values, so a round that reveals none above it skips the merge.
            improved, done = _to_host(torch.stack(
                [(vals > lead_v[:, k - 1 : k]).any(),
                 _dominated(thr_s, lead_v, k)]
            ))
        if improved:
            # one width-(k + revealed) sort merges leaderboard and revealed
            lead_v, lead_i = topk_pair(
                torch.cat([lead_v, vals], dim=1),
                torch.cat([lead_i, idxs], dim=1),
                k,
            )
            done = _to_host(_dominated(thr_s, lead_v, k))
        rounds += 1
    tracing.count("topk_rounds.blocks")
    tracing.count("topk_rounds.rounds", rounds)
    return lead_v, lead_i, rounds


def _exact_passes(q, c_padded, L, n_valid, keep_per_bin):
    """(first, refine) of the bf16 passes over the query rows ``q``: the
    top-2 kernels, or for ``keep_per_bin=1`` the top-1 kernel, whose round
    1 is a launch at +inf / -1 thresholds."""
    if keep_per_bin == 2:
        return (
            lambda: bin_max2_first_round(q, c_padded, L, n_valid),
            lambda ts, ti: bin_max2_round(q, c_padded, ts, ti, L, n_valid),
        )
    B = q.shape[0]

    def refine(ts, ti):
        return bin_max_round(q, c_padded, ts, ti, L, n_valid)

    def first():
        return refine(
            torch.full((B, L), float("inf"), device=q.device),
            torch.full((B, L), -1, dtype=torch.int32, device=q.device),
        )

    return first, refine


def exact_topk(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    k: int,
    L: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    keep_per_bin: int = 2,
    lockstep: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Exact top-k of Q @ C^T via streaming bin-max rounds.

    Operands are cast to ``compute_dtype`` (bf16, with fp32 accumulation);
    the CUDA kernels take bf16 only, and ``torch.float32`` is a CPU-only
    choice that runs the plain versions at full precision. Both are padded
    with zero columns to ``padded_width(E)``, on every device. Each pass keeps
    ``keep_per_bin`` (1 or 2) elements per cell. Queries run in blocks of
    ``Q_BLOCK`` rows, each with its own refinement loop of at most
    ``MAX_ROUNDS`` passes; with ``lockstep`` (keep 2, B a multiple of
    ``Q_BLOCK`` when B > ``Q_BLOCK``) all blocks refine together and merge
    at full batch width.

    Past its argument checks the call is the span ``exact_topk``, and the
    cast and pad in it ``exact_topk.prep``.

    Returns (values (B, k) fp32, catalog rows (B, k) int32, rounds = the
    maximum over query blocks)."""
    B, E = queries.shape
    N = candidates.shape[0]
    if keep_per_bin not in (1, 2):
        raise ValueError("keep_per_bin must be 1 or 2")
    if candidates.device != queries.device:
        raise ValueError("queries and candidates must be on one device")
    if L is None:
        L = default_bins(k, keep_per_bin)
    if k > L:
        raise ValueError(f"k={k} must be <= L={L}")
    if k > N:
        raise ValueError(f"k={k} > N={N}")
    lockstep = lockstep and B > Q_BLOCK  # one block: the per-block loop
    if lockstep and (keep_per_bin != 2 or B % Q_BLOCK):
        raise ValueError(
            "lockstep needs keep_per_bin=2 and B divisible by "
            f"{Q_BLOCK} (B={B}, keep_per_bin={keep_per_bin})"
        )
    with tracing.span("exact_topk"):
        with tracing.span("exact_topk.prep"):
            n_pad = -(-N // L) * L
            # zero columns add exact zeros to every score
            width = padded_width(E)
            q = _padded(queries.to(compute_dtype), B, width)
            c_padded = torch.zeros(
                (n_pad, width), dtype=compute_dtype, device=candidates.device
            )
            c_padded[:N, :E] = candidates.to(compute_dtype)
        if lockstep:
            # Every block refines in lockstep: one launch per round covers
            # all B rows (a cell's result does not depend on the other rows,
            # so it equals the JAX package's per-block launches), every round
            # merges at full batch width, and the batch is done when every
            # row is.
            return _topk_rounds(
                *_exact_passes(q, c_padded, L, N, 2), k,
                skip_unimproved=False,
            )
        vs, idxs, rounds = [], [], 0
        for s in range(0, B, Q_BLOCK):
            v, i, r = _topk_rounds(
                *_exact_passes(
                    q[s : s + Q_BLOCK], c_padded, L, N, keep_per_bin
                ),
                k,
            )
            vs.append(v)
            idxs.append(i)
            rounds = max(rounds, r)
        return torch.cat(vs), torch.cat(idxs), rounds
