"""Int8-quantized scan index.

Counterpart of ``hm_retrieval_tpu/indices/quantized.py``. The catalog is
stored as symmetric int8 codes with per-row fp32 scales (or one global
scale), padded with zero rows to a multiple of ``chunk`` and a -inf score
bias on the pad rows. A query selects ``k_over`` survivors from the
dequantized scores, then (with ``rescore``) re-scores them against the kept
fp32 rows and returns the exact top-k among them.

Survivor engines (``method``):

- ``"pallas"``: one streaming pass over the int8 catalog
  (``ops/quantized_topk.py``, CUDA kernels on the card), bf16 queries. With
  ``scale_mode="global"`` the raw pass without scale or bias. With
  ``pallas_rounds > 1`` the exact rounds over the dequantized scores
  instead, with at most that many passes per block of 128 query rows (a
  global scale takes them with every row's scale equal to it). The name is
  the JAX package's, kept so artifacts stay interchangeable. It runs the
  ``"scan"`` engine instead, with a log line, where the embedding width,
  padded to a multiple of 16, exceeds the widest its kernels take,
  ``KERNEL_MAX_E`` = 8,192 (the one pass and the rounds alike; the
  JAX single pass's widest is 6,672 at k_over = 40).
- ``"scan"``: per chunk of ``chunk`` rows, int8 queries times int8 codes,
  times the row scale plus the bias, and a running top-``k_over``. The
  chunk product is an fp32 product of the integer-valued operands, exact
  since |sum| <= 127^2 * E < 2^24 for E <= ``SCAN_EXACT_E`` = 1040; wider
  products are summed so over slices of at most 1040 columns and the
  partial sums added in int32, as exact as the JAX package's int32 product.
  The per-chunk top-``k_over`` is ``approx_max_k`` at the index's
  ``recall_target`` (``ops/partial_reduce.py``, the PartialReduce kernel on
  the card), as the JAX package's ``lax.approx_max_k`` on a TPU: the
  survivors are approximate wherever a chunk reduces (on the CPU the JAX
  package's fallback is exact), and exact where nothing reduces (at
  ``oversample * k`` of 4,000 over a 65,536-row chunk, for one).
- ``"auto"``: ``"pallas"`` whenever the survivors fit its bin layout, on
  every device, else ``"scan"``.

The artifact (``index.npz`` with identifiers, codes, scales and optionally
embeddings, plus ``meta.json``) is the JAX package's, so an index saved by
either package loads in the other.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from hm_retrieval_tpu_torch.device import DeviceLike, resolve_device
from hm_retrieval_tpu_torch.indices.artifact import clear_stale, load_index_arrays
from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
from hm_retrieval_tpu_torch.ops.bin_topk import (
    KERNEL_MAX_E,
    full_fp32,
    padded_width,
    plain_scores,
)
from hm_retrieval_tpu_torch.ops.partial_reduce import approx_max_k
from hm_retrieval_tpu_torch.ops.quantized_topk import (
    pallas_feasible,
    quantized_topk,
    quantized_topk_global,
)
from hm_retrieval_tpu_torch.ops.topk import topk_pair

logger = logging.getLogger(__name__)

# fp32 reciprocal of 127: quantization multiplies by it, never divides by
# 127 and never promotes to float64, so host and device builds agree bit
# for bit with each other and with the JAX package.
_INV_127 = np.float32(1.0 / 127.0)
# Widest product the scan engine sums in fp32 at once: 127^2 * 1040 < 2^24,
# so a sum of that many code products is an exact integer.
SCAN_EXACT_E = 1040


def _pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _resolve_method(method: str, k_eff: int, dim: int) -> str:
    """Resolve "auto": "pallas" when ``k_eff`` survivors fit a single-pass
    bin layout, else "scan", on every device."""
    if method != "auto":
        return method
    return "pallas" if pallas_feasible(k_eff, dim) else "scan"


def _engine_of(method: str, dim: int) -> str:
    """The engine a resolved method runs: "pallas" runs "scan", with a log
    line, where the padded width exceeds the widest its kernels take (the
    one pass's and the rounds' alike)."""
    if method == "pallas" and padded_width(dim) > KERNEL_MAX_E:
        logger.warning(
            "embedding width %d (padded to %d) exceeds the int8 kernels' "
            "widest %d; running the 'scan' engine instead of the kernels",
            dim,
            padded_width(dim),
            KERNEL_MAX_E,
        )
        return "scan"
    return method


def _int_scores(qq: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, rows) fp32 qq @ codes^T of integer-valued operands (|x| <= 127),
    exact before the final rounding to fp32: one fp32 product up to
    ``SCAN_EXACT_E`` columns, else exact fp32 products of slices that wide,
    added in int32."""
    dim = codes.shape[1]
    if dim <= SCAN_EXACT_E:
        return plain_scores(qq, codes)
    total = 0
    for a in range(0, dim, SCAN_EXACT_E):
        part = plain_scores(qq[:, a : a + SCAN_EXACT_E],
                            codes[:, a : a + SCAN_EXACT_E])
        total = total + part.to(torch.int32)
    return total.to(torch.float32)


def rescore_survivors(q, embeddings, bias, top_s, top_i, k: int):
    """Exact fp32 rescore of the survivors (rows ``top_i`` of
    ``embeddings``, plus ``bias`` at those rows when given), then the top-k
    among them. A -inf survivor slot (never filled, or a masked row) stays
    -inf, and its row is clamped before the gather."""
    rows_i = top_i.clamp(0, embeddings.shape[0] - 1).long()
    with full_fp32():
        exact = torch.bmm(embeddings[rows_i], q.unsqueeze(2)).squeeze(2)
    if bias is not None:
        exact = exact + bias[rows_i]
    exact = torch.where(torch.isneginf(top_s), float("-inf"), exact)
    return topk_pair(exact, top_i, k)


def shrink_survivors(k_floor: int, k_over: int, dim: int) -> int:
    """Largest pallas-feasible survivor count obtained by halving ``k_over``
    toward ``k_floor``; ``k_over`` itself when feasible, ``k_floor`` when
    nothing larger is."""
    while k_over > k_floor and not pallas_feasible(k_over, dim):
        k_over = max(k_floor, k_over // 2)
    return k_over


def _auto_survivors(method: str, k: int, k_over: int, rescore: bool, dim: int):
    """Resolve (method, k_over). With a rescore downstream, an infeasible
    survivor set is shrunk to the largest feasible one for "auto" and for an
    explicit "pallas" (a saved auto-shrunk index reloads as "pallas" and
    must re-shrink the same way); an explicit "scan" keeps the literal
    oversample."""
    k_eff = k_over if rescore else k
    resolved = _resolve_method(method, k_eff, dim)
    if rescore and not pallas_feasible(k_over, dim):
        if resolved == "pallas" or method == "auto":
            cand = shrink_survivors(k, k_over, dim)
            if cand < k_over and pallas_feasible(cand, dim):
                logger.info(
                    "oversampled survivor set %d is infeasible for the pallas "
                    "engine; shrinking to %d",
                    k_over,
                    cand,
                )
                return "pallas", cand
    return resolved, k_over


def quantize_queries(q: torch.Tensor):
    """Symmetric per-query int8 quantization of the scan engine: (integer-
    valued fp32 codes (B, E), fp32 scales (B, 1)). The JAX package's
    max|q| / 127.0 compiles to a multiply by the fp32 reciprocal."""
    t = q.abs().amax(dim=1, keepdim=True) * torch.tensor(
        _INV_127, device=q.device
    )
    t = torch.clamp_min(t, 1e-30)
    return torch.round(q / t).clamp_(-127, 127), t


def quantize_rows(embeddings: np.ndarray):
    """Symmetric per-row int8 quantization: (int8 codes, fp32 per-row
    scales). Zero rows get scale 1 (codes all 0)."""
    emb = np.asarray(embeddings, np.float32)
    scales = np.max(np.abs(emb), axis=1) * _INV_127
    scales = np.where(scales > 0, scales, 1.0).astype(np.float32)
    codes = np.clip(np.rint(emb / scales[:, None]), -127, 127).astype(np.int8)
    return codes, scales


def quantize_rows_global(embeddings: np.ndarray):
    """Symmetric int8 quantization with one scale for the whole catalog:
    (int8 codes, fp32 scalar scale)."""
    emb = np.asarray(embeddings, np.float32)
    g = np.max(np.abs(emb)) * _INV_127
    g = np.float32(g) if g > 0 else np.float32(1.0)
    codes = np.clip(np.rint(emb / g), -127, 127).astype(np.int8)
    return codes, np.float32(g)


def quantize_pad_device(
    emb: torch.Tensor, n_pad: int, scale_mode: str, keep_fp32: bool
):
    """Torch analogue of the JAX package's ``_quantize_pad_device``, on the
    tensor's own device: the numerics of ``quantize_rows(_global)`` (round
    half to even, clip to +-127, zero rows -> scale 1) plus the padding.
    Returns (codes (n_pad, E) int8, scales (n_pad,) with 0 on pad rows,
    bias (n_pad,) 0 / -inf on pad rows, fp32 table or None, global scale
    or 0)."""
    emb = emb.to(torch.float32)
    n, dim = emb.shape
    inv = torch.tensor(_INV_127, device=emb.device)
    one = torch.ones((), dtype=torch.float32, device=emb.device)
    if scale_mode == "global":
        g = emb.abs().amax() * inv
        g = torch.where(g > 0, g, one)
        scales = g.expand(n)
        g_out = float(g)
    else:
        scales = emb.abs().amax(dim=1) * inv
        scales = torch.where(scales > 0, scales, one)
        g_out = 0.0
    codes = torch.round(emb / scales[:, None]).clamp_(-127, 127).to(torch.int8)
    codes_p = torch.zeros((n_pad, dim), dtype=torch.int8, device=emb.device)
    codes_p[:n] = codes
    scales_p = torch.zeros(n_pad, dtype=torch.float32, device=emb.device)
    scales_p[:n] = scales
    bias = torch.zeros(n_pad, dtype=torch.float32, device=emb.device)
    bias[n:] = float("-inf")
    emb_p = None
    if keep_fp32:
        emb_p = torch.zeros((n_pad, dim), dtype=torch.float32, device=emb.device)
        emb_p[:n] = emb
    return codes_p, scales_p, bias, emb_p, g_out


class QuantizedIndex:
    """Approximate (near-exact) top-k retrieval over an int8 catalog.

    Parameters as the JAX package's ``QuantizedIndex``: ``k``;
    ``identifiers`` (N,) ints and ``embeddings`` (N, E) (a tensor is
    quantized on its device, a numpy array on the host);
    ``oversample`` (survivors ``oversample * k`` before the fp32 rescore);
    ``rescore`` (keep the fp32 table and re-score the survivors); ``chunk``
    (catalog rows per scan step); ``recall_target`` (the scan's per-chunk
    ``approx_max_k``; kept in the artifact); ``method`` ("auto", "scan",
    "pallas"); ``pallas_rounds`` (1: one pass; more: the exact int8 rounds,
    at most that many passes per query block); ``pallas_fold`` (None: the
    plan's);
    ``scale_mode`` ("per_row" or "global"). ``device``: where the index
    lives (None: the card).
    """

    # build_from_batches quantizes the catalog on the tower's device
    # (runners/modelling.py::build_index)
    supports_device_build = True
    PAD_MULTIPLE = 1024

    def __init__(
        self,
        k: int,
        identifiers,
        embeddings,
        oversample: int = 4,
        rescore: bool = True,
        chunk: int = 65536,
        recall_target: float = 0.95,
        method: str = "auto",
        pallas_rounds: int = 1,
        pallas_fold: Optional[int] = None,
        scale_mode: str = "per_row",
        device: DeviceLike = None,
    ):
        if k <= 0:
            raise ValueError("k must be positive")
        if oversample < 1:
            raise ValueError("oversample must be >= 1")
        if not 0.0 < recall_target <= 1.0:
            raise ValueError("recall_target must be in (0, 1]")
        if method not in ("auto", "scan", "pallas"):
            raise ValueError(f"unknown method {method!r}")
        if pallas_rounds < 1:
            raise ValueError("pallas_rounds must be >= 1")
        if scale_mode not in ("per_row", "global"):
            raise ValueError(f"unknown scale_mode {scale_mode!r}")
        if pallas_fold is not None:
            if pallas_fold < 1:
                raise ValueError("pallas_fold must be >= 1")
            if pallas_fold > 1 and pallas_rounds != 1:
                raise ValueError("pallas_fold > 1 requires pallas_rounds == 1")
        self.device = resolve_device(device)
        self.scale_mode = scale_mode
        self.pallas_rounds = int(pallas_rounds)
        self.pallas_fold = None if pallas_fold is None else int(pallas_fold)
        on_device = isinstance(embeddings, torch.Tensor)
        identifiers = np.asarray(identifiers)
        if not on_device:
            embeddings = np.asarray(embeddings, np.float32)
        if identifiers.ndim != 1 or embeddings.ndim != 2:
            raise ValueError("identifiers must be (N,), embeddings (N, E)")
        if len(identifiers) != len(embeddings):
            raise ValueError("identifiers and embeddings length mismatch")
        if identifiers.size and (
            identifiers.min() < -(2**31) or identifiers.max() >= 2**31
        ):
            raise ValueError("identifiers must fit in int32")
        self.k = int(k)
        self.num_candidates = n = len(identifiers)
        if n < k:
            raise ValueError(f"k={k} exceeds number of candidates {n}")
        self.oversample = int(oversample)
        self.rescore = bool(rescore)
        self.recall_target = float(recall_target)

        n_pad = _pad_to_multiple(n, self.PAD_MULTIPLE)
        # Small catalogs: one chunk covering everything; the chunk must
        # cover both k and the oversampled set.
        self.chunk = int(min(chunk, n_pad))
        if self.chunk < self.k:
            raise ValueError(f"chunk={self.chunk} must be >= k={self.k}")
        n_pad = _pad_to_multiple(n, self.chunk)
        self.k_over = int(min(max(self.oversample * self.k, self.k), self.chunk))
        dim = embeddings.shape[1]
        self.method, self.k_over = _auto_survivors(
            method,
            self.k,
            min(self.k_over, n) if self.rescore else self.k_over,
            self.rescore,
            dim,
        )
        self._engine = _engine_of(self.method, dim)

        ids = np.zeros((n_pad,), np.int32)
        ids[:n] = identifiers
        self.identifiers = torch.from_numpy(ids).to(self.device)

        if on_device:
            codes_p, scales_p, bias, emb_p, g = quantize_pad_device(
                embeddings.detach().to(self.device), n_pad, scale_mode,
                self.rescore,
            )
            self.global_scale = g if scale_mode == "global" else None
            self.codes, self.scales, self._score_bias = codes_p, scales_p, bias
            self.embeddings: Optional[torch.Tensor] = emb_p
            return

        if scale_mode == "global":
            codes, g = quantize_rows_global(embeddings)
            scales = np.full((n,), g, np.float32)
            self.global_scale = float(g)
        else:
            codes, scales = quantize_rows(embeddings)
            self.global_scale = None
        codes_p = np.zeros((n_pad, dim), np.int8)
        codes_p[:n] = codes
        scales_p = np.zeros((n_pad,), np.float32)
        scales_p[:n] = scales
        bias = np.zeros((n_pad,), np.float32)
        bias[n:] = -np.inf
        self.codes = torch.from_numpy(codes_p).to(self.device)
        self.scales = torch.from_numpy(scales_p).to(self.device)
        self._score_bias = torch.from_numpy(bias).to(self.device)
        self.embeddings = None
        if self.rescore:
            emb_p = np.zeros((n_pad, dim), np.float32)
            emb_p[:n] = embeddings
            self.embeddings = torch.from_numpy(emb_p).to(self.device)

    # ------------------------------------------------------------------
    @classmethod
    def build_from_batches(
        cls,
        k: int,
        candidate_id_col: str,
        embed_fn: Callable[[Dict[str, np.ndarray]], torch.Tensor],
        batches: Iterable[Dict[str, np.ndarray]],
        batch_size: int,
        device: DeviceLike = None,
        **kwargs,
    ) -> "QuantizedIndex":
        """Embed the catalog with the candidate tower (``collect_catalog_device``,
        as ``BruteForceIndex.build_from_batches``) and quantize it where the
        tower put it. ``device`` is where the index lives (the JAX package's
        boolean ``device`` has no counterpart: the port's build never copies
        the catalog to the host)."""
        from hm_retrieval_tpu_torch.indices.builder import (
            collect_catalog_device,
        )

        identifiers, embeddings = collect_catalog_device(
            candidate_id_col, embed_fn, batches, batch_size
        )
        logger.info(
            "Built int8 quantized index over %d candidates (dim %d)",
            len(identifiers),
            embeddings.shape[1],
        )
        return cls(k, identifiers, embeddings, device=device, **kwargs)

    # ------------------------------------------------------------------
    # Catalog rows -> identifiers; a never-filled slot (BIG_IDX) maps to
    # MISSING_ID. Pad rows carry a -inf bias and k <= num_candidates, so no
    # answer holds one.
    _ids_of = BruteForceIndex._ids_of

    def _rescored(self, q, top_s, top_i, bias: bool):
        return rescore_survivors(
            q, self.embeddings, self._score_bias if bias else None,
            top_s, top_i, self.k,
        )

    def _topk_scan(self, q: torch.Tensor):
        b = q.shape[0]
        qq, t = quantize_queries(q)
        n_pad = self.codes.shape[0]
        top_s = torch.full(
            (b, self.k_over), float("-inf"), dtype=torch.float32, device=q.device
        )
        top_i = torch.zeros((b, self.k_over), dtype=torch.int32, device=q.device)
        for base in range(0, n_pad, self.chunk):
            end = base + self.chunk
            # integer-valued operands: the sums are exact
            s = (
                _int_scores(qq, self.codes[base:end]) * self.scales[base:end]
                + self._score_bias[base:end]
            )
            cs, ci = approx_max_k(s, self.k_over, self.recall_target)
            ci = ci + base
            top_s, top_i = topk_pair(
                torch.cat([top_s, cs], dim=1),
                torch.cat([top_i, ci], dim=1),
                self.k_over,
            )
        if self.embeddings is not None:
            return self._rescored(q, top_s, top_i, bias=True)
        return top_s[:, : self.k] * t, top_i[:, : self.k]

    @torch.no_grad()
    def topk_from_embeddings(self, query_embeddings: torch.Tensor):
        """(B, E) query embeddings -> ((B, k) fp32 scores, (B, k) int32
        ids), best first."""
        q = query_embeddings.to(self.device, torch.float32)
        n = self.num_candidates
        kk = min(self.k_over, n) if self.embeddings is not None else self.k
        if self._engine == "pallas":
            if self.scale_mode == "global" and self.pallas_rounds == 1:
                top_s, top_i, _ = quantized_topk_global(
                    q, self.codes, self.global_scale, kk, n_valid=n,
                    fold=self.pallas_fold,
                )
            else:
                top_s, top_i, _ = quantized_topk(
                    q, self.codes, self.scales, kk, n_valid=n,
                    max_rounds=self.pallas_rounds, fold=self.pallas_fold,
                )
            if self.embeddings is not None:
                top_s, top_i = self._rescored(q, top_s, top_i, bias=False)
        else:
            top_s, top_i = self._topk_scan(q)
        return top_s, self._ids_of(top_i)

    @torch.no_grad()
    def query(self, query_fn: Callable, batch) -> torch.Tensor:
        """Embed queries, select: (B, k) int ids."""
        _, ids = self.topk_from_embeddings(query_fn(batch))
        return ids

    # ------------------------------------------------------------------
    # Persistence: index.npz + meta.json, as the JAX package writes them
    # ------------------------------------------------------------------
    def save(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        clear_stale(dirpath)
        n = self.num_candidates
        arrays = {
            "identifiers": self.identifiers[:n].cpu().numpy(),
            "codes": self.codes[:n].cpu().numpy(),
            "scales": self.scales[:n].cpu().numpy(),
        }
        if self.embeddings is not None:
            arrays["embeddings"] = self.embeddings[:n].cpu().numpy()
        np.savez(os.path.join(dirpath, "index.npz"), **arrays)
        with open(os.path.join(dirpath, "meta.json"), "w") as f:
            json.dump(
                {
                    "k": self.k,
                    "type": "quantized",
                    "oversample": self.oversample,
                    "rescore": self.rescore,
                    "chunk": self.chunk,
                    "recall_target": self.recall_target,
                    "method": self.method,
                    "pallas_rounds": self.pallas_rounds,
                    "pallas_fold": self.pallas_fold,
                    "scale_mode": self.scale_mode,
                },
                f,
            )
        logger.info("Saved quantized index to %s", dirpath)

    @classmethod
    def load(cls, dirpath: str, device: DeviceLike = None) -> "QuantizedIndex":
        """Honors the saved method: a "pallas" index stays "pallas"."""
        with open(os.path.join(dirpath, "meta.json")) as f:
            meta = json.load(f)
        method = meta.get("method", "auto")
        z = load_index_arrays(dirpath)
        if meta.get("rescore", True) and "embeddings" in z:
            idx = cls(
                meta["k"],
                z["identifiers"],
                z["embeddings"],
                oversample=meta.get("oversample", 4),
                rescore=True,
                chunk=meta.get("chunk", 65536),
                recall_target=meta.get("recall_target", 0.95),
                method=method,
                pallas_rounds=meta.get("pallas_rounds", 1),
                pallas_fold=meta.get("pallas_fold"),
                scale_mode=meta.get("scale_mode", "per_row"),
                device=device,
            )
            # the saved codes, whatever requantization would give
            n = idx.num_candidates
            idx.codes[:n] = torch.from_numpy(z["codes"]).to(idx.device)
            idx.scales[:n] = torch.from_numpy(z["scales"]).to(idx.device)
            return idx
        # No fp32 table stored: rebuild from the codes alone.
        idx = cls.__new__(cls)
        idx.device = resolve_device(device)
        idx.k = meta["k"]
        idx.oversample = meta.get("oversample", 4)
        idx.rescore = False
        idx.recall_target = meta.get("recall_target", 0.95)
        idx.pallas_rounds = meta.get("pallas_rounds", 1)
        idx.pallas_fold = meta.get("pallas_fold")
        idx.scale_mode = meta.get("scale_mode", "per_row")
        codes, scales = z["codes"], z["scales"]
        idx.global_scale = (
            float(scales[0]) if idx.scale_mode == "global" else None
        )
        identifiers = z["identifiers"]
        idx.num_candidates = n = len(identifiers)
        n_pad = _pad_to_multiple(n, cls.PAD_MULTIPLE)
        idx.chunk = int(min(meta.get("chunk", 65536), n_pad))
        n_pad = _pad_to_multiple(n, idx.chunk)
        idx.k_over = int(min(max(idx.oversample * idx.k, idx.k), idx.chunk))
        # as the JAX package: resolved with k, not k_over
        idx.method = _resolve_method(method, idx.k, codes.shape[1])
        idx._engine = _engine_of(idx.method, codes.shape[1])
        codes_p = np.zeros((n_pad, codes.shape[1]), np.int8)
        codes_p[:n] = codes
        scales_p = np.zeros((n_pad,), np.float32)
        scales_p[:n] = scales
        bias = np.zeros((n_pad,), np.float32)
        bias[n:] = -np.inf
        ids = np.zeros((n_pad,), np.int32)
        ids[:n] = identifiers
        idx.codes = torch.from_numpy(codes_p).to(idx.device)
        idx.scales = torch.from_numpy(scales_p).to(idx.device)
        idx._score_bias = torch.from_numpy(bias).to(idx.device)
        idx.identifiers = torch.from_numpy(ids).to(idx.device)
        idx.embeddings = None
        return idx
