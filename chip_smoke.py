#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hm_retrieval_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0] [--repeats 5]

Phases, each of which must pass (a failure raises and exits non-zero):

1. Device: print the card's name and power limit (nvidia-smi), build the
   CUDA kernels from csrc/ with nvcc, print the build time.
2. Kernels against their plain PyTorch versions on the card, at the served
   shapes (a 128-row query block, the 105,542-row H&M catalog padded to L,
   E=128, bf16) for L=2048 (k=1000) and L=1024 (k=100):
   (a) integer-valued inputs in [-4, 4]: exact in bf16 and in fp32 sums,
       with heavy ties; outputs must be bit-identical;
   (b) random normal inputs: values within TOL*max(1,|v|), ids equal
       wherever the competing scores differ by more.
   Then exact_topk against a plain full-score reference (fp32 product of
   the same bf16 operands, stable sort), with timings.
3. Serving at full H&M width: 1,371,980 customers and 105,542 articles,
   E=128, towers [256], k=1000, random weights from --seed. The catalog is
   embedded with collect_catalog, indexed with BruteForceIndex("auto"),
   which must resolve to the kernels, everything is saved and loaded back
   through RetrievalService.load(device="cuda"), and string requests of
   B = 1, 16, 128, 1024 customers (a few OOV) are answered. Answers must
   hold 1000 distinct articles and agree with the plain reference; both
   kernel launch counters must grow during this phase.

Output: per-phase JSON lines, then the card's name and power limit, the
{"kernels": [...]} line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when CUDA is not available.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_CUSTOMERS = 1_371_980
N_ARTICLES = 105_542
N_PRODUCT_TYPES = 130
N_COLOURS = 50
E = 128
Q_BLOCK = 128
SERVE_K = 1000
SERVE_BATCHES = (1, 16, 128, 1024)
TOL = 1e-4  # relative to max(1, |score|): fp32 summation order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, published


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls
    (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pass_bound_ms(B, n_pad, L, thresholds):
    """Least time of one streaming pass: bytes (query block, catalog, the
    four (B, L) outputs, plus two threshold inputs) over HBM bandwidth, or
    the product's operations over the bf16 peak, whichever is larger."""
    nbytes = B * E * 2 + n_pad * E * 2 + 4 * B * L * 4
    if thresholds:
        nbytes += 2 * B * L * 4
    ops = 2 * B * n_pad * E
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare_ranked(got_v, got_i, want_v, want_i, scores):
    """Values within TOL; id mismatches only between scores within 2*TOL.
    Returns (max |value difference| over finite slots, id mismatches)."""
    finite = torch.isfinite(want_v)
    require(
        torch.equal(torch.isfinite(got_v), finite), "unfilled slots differ"
    )
    err = (got_v - want_v)[finite].abs()
    scale = want_v[finite].abs().clamp_min(1.0)
    require(bool((err <= TOL * scale).all()), "values outside tolerance")
    diff = got_i != want_i
    require(not bool((diff & ~finite).any()), "unfilled ids differ")
    rows = diff.nonzero()[:, 0]
    s_got = scores[rows, got_i[diff].long()]
    s_want = scores[rows, want_i[diff].long()]
    gap_ok = (s_got - s_want).abs() <= 2 * TOL * s_want.abs().clamp_min(1.0)
    require(bool(gap_ok.all()), "ids differ between well-separated scores")
    return float(err.max()) if err.numel() else 0.0, int(diff.sum())


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from hm_retrieval_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [
        line.strip()
        for log in _build.build_logs.values()
        for line in log.splitlines()
        if "registers" in line or "spill" in line
    ]
    emit({"build": {"seconds": seconds, "sources": _build.sources(),
                    "ptxas": ptxas}})
    return card


def phase_kernels(gen, dev):
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    stats = {
        "bin_max2_first_round": {"max_abs_err": 0.0, "id_mismatches": 0},
        "bin_max2_round": {"max_abs_err": 0.0, "id_mismatches": 0},
    }
    topk_rows = []
    for k, L in ((SERVE_K, 2048), (100, 1024)):
        require(bt.default_bins(k) == L, f"default_bins({k}) != {L}")
        n_pad = -(-N_ARTICLES // L) * L
        for kind in ("integer", "normal"):
            if kind == "integer":
                q = torch.randint(-4, 5, (Q_BLOCK, E), generator=gen, device=dev)
                c = torch.randint(-4, 5, (N_ARTICLES, E), generator=gen, device=dev)
            else:
                q = torch.randn(Q_BLOCK, E, generator=gen, device=dev)
                c = torch.randn(N_ARTICLES, E, generator=gen, device=dev)
            q = q.to(torch.bfloat16)
            c_pad = torch.zeros(n_pad, E, dtype=torch.bfloat16, device=dev)
            c_pad[:N_ARTICLES] = c.to(torch.bfloat16)
            k1 = bt.bin_max2_first_round(q, c_pad, L, N_ARTICLES)
            p1 = bt.bin_max2_plain(q, c_pad, L, N_ARTICLES)
            # each chain refines with thresholds from its own real round 1
            k2 = bt.bin_max2_round(q, c_pad, k1[2], k1[3], L, N_ARTICLES)
            p2 = bt.bin_max2_plain(q, c_pad, L, N_ARTICLES, p1[2], p1[3])
            torch.cuda.synchronize()
            for name, got, want in (
                ("bin_max2_first_round", k1, p1),
                ("bin_max2_round", k2, p2),
            ):
                if kind == "integer":
                    for g, w in zip(got, want):
                        require(torch.equal(g, w), f"{name} L={L}: integer "
                                "inputs not bit-identical to the plain version")
                    continue
                scores = bt.plain_scores(q, c_pad)
                for vi, ii in ((0, 1), (2, 3)):
                    err, mism = compare_ranked(
                        got[vi], got[ii], want[vi], want[ii], scores
                    )
                    st = stats[name]
                    st["max_abs_err"] = max(st["max_abs_err"], err)
                    st["id_mismatches"] += mism
            emit({"kernel_check": {"L": L, "inputs": kind, "ok": True}})
            if kind != "normal":
                continue
            if L == 2048:  # the served configuration (k=1000)
                b1, by1 = pass_bound_ms(Q_BLOCK, n_pad, L, False)
                b2, by2 = pass_bound_ms(Q_BLOCK, n_pad, L, True)
                stats["bin_max2_first_round"].update(
                    ms=cuda_ms(lambda: bt.bin_max2_first_round(
                        q, c_pad, L, N_ARTICLES), 50),
                    plain_ms=cuda_ms(lambda: bt.bin_max2_plain(
                        q, c_pad, L, N_ARTICLES), 5),
                    bound_ms=b1, bound_by=by1,
                )
                stats["bin_max2_round"].update(
                    ms=cuda_ms(lambda: bt.bin_max2_round(
                        q, c_pad, k1[2], k1[3], L, N_ARTICLES), 50),
                    plain_ms=cuda_ms(lambda: bt.bin_max2_plain(
                        q, c_pad, L, N_ARTICLES, p1[2], p1[3]), 5),
                    bound_ms=b2, bound_by=by2,
                )
            # exact_topk as a whole against the plain full-score reference
            cand = c.to(torch.float32)
            v, i, rounds = bt.exact_topk(q.float(), cand, k, L=L)
            cb = cand.to(torch.bfloat16)

            def reference():
                s = bt.plain_scores(q, cb)
                sv, order = torch.sort(s, dim=1, descending=True, stable=True)
                return s, sv[:, :k], order[:, :k]

            scores, rv, ri = reference()
            err, mism = compare_ranked(v, i, rv, ri, scores)
            topk_rows.append({
                "k": k, "L": L, "B": Q_BLOCK, "N": N_ARTICLES, "E": E,
                "rounds": rounds, "max_abs_err": err, "id_mismatches": mism,
                "ms": cuda_ms(lambda: bt.exact_topk(q.float(), cand, k, L=L), 10),
                "plain_ms": cuda_ms(reference, 5),
                "yardstick_ms": cuda_ms(
                    lambda: torch.topk(torch.matmul(q, cb.T).float(), k), 10
                ),
                "yardstick": "torch.matmul (bf16) + torch.topk over (B, N)",
            })
    emit({"exact_topk": topk_rows})
    return stats


def hm_schema():
    from hm_retrieval_tpu_torch.schema import (
        Feature, ModelConfig, Schema, TrainingConfig,
    )

    def vocab(prefix, n):
        return np.array([f"{prefix}{i:07d}" for i in range(n)])

    features = [
        Feature("customer_id", "categorical", "query", embedding_size=E,
                vocab=vocab("c", N_CUSTOMERS)),
        Feature("article_id", "categorical", "candidate", embedding_size=E,
                vocab=vocab("a", N_ARTICLES)),
        Feature("product_type_name", "categorical", "candidate",
                embedding_size=16, vocab=vocab("pt", N_PRODUCT_TYPES)),
        Feature("colour_group_name", "categorical", "candidate",
                embedding_size=8, vocab=vocab("col", N_COLOURS)),
    ]
    config = ModelConfig(E, ks=[10, 100, SERVE_K], query_tower_units=[256],
                         candidate_tower_units=[256])
    return Schema(features, config, TrainingConfig())


def phase_serving(seed, repeats, dev, workdir):
    from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
    from hm_retrieval_tpu_torch.indices.builder import collect_catalog
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.runners.checkpoint import export_model
    from hm_retrieval_tpu_torch.serving import RetrievalService

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    schema = hm_schema()
    model = TwoTowerModel.create_from_schema(schema, device=dev).init_params(seed)
    tc = schema.training_config
    article_ids = np.arange(1, N_ARTICLES + 1, dtype=np.int32)
    product_type = rng.integers(1, N_PRODUCT_TYPES + 1, N_ARTICLES).astype(np.int32)
    colour = rng.integers(1, N_COLOURS + 1, N_ARTICLES).astype(np.int32)
    bs = tc.candidate_batch_size
    batches = (
        {"article_id": article_ids[s:s + bs],
         "product_type_name": product_type[s:s + bs],
         "colour_group_name": colour[s:s + bs]}
        for s in range(0, N_ARTICLES, bs)
    )

    @torch.no_grad()
    def embed(batch):
        return model.candidate_forward(
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        )

    ids, emb = collect_catalog("article_id", embed, batches, bs)
    index = BruteForceIndex(max(schema.model_config.ks), ids, emb,
                            method="auto", device=dev)
    require(index.method == "pallas", f"auto resolved to {index.method!r}")
    schema.save(str(workdir / "schema"))
    export_model(model, str(workdir / "model"))
    index.save(str(workdir / "index"))
    svc = RetrievalService.load(str(workdir / "schema"), str(workdir / "model"),
                                str(workdir / "index"), device=dev)
    require(svc.index.method == "pallas" and svc.index._engine == "pallas",
            "the loaded index does not run the kernels")
    emit({"serving_setup": {"seconds": time.perf_counter() - t0,
                            "catalog": list(emb.shape),
                            "index_method": svc.index.method}})

    customers = schema.feature("customer_id").vocab
    requests = {}
    for B in SERVE_BATCHES:
        names = list(rng.choice(customers, B))
        for j in range(min(B // 8, 3)):  # a few OOV customers
            names[j * 5 % B] = f"unknown-{j}"
        requests[B] = {"customer_id": names}

    # --- the main path: counts from 0, served requests only -------------
    bt.reset_launches()
    rows, answers = [], {}
    for B in SERVE_BATCHES:
        before = dict(bt.LAUNCHES)
        svc.retrieve(requests[B])  # warm-up (first call builds the lookup)
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            answers[B] = svc.retrieve(requests[B])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        per_batch = {n: (bt.LAUNCHES[n] - before[n]) / (repeats + 1)
                     for n in bt.LAUNCHES}
        rows.append({"B": B, "median_ms": statistics.median(times),
                     "min_ms": min(times), "max_ms": max(times),
                     "launches_per_batch": per_batch})
    launches = dict(bt.LAUNCHES)
    # ---------------------------------------------------------------------
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched while serving: {launches}")

    article_vocab = set(schema.feature("article_id").vocab.tolist())
    emb_real = svc.index.embeddings[: svc.index.num_candidates]
    cb = emb_real.to(torch.bfloat16)
    art_row = {f"a{i:07d}": i for i in range(N_ARTICLES)}  # id i+1 = row i
    for row in rows:
        B = row["B"]
        got = answers[B]
        require(len(got) == B, f"B={B}: {len(got)} answers")
        for ans in got:
            require(len(ans) == SERVE_K and len(set(ans)) == SERVE_K,
                    f"B={B}: an answer is not {SERVE_K} distinct articles")
            require(set(ans) <= article_vocab, f"B={B}: unknown article")
        with torch.no_grad():
            q = svc.embed(svc.encode_query(requests[B]))
        scores = bt.plain_scores(q.to(torch.bfloat16), cb)
        want_v, want_i = torch.sort(scores, dim=1, descending=True, stable=True)
        got_i = torch.tensor([[art_row[a] for a in ans] for ans in got],
                             device=dev)
        got_v = torch.gather(scores, 1, got_i)
        err, mism = compare_ranked(got_v, got_i, want_v[:, :SERVE_K],
                                   want_i[:, :SERVE_K], scores)
        _, _, rounds = bt.exact_topk(q, emb_real, SERVE_K)
        row.update(rounds=rounds, query_blocks=-(-B // Q_BLOCK),
                   max_abs_err_vs_plain=err, id_mismatches=mism,
                   **serve_breakdown(svc, requests[B], repeats))
        emit({"serve": row})
    return launches


def serve_breakdown(svc, raw, repeats):
    """Median host-clock ms of the stages of ``svc.retrieve(raw)``: host
    encode, device (query tower + exact top-k, synchronized), and host
    decode (copy back, id -> string, per-row lists)."""
    stages = {"host_encode_ms": [], "device_ms": [], "host_decode_ms": []}
    for _ in range(repeats):
        t0 = time.perf_counter()
        batch = svc.encode_query(raw)
        t1 = time.perf_counter()
        _, ids = svc.index.topk_from_embeddings(svc.embed(batch))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        svc.schema.candidate_id_feature.decode(ids.cpu().numpy()).tolist()
        t3 = time.perf_counter()
        for name, t in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[name].append(t * 1e3)
    return {name: statistics.median(ts) for name, ts in stages.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import hm_retrieval_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable: {exc}", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    card = phase_device()
    stats = phase_kernels(gen, dev)
    build_root = ROOT / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke-") as d:
        launches = phase_serving(args.seed, args.repeats, dev, Path(d))

    replaces = {
        "bin_max2_first_round":
            "hm_retrieval_tpu/ops/pallas_retrieval.py:276",
        "bin_max2_round": "hm_retrieval_tpu/ops/pallas_retrieval.py:207",
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": "hm_retrieval_tpu_torch/csrc/bin_max2.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": st["max_abs_err"],
            "id_mismatches": st["id_mismatches"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"],
            "library_ms": None,
        }
        for name, st in stats.items()
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
