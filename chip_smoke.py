#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hm_retrieval_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0] [--repeats 5]

Phases, each of which must pass (a failure raises and exits non-zero):

1. Device: print the card's name and power limit (nvidia-smi), build the
   CUDA kernels from csrc/ with nvcc, print the build time.
2. The exact passes' kernels 1, 2 and 8 against their plain PyTorch
   versions on the card, over the 105,542-row H&M catalog padded to L,
   E=128, bf16, at B = 1, 16, 37, 128 query rows and L=2048 (k=1000) and
   L=1024 (k=100), kernel 2 on the thresholds of its own round 1, kernel 8
   at +inf / -1 and then on its own first round's; n_valid = 105,542 ends
   inside a segment of the split chunk walk:
   (a) integer-valued inputs in [-4, 4]: exact in bf16 and in fp32 sums,
       with heavy ties; outputs must be bit-identical;
   (b) random normal inputs: values within TOL*max(1,|v|), ids equal
       wherever the competing scores differ by more.
   Each (L, B) prints the kernels' launch shape (cluster size, warps and
   warp groups per block, ring stages, shared bytes, registers, spilled
   bytes, the launch's clusters and the clusters of 1, 2, 4 and 8 blocks
   resident at once), and the cluster size must be the largest whose whole
   grid is resident at once. Kernels 1-2 are timed at B = 1, 16,
   128, L=2048, beside their bound: device time of 50 launches replayed
   from one CUDA graph ("ms"), and of 50 back-to-back launches by CUDA
   events ("events_ms", which includes the wrappers' host time where that
   is longer). Then exact_topk at B=128 against a
   plain full-score reference (fp32 product of the same bf16 operands,
   stable sort), with timings. Last, kernels 1, 2 and 8 at E = 64 and 256
   (the instantiation that reads the query's fragments from shared memory)
   on integer inputs, bit-identical.
3. Serving at full H&M width: 1,371,980 customers and 105,542 articles,
   E=128, towers [256], k=1000, random weights from --seed. The catalog is
   embedded with collect_catalog_device, indexed with BruteForceIndex("auto"),
   which must resolve to the kernels, everything is saved and loaded back
   through RetrievalService.load(device="cuda"), and string requests of
   B = 1, 16, 128, 1024 customers (a few OOV) are answered. Answers must
   hold 1000 distinct articles and agree with the plain reference; both
   kernel launch counters must grow during this phase.
4. The int8 single-pass kernels against their plain versions on the card,
   on the same catalog as int8 codes padded to 131,072 rows, E=128, at the
   served (fold F, bins L, batch B) of each plan: (1, 2048, 1024),
   (2, 2048, 128), (8, 2048, 16), (8, 2048, 1) and (16, 512, 16); the raw
   (global-scale) pass (kernel 5) over the full chunks of real rows. All
   three (instances of bin_max2.cu's template: kernels 3-4 of its per-row
   int8 kind, kernel 5 of its raw kind) print their launch shape at each
   plan under phase 2's cluster rule. Integer-valued queries must give
   bit-identical outputs, normal ones values within TOL; each kernel is
   timed at each plan by graph ("ms") and by events ("events_ms"). Kernels
   3-5 also run at E = 64, 256 and 576 (the instantiation that reads the
   query from shared memory) on integer inputs, bit-identical. Then
   quantized_topk as a whole against a matmul + topk yardstick.
5. Quantized serving at full H&M width, on phase 3's embedded catalog and
   model: QuantizedIndex(method="auto") must resolve to the kernels with
   2000 survivors, and its build on the card must equal the host
   quantization bit for bit; per-row and global-scale indices are saved and loaded
   back through RetrievalService.load(device="cuda") and answer the same
   requests (B = 1, 16, 128, 1024). The per-row index must launch the fold
   pass once a batch at B <= 128 and the no-fold pass at B = 1024, the
   global-scale index the raw pass once a batch at every B. Answers
   hold 1000 distinct articles, and equal the same driver run with the
   plain passes (fp32 rescore included) wherever the two passes' survivors
   agree; where they differ, only between scores within TOL. Recall
   against the exact fp32 top-1000 is printed, not held to a limit.
6. The rounds kernels against their plain versions on the card, at the
   served shapes: the int8 first and refinement rounds (kernels 6-7, the
   int8 instances of bin_max2.cu's template) over random int8 codes of the
   106,496 rows of the chunks that hold a valid row, as quantized_topk
   streams them (105,542 valid, a -inf bias on 1% of them), at B = 1, 16,
   37, 128 and L = 2048 (k=1000) and L = 1024 (k=100), the refinement
   round on the thresholds the first revealed, each (L, B) printing the
   kernels' launch shape under phase 2's cluster rule; timed at B = 1, 16,
   128, L = 2048, by graph and by events; and at E = 64 and 256 on
   integer inputs. The single-keep pass on the bf16 catalog at L=2048 and
   L=512, at +inf thresholds and at those of a previous round.
   Integer-valued queries must give bit-identical outputs, normal ones
   values within TOL. Then
   the drivers: quantized_topk with 8 rounds at B = 128 and 1024 (2000
   survivors) must answer as its 128-row blocks answer alone, and each
   block whose stop rule held within 8 rounds the exact top-2000 of the
   dequantized scores; exact_topk(keep_per_bin=1) at k = 100 and 1000 must
   equal the same driver on the plain pass, and the exact top-k where its
   rounds < 8; exact_topk(lockstep=True) at B=1024, k=1000 must return the
   per-block driver's ids. Timings beside a matmul + topk yardstick.
7. Quantized serving with the rounds (pallas_rounds=8) at full H&M width,
   on phase 3's catalog and model: per-row and global-scale indices
   (B = 1, 16, 128, 1024 each), saved and loaded back through
   RetrievalService.load(device="cuda"). The int8 rounds kernels must
   launch, the single-pass kernels must not. On every row the survivors
   equal the plain passes' survivors: values within TOL, ids differing only
   between dequantized scores within 2*TOL. Answers hold 1000 distinct
   articles and equal the same driver run with the plain passes (fp32
   rescore included) wherever the survivors agree. Rounds per batch and
   recall against the exact fp32 top-1000, beside phase 5's single-pass
   recall, are printed, not held to a limit.
8. Widths the kernels do not take as they are (phase_widths): over 20,000
   rows of integer-valued embeddings, BruteForceIndex("auto") (k=1000) and
   QuantizedIndex (k=100) with one pass and with 8 rounds at E = 8 and 100
   run the kernels on E padded to 16 and 112 and answer bit-identically to
   the same indices on the CPU; at E = 520 the exact index routes to
   "full" and the rounds to "scan", the one pass runs its kernels at 528,
   and at E = 600 the one pass routes to "scan", each route with a log
   line. The one pass's launch shapes at padded E = 528 and 576 are
   printed.
9. Training at full H&M width (bench.py's model from the port's classes:
   customer_id 1,371,980 x 128, article_id 105,542 x 128, product types
   130 x 16, colours 50 x 8, towers [256], joint 128, logQ from a
   Dirichlet(0.5) popularity with seed 0), B = 512, TrainingConfig's
   defaults (sparse Adagrad, lr 0.05). No TPU kernel lies on this path, and
   the bin-max kernels' counts must stay 0 through it. Synthetic shards
   (numpy, shard_*.npz and the manifest) hold a learnable stream: 4096
   customers, each buying a favourite article 80% of the time. Then:
   (a) at 5,000 customers and 2,000 articles, each path's 3 card steps
       against the port's CPU steps from the same state and batches: the
       losses and every tensor of the state within rtol 1e-4 / atol 1e-5;
       before them, the card model's initial parameters must equal the CPU
       model's of the same seed bit for bit (both draw on the CPU);
   (b) each path through make_single_device_trainer and
       ShardDataset.iter_batches(shuffle) -> device_feed -> step: sparse
       Adagrad with and without a 16-long mean-pooled purchase history,
       dense Adagrad, dense Adam (lr 1e-3), 512 uniform negatives (dense
       Adagrad), and the chunked step at K = 8; 8 warm-up steps, one of them
       under torch.cuda.set_sync_debug_mode("error"), then 48 timed steps
       (CUDA events each); the same steps on batches already on the card
       (what the feed costs); 3 steps under torch.profiler (idle share,
       device operations a step, the top operations); every loss finite and
       the last five lower than the first five; on the sparse paths every
       untouched table and accumulator row bit-unchanged; the step's bound;
   (c) 3 sparse and 3 dense Adagrad steps replayed twice from one saved
       state at full width: every tensor and loss bit-identical;
   (d) 8 single sparse steps against one chunked call of the same 8 steps,
       on the same batches on the card, in turns over 8 rounds.
10. The modelling runner at full H&M width (phase_runner): phase 9's model
   (ks 10, 100, 1000; TrainingConfig's defaults: sparse Adagrad, lr 0.05,
   B = 512, test batches of 2048, candidate batches of 10,000, one epoch)
   from its schema, saved with Schema.save, and shards written with phase
   9's writer: 65,536 rows of the learnable stream to train on (128
   steps), the next 16,384 to test on (8 batches), and all 105,542
   articles with their side features; the same stream as a transactions
   CSV (t_dat, article_id: train rows over 45 days, test rows over the 7
   after, each article as its zero-padded 10-digit H&M id, which the
   schema's vocab holds as read back as an integer). Then:
   (a) modelling_runner(settings) on the card, counts from 0, with the
       default profiler window (steps 20-40): every recall finite and in
       [0, 1], recall@100 higher after the epoch than before, kernels 1-2
       launched inside evaluate and no other kernel, the checkpoint at
       step 128, the exported towers, the index artifact, and the
       profiler's Chrome trace holding the card's kernels; the training
       examples/s it logs include the profiler;
   (b) evaluation_runner(settings) from the checkpoint equals the runner's
       final recall exactly;
   (c) the restored parameters: the checkpoint's bytes, save and restore
       ms; build_index's wall ms, during which (and during
       collect_catalog_device, whose catalog stays on the card) every copy
       from the card to the host is recorded, and all of them together
       must move less than one candidate batch's embeddings; evaluate's
       wall ms and ms a batch, equal to the final recall again; the index's
       save ms; the card's idle share over one evaluate batch (profiler);
   (d) on the first two test batches, the exact index's answers against
       the same index with exact_topk's kernels swapped for their plain
       versions: values within TOL*max(1,|s|), ids swapped only between
       scores within it, equal recall counts;
   (e) the quantized family through build_index + evaluate, counts from
       0: which single-pass kernel launched and how often, and its recall
       beside the exact index's (a reading, not a gate); then, on the first
       two test batches, that kernel (3 or 4, at B = 2048) against its
       plain version on the inputs evaluate gives it: cells within TOL, ids
       differing only between scores within 2*TOL, the answers with the
       plain pass swapped in bit-equal wherever the two passes keep the
       same survivors, and equal recall counts.
   Each kernel's launches in (a) and (e) are added to its count on the
   kernels line.
11. The popularity baseline (phase_baseline) on phase 10's CSV and test
   shards: baseline_modelling_runner(settings) on the card; its static
   artifact must load through load_index as a StaticIndex on the card and
   hold the train rows' 1000 most popular articles counted directly (count
   descending, ties by first appearance; all 1000 in the vocab, so the
   zero-padded ids were read as integers), and its recall must equal the
   share of test rows among the top k. Its recall is printed beside phase
   10's trained model's.
12. The mesh-sharded index at full H&M width (phase_sharded), on phase 10's
   trained catalog (105,542 x 128) and the query tower's first test batch,
   k = 1000, make_mesh(1, 4, devices=[card] * 4): 26,386 rows a shard, the
   last with 2 pad rows. Counts from 0 over the main path:
   DistributedBruteForceIndex("pallas") (kernels 1-2 on [q | 1] against
   [emb | bias], E + 1 = 129 padded to 144) and DistributedQuantizedIndex
   ("pallas") with one pass (kernels 3-4, per-shard plans) and with
   pallas_rounds = 8 (kernels 6-7) at B = 1, 16, 128, 1024, each of whose
   kernels must launch; DistributedBruteForceIndex on a (2, 2) mesh at
   B = 37 (the query padding); RetrievalService.load(mesh,
   distributed_index=True) over phase 10's artifact answering 128
   customers; evaluation_runner(mesh, distributed_index=True). Then, at each
   B: the exact index against the same index on kernels 1-2's plain
   versions and against the single-device index (values within
   TOL*max(1,|s|), ids differing only between scores within TOL); each
   quantized index's per-shard survivors against the plain passes' (within
   TOL, ids only between pass scores within 2*TOL) and its answers
   bit-equal wherever every shard keeps the same survivors, its recall
   against the fp32 top 1000 no lower than the single-device index's by
   more than 0.005; every answer finite, without NaN, pad rows or repeats.
   The last shard's pad rows score exactly -inf through the bias column
   (fp32 of the bf16 operands) and kernel 1 over them returns no NaN and
   none of them. The (2, 2) mesh's answers against the (1, 4) mesh's, the
   sharded service's strings against the single-device service's, as
   above. The sharded artifact evaluation_runner saved holds 4 shard files
   and loads back; over every test batch its recall counts differ from the
   single-device index's by no more than the rows whose top k differ, and
   equal evaluation_runner's and phase 10's. Each index is timed at each B
   beside its single-device counterpart (CUDA events). Its launches are
   added to each kernel's count on the kernels line.
13. Training over a one-process mesh at full H&M width (phase 9's model,
   B = 512, lr 0.05; Adam as phase 9's check takes it), meshes of the one
   card repeated (make_mesh(D, S, devices=[card] * (D * S))); no TPU kernel
   lies on its training paths. Cut: depth only (5 held steps, 3 + 20 timed
   a path; one epoch in (c)).
   (a) each mesh path through make_mesh_trainer, against its single-device
       counterpart through make_single_device_trainer, both from one seed
       (initial states equal bit for bit): data-parallel dense Adagrad,
       dense Adam and 512 uniform negatives (the rows given to both) and
       sparse Adagrad at (4, 1); customer_id and article_id row-sharded,
       dense Adagrad at (2, 2), sparse at (2, 2) and (1, 4). Over 5
       batches, each mesh step starts from the single-device chain's state
       and must land within rtol 1e-4 / atol 1e-5 of its next state, losses
       within rtol 1e-5 (a free-running chain is a reading: a ReLU input
       within rounding of 0 can fall on either side); one step under
       set_sync_debug_mode("error"); two free-running replays of the 5 steps
       bit-identical; pad rows and every row no batch touched bit-unchanged;
       no NaN. make_sharded_lookup's "psum" and "all_to_all" over the
       sharded customer table equal table[ids] bit for bit, and a capacity
       of 1 gives NaN;
   (b) each mesh path's median step ms by CUDA events over 20 steps fed by
       device_feed(mesh=...), examples/s, device ms, idle share and
       operations a step under torch.profiler, peak memory, beside phase
       9's single-device rows of the same call;
   (c) modelling_runner over a (2, 2) mesh on phase 10's stream and schema
       with customer_id and article_id row-sharded and distributed_index,
       counts from 0: recall@10/100/1000 before and after beside phase
       10's, recall@100 rising, kernels 1-2 launched (per shard) and no
       other kernel, examples/s of the epoch (trace off), the exported
       towers in phase 10's unpadded shapes; evaluation_runner over the
       mesh equal to final; a resumed run continuing the step count from
       the checkpoint; the checkpoint's bytes, save and restore ms. Its
       launches are added to each kernel's count on the kernels line.
14. Several processes on the one card (phase_processes): two ranks spawned
   with torch.multiprocessing, each joining a gloo group through
   initialize_multihost (a file:// rendezvous; NCCL refuses two ranks on one
   device) on cuda:0, each passing make_mesh its own two cells; the parent
   waits PROC_TIMEOUT seconds and kills both ranks past it, and a rank that
   fails or writes no result fails the phase. Phase 10's width and weights.
   Each rank's launches are counted from 0 around (a) and (b) and added,
   over both ranks, to the kernels line. Cut: depth only (3 held steps a
   path; sparse: 3-step replays, 10 timed, 3 profiled; dense: 1-step
   replays, 2 timed, 1 profiled).
   (a) phase 12's exact and one-pass sharded indices over a (1, 4) mesh,
       rank r holding shards 2r and 2r + 1 (kernels 1-2, 3-4 per shard),
       at B = 1, 16, 128, 1024: values and ids bit-identical to phase 12's
       one-process S = 4 indices on the same queries, on both ranks; ms a
       serve by CUDA events beside phase 12's, the exchange's bytes and ms;
   (b) evaluation_runner over a (2, 2) mesh, data row r on rank r, over
       phase 10's checkpoint and stream (1024 test rows a rank a batch):
       recall@10/100/1000 on both ranks equal to phase 10's, and with
       distributed_index equal to the one-process (2, 2) runner's;
       to_local() of the collectively saved sharded index gives both ranks
       the same catalog;
   (c) phase 13's data-parallel sparse and dense Adagrad at (4, 1) (data
       rows 0-1 on rank 0, each rank fed its 256 rows) and row-sharded
       sparse at (1, 4) (the model axis over the ranks, both fed the whole
       batch): each step from the single-device chain's state within rtol
       1e-4 / atol 1e-5, losses within 1e-6 relative, the replicated state
       bit-identical across the ranks after every step, replays
       bit-identical, untouched and pad rows unchanged; step ms by CUDA
       events beside phase 13's, 1-3 steps under torch.profiler on rank 0,
       the bytes each step sends through the group, peak GB per rank.
   (d) modelling_runner over a (2, 2) mesh, data row r on rank r, both id
       tables row-sharded and the sharded index, on phase 13's schema and
       phase 10's stream (one epoch, 512 / 2 rows a rank a step): the same
       recall on both ranks, before any step phase 13's initial recall
       exactly, recall@100 rising; its final recall beside phase 13's and
       beside phase 13's run reshuffled (shuffle_buffer_size 8192), since
       the ranks' own batch order moves it;
       the group's checkpoint restored by one process over a (2, 2) mesh
       gives the group's final recall, and phase 13's one-process checkpoint
       restored by the group its resumed run's; the group's index loads in
       one process.

Output: per-phase JSON lines and each phase's seconds, then the card's name
and power limit, the
{"kernels": [...]} line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when CUDA is not available.
"""

import argparse
import contextlib
import dataclasses
import itertools
import json
import logging
import shutil
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
KERNEL_BATCHES = (1, 16, 37, 128)  # B of phase 2's kernel checks
TIMED_BATCHES = (1, 16, 128)  # B at which phase 2 times kernels 1-2
TOL = 1e-4  # relative to max(1, |score|): fp32 summation order
N_PAD_Q = 131_072  # the H&M catalog padded to the quantized index's chunk
# (fold F, bins L, batch B) of the single-pass plans at the served shapes:
# k_over = 2000 at B = 1024, 128, <= 16, and k <= 100 at any B
QUANT_PLANS = ((1, 2048, 1024), (2, 2048, 128), (8, 2048, 16), (8, 2048, 1),
               (16, 512, 16))
SURVIVORS = 2000  # k_over of the served quantized index
MAX_ROUNDS = 8  # the drivers' cap on passes per query block
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


def graph_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` calls captured in one
    CUDA graph and replayed 5 times, after a warm-up on a side stream: the
    kernels' own time, without the host's cost of launching them (which
    back-to-back timing by ``cuda_ms`` includes once it exceeds the
    kernel's)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def pass_bound_ms(B, n_pad, L, thresholds, outputs=4):
    """Least time of one streaming pass: bytes (query block, catalog, the
    (B, L) outputs, plus two threshold inputs) over HBM bandwidth, or the
    product's operations over the bf16 peak, whichever is larger."""
    nbytes = B * E * 2 + n_pad * E * 2 + outputs * B * L * 4
    if thresholds:
        nbytes += 2 * B * L * 4
    return roofline_ms(nbytes, 2 * B * n_pad * E)


def roofline_ms(nbytes, ops):
    """(ms, what bounds it): the larger of bytes over HBM bandwidth and
    bf16 operations over the tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare_ranked(got_v, got_i, want_v, want_i, scores, gap=2 * TOL):
    """Values within TOL; id mismatches only between scores within ``gap``
    (relative to max(1, |score|)). Returns (max |value difference| over
    finite slots, id mismatches)."""
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
    gap_ok = (s_got - s_want).abs() <= gap * s_want.abs().clamp_min(1.0)
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
        if "entry function" in line or "registers" in line or "spill" in line
    ]
    emit({"build": {"seconds": seconds, "sources": _build.sources(),
                    "ptxas": ptxas}})
    return card


def phase_kernels(gen, dev):
    """Kernels 1, 2 and 8 against their plain versions at every (B, L) of
    KERNEL_BATCHES x (2048, 1024); kernels 1-2 timed at TIMED_BATCHES."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    names = ("bin_max2_first_round", "bin_max2_round", "bin_max_round")
    stats = {n: {"max_abs_err": 0.0, "id_mismatches": 0} for n in names}
    for n in names[:2]:
        stats[n]["shapes"] = []
    topk_rows = []
    for k, L in ((SERVE_K, 2048), (100, 1024)):
        require(bt.default_bins(k) == L, f"default_bins({k}) != {L}")
        n_pad = -(-N_ARTICLES // L) * L
        for B in KERNEL_BATCHES:
            infos = {n: bt.launch_info(B, E, L, keep=1 if n == names[2] else 2,
                                       threshold=n != names[0], device=dev)
                     for n in names}
            check_clusters(infos, L, B)
        inf_s = torch.full((Q_BLOCK, L), float("inf"), device=dev)
        inf_i = torch.full((Q_BLOCK, L), -1, dtype=torch.int32, device=dev)
        for kind in ("integer", "normal"):
            q_all = random_rows(gen, dev, kind, Q_BLOCK)
            c_pad = torch.zeros(n_pad, E, dtype=torch.bfloat16, device=dev)
            c_pad[:N_ARTICLES] = random_rows(gen, dev, kind, N_ARTICLES)
            for B in KERNEL_BATCHES:
                q = q_all[:B]
                k1 = bt.bin_max2_first_round(q, c_pad, L, N_ARTICLES)
                p1 = bt.bin_max2_plain(q, c_pad, L, N_ARTICLES)
                # each chain refines with thresholds from its own round 1
                k2 = bt.bin_max2_round(q, c_pad, k1[2], k1[3], L, N_ARTICLES)
                p2 = bt.bin_max2_plain(q, c_pad, L, N_ARTICLES, p1[2], p1[3])
                k8 = bt.bin_max_round(q, c_pad, inf_s[:B], inf_i[:B], L,
                                      N_ARTICLES)
                p8 = bt.bin_max_plain(q, c_pad, inf_s[:B], inf_i[:B], L,
                                      N_ARTICLES)
                k8r = bt.bin_max_round(q, c_pad, *k8, L, N_ARTICLES)
                p8r = bt.bin_max_plain(q, c_pad, *p8, L, N_ARTICLES)
                torch.cuda.synchronize()
                for name, got, want in ((names[0], k1, p1), (names[1], k2, p2),
                                        (names[2], k8, p8),
                                        (names[2], k8r, p8r)):
                    hold_cells(stats[name], f"{name} L={L} B={B}", kind, got,
                               want, lambda: bt.plain_scores(q, c_pad))
                emit({"kernel_check": {"L": L, "B": B, "inputs": kind,
                                       "ok": True}})
                if kind != "normal" or L != 2048 or B not in TIMED_BATCHES:
                    continue
                # the served configuration (k=1000): times beside the bound
                for name, thr, plain in ((names[0], (), ()),
                                         (names[1], k1[2:], p1[2:])):
                    bound, by = pass_bound_ms(B, n_pad, L, bool(thr))

                    def launch():
                        return getattr(bt, name)(q, c_pad, *thr, L,
                                                 N_ARTICLES)

                    row = {
                        "L": L, "B": B, "rows": n_pad,
                        "ms": graph_ms(launch, 50),
                        "events_ms": cuda_ms(launch, 50),
                        "plain_ms": cuda_ms(lambda: bt.bin_max2_plain(
                            q, c_pad, L, N_ARTICLES, *plain), 5),
                        "bound_ms": bound, "bound_by": by,
                    }
                    stats[name]["shapes"].append(row)
                    if B == Q_BLOCK:
                        stats[name].update({key: row[key] for key in (
                            "ms", "events_ms", "plain_ms", "bound_ms",
                            "bound_by")})
            if kind != "normal":
                continue
            # exact_topk as a whole against the plain full-score reference
            q = q_all
            cand = c_pad[:N_ARTICLES].float()
            v, i, rounds = bt.exact_topk(q.float(), cand, k, L=L)
            cb = c_pad[:N_ARTICLES]

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
    # the other instantiation (A fragments read from shared memory), at
    # widths other than E = 128, on integer inputs
    for width in (64, 256):
        L, n_pad, n_valid, B = 1024, 16384, 16000, 37
        q = torch.randint(-4, 5, (B, width), generator=gen,
                          device=dev).to(torch.bfloat16)
        c_pad = torch.randint(-4, 5, (n_pad, width), generator=gen,
                              device=dev).to(torch.bfloat16)
        inf_s = torch.full((B, L), float("inf"), device=dev)
        inf_i = torch.full((B, L), -1, dtype=torch.int32, device=dev)
        k1 = bt.bin_max2_first_round(q, c_pad, L, n_valid)
        p1 = bt.bin_max2_plain(q, c_pad, L, n_valid)
        k8 = bt.bin_max_round(q, c_pad, inf_s, inf_i, L, n_valid)
        p8 = bt.bin_max_plain(q, c_pad, inf_s, inf_i, L, n_valid)
        checks = ((names[0], k1, p1),
                  (names[1], bt.bin_max2_round(q, c_pad, k1[2], k1[3], L,
                                               n_valid),
                   bt.bin_max2_plain(q, c_pad, L, n_valid, p1[2], p1[3])),
                  (names[2], k8, p8))
        torch.cuda.synchronize()
        for name, got, want in checks:
            hold_cells(stats[name], f"{name} E={width}", "integer", got, want,
                       None)
        emit({"kernel_check": {"E": width, "L": L, "B": B,
                               "inputs": "integer", "ok": True}})
    return stats


def check_clusters(infos, L, B, **where):
    """Each kernel's launch shape at (L, B) holds the launcher's rule: the
    largest cluster size whose whole grid the card holds at once. Prints
    the shapes as one kernel_launch line, with ``where`` (e.g. the fold)."""
    for n, info in infos.items():
        fits = [c for c in (2, 4, 8)
                if info["resident"][c] >= info["clusters"]]
        require(info["cluster"] == max(fits, default=1),
                f"{n} L={L} B={B}: cluster {info['cluster']}, "
                f"resident {info['resident']}")
    emit({"kernel_launch": {"L": L, "B": B, **where, **infos}})


def hm_schema(n_customers=N_CUSTOMERS, n_articles=N_ARTICLES, logq=None,
              article_vocab=None):
    from hm_retrieval_tpu_torch.schema import (
        Feature, ModelConfig, Schema, TrainingConfig,
    )

    def vocab(prefix, n):
        return np.array([f"{prefix}{i:07d}" for i in range(n)])

    if article_vocab is None:
        article_vocab = vocab("a", n_articles)
    features = [
        Feature("customer_id", "categorical", "query", embedding_size=E,
                vocab=vocab("c", n_customers)),
        Feature("article_id", "categorical", "candidate", embedding_size=E,
                vocab=article_vocab),
        Feature("product_type_name", "categorical", "candidate",
                embedding_size=16, vocab=vocab("pt", N_PRODUCT_TYPES)),
        Feature("colour_group_name", "categorical", "candidate",
                embedding_size=8, vocab=vocab("col", N_COLOURS)),
    ]
    config = ModelConfig(E, ks=[10, 100, SERVE_K], query_tower_units=[256],
                         candidate_tower_units=[256])
    return Schema(features, config, TrainingConfig(), logq=logq)


def phase_serving(seed, repeats, dev, workdir):
    from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
    from hm_retrieval_tpu_torch.indices.builder import collect_catalog_device
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

    ids, emb = collect_catalog_device("article_id", embed, batches, bs)
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
    require(launches["bin_max2_first_round"] > 0
            and launches["bin_max2_round"] > 0
            and launches["bin_max_round"] == 0,
            f"the exact path launched {launches}")

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
    shared = {"ids": ids, "emb": emb, "requests": requests,
              "schema_dir": workdir / "schema", "model_dir": workdir / "model",
              "article_vocab": article_vocab, "art_row": art_row}
    return launches, shared


def serve_breakdown(svc, raw, repeats):
    """Medians over ``repeats`` calls that do what ``svc.retrieve(raw)``
    does, stage by stage: host encode (host clock); device, the query tower
    and the top-k (CUDA events from before the tower to after the top-k's
    last operation, host syncs inside it included); host decode (host clock
    from there: copy back, id -> string, per-row lists); and each call's
    total (host clock). Stages and totals come from the same calls."""
    stages = {"host_encode_ms": [], "device_ms": [], "host_decode_ms": [],
              "stages_total_ms": []}
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        batch = svc.encode_query(raw)
        t1 = time.perf_counter()
        start.record()
        _, ids = svc.index.topk_from_embeddings(svc.embed(batch))
        end.record()
        end.synchronize()
        t2 = time.perf_counter()
        svc.schema.candidate_id_feature.decode(ids.cpu().numpy()).tolist()
        t3 = time.perf_counter()
        for name, ms in zip(stages, ((t1 - t0) * 1e3, start.elapsed_time(end),
                                     (t3 - t2) * 1e3, (t3 - t0) * 1e3)):
            stages[name].append(ms)
    return {name: statistics.median(ts) for name, ts in stages.items()}


SINGLE_PASS_KERNELS = (
    "bin_max2_scaled_single_pass",
    "bin_max2_scaled_fold_pass",
    "bin_max2_raw_fold_pass",
)


def single_pass_bound_ms(B, n_rows, L, scaled, thresholds=False):
    """Least time of one int8 pass: the int8 codes (and, scaled, the fp32
    scales and bias; in a refinement round the two (B, L) thresholds), the
    bf16 query block and the four (B, L) outputs over HBM bandwidth, or the
    product's operations (bf16 tensor cores; the codes convert to bf16
    exactly) over the bf16 peak."""
    nbytes = n_rows * E + B * E * 2 + 4 * B * L * 4
    if scaled:
        nbytes += 2 * n_rows * 4
    if thresholds:
        nbytes += 2 * B * L * 4
    return roofline_ms(nbytes, 2 * B * n_rows * E)


def catalog_of(name):
    """The catalog kind of bin_max2.cu's template that a single pass
    instantiates (``bt.launch_info``'s ``catalog``)."""
    return "raw" if name == "bin_max2_raw_fold_pass" else "scaled"


def pass_args(name, args):
    """(L, F, scales, bias) of a single-pass wrapper's arguments after
    (q, codes)."""
    if name == "bin_max2_raw_fold_pass":
        return (*args, None, None)
    if name == "bin_max2_scaled_fold_pass":
        scales, bias, L, F = args
        return L, F, scales, bias
    scales, bias, L = args
    return L, 1, scales, bias


def plan_cases(codes, scales, bias, F, L):
    """{kernel name: (codes, wrapper arguments after (q, codes))} of the
    single passes at plan (F, L): the per-row pass (no fold at F = 1) over
    the whole padded catalog, the raw pass over its full chunks of real
    rows."""
    n_full = N_ARTICLES // (F * L) * (F * L)
    if F == 1:
        cases = {SINGLE_PASS_KERNELS[0]: (codes, (scales, bias, L))}
    else:
        cases = {SINGLE_PASS_KERNELS[1]: (codes, (scales, bias, L, F))}
    cases[SINGLE_PASS_KERNELS[2]] = (codes[:n_full], (L, F))
    return cases


def run_pass(name, q, codes, args, plain=False):
    """One single-pass kernel through its wrapper, or its plain version."""
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    if plain:
        return qt.single_pass_plain(q, codes, *pass_args(name, args))
    return getattr(qt, name)(q, codes, *args)


def pass_scores(q, codes, scales, bias):
    """(B, rows) fp32 scores a single pass ranks, for id comparisons."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    scores = bt.plain_scores(q, codes)
    return scores if scales is None else scores * scales + bias


def int8_catalog(gen, dev):
    """Random int8 codes of the H&M catalog padded with zero rows to
    N_PAD_Q, per-row scales (0 on pad rows) and a 0 / -inf bias."""
    codes = torch.zeros((N_PAD_Q, E), dtype=torch.int8, device=dev)
    codes[:N_ARTICLES] = torch.randint(-127, 128, (N_ARTICLES, E), generator=gen,
                                       device=dev, dtype=torch.int8)
    scales = torch.zeros(N_PAD_Q, device=dev)
    scales[:N_ARTICLES] = (
        torch.rand(N_ARTICLES, generator=gen, device=dev) * 0.05 + 1e-3
    )
    bias = torch.zeros(N_PAD_Q, device=dev)
    bias[N_ARTICLES:] = float("-inf")
    return codes, scales, bias


def phase_quantized_kernels(gen, dev):
    """Kernels 3-5 against their plain versions at every plan of
    QUANT_PLANS, timed there, and kernels 3-4 at other widths; then
    quantized_topk against a yardstick."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    codes, scales, bias = int8_catalog(gen, dev)
    stats = {n: {"max_abs_err": 0.0, "id_mismatches": 0, "shapes": []}
             for n in SINGLE_PASS_KERNELS}
    # the served (F, L, B) whose numbers head each kernel's entry
    headline = {
        "bin_max2_scaled_single_pass": (1, 2048, 1024),
        "bin_max2_scaled_fold_pass": (2, 2048, 128),
        "bin_max2_raw_fold_pass": (2, 2048, 128),
    }
    for F, L, B in QUANT_PLANS:
        cases = plan_cases(codes, scales, bias, F, L)
        check_clusters({name: bt.launch_info(B, E, L, threshold=False,
                                             catalog=catalog_of(name), fold=F,
                                             device=dev)
                        for name in cases}, L, B, F=F)
        for kind in ("integer", "normal"):
            if kind == "integer":
                q = torch.randint(-4, 5, (B, E), generator=gen, device=dev)
            else:
                q = torch.randn(B, E, generator=gen, device=dev)
            q = q.to(torch.bfloat16)
            for name, (c, args) in cases.items():
                got = run_pass(name, q, c, args)
                want = run_pass(name, q, c, args, plain=True)
                torch.cuda.synchronize()
                if kind == "integer":
                    for g, w in zip(got, want):
                        require(torch.equal(g, w), f"{name} F={F} L={L} B={B}: "
                                "integer inputs not bit-identical to the plain "
                                "version")
                    continue
                _, _, sc, bi = pass_args(name, args)
                scores = pass_scores(q, c, sc, bi)
                st = stats[name]
                for vi, ii in ((0, 1), (2, 3)):
                    err, mism = compare_ranked(
                        got[vi], got[ii], want[vi], want[ii], scores
                    )
                    st["max_abs_err"] = max(st["max_abs_err"], err)
                    st["id_mismatches"] += mism
                del scores
                bound, by = single_pass_bound_ms(B, c.shape[0], L, sc is not None)

                def launch():
                    return run_pass(name, q, c, args)

                row = {
                    "F": F, "L": L, "B": B, "rows": c.shape[0],
                    "ms": graph_ms(launch, 50),
                    "events_ms": cuda_ms(launch, 50),
                    "plain_ms": cuda_ms(lambda: run_pass(
                        name, q, c, args, plain=True), 3),
                    "bound_ms": bound, "bound_by": by,
                }
                st["shapes"].append(row)
                if headline[name] == (F, L, B):
                    st.update({k: row[k] for k in ("ms", "events_ms",
                                                   "plain_ms", "bound_ms",
                                                   "bound_by")})
            emit({"quantized_kernel_check": {"F": F, "L": L, "B": B,
                                             "inputs": kind, "ok": True}})

    # quantized_topk as a whole (pass + merge) against a yardstick the port
    # never calls: a bf16 product with the dequantized catalog + torch.topk
    deq = (codes[:N_ARTICLES].float() * scales[:N_ARTICLES, None]).to(
        torch.bfloat16)
    rows = []
    for B in (16, 128, 1024):
        q = torch.randn(B, E, generator=gen, device=dev)
        rows.append({
            "B": B, "k": SURVIVORS, "N": N_ARTICLES, "E": E,
            "plan": qt.single_pass_plan(B, E, SURVIVORS, N_PAD_Q),
            "ms": cuda_ms(lambda: qt.quantized_topk(
                q, codes, scales, SURVIVORS, n_valid=N_ARTICLES,
                max_rounds=1), 20),
            "yardstick_ms": cuda_ms(lambda: torch.topk(torch.matmul(
                q.to(torch.bfloat16), deq.T).float(), SURVIVORS), 20),
            "yardstick": "torch.matmul (bf16, dequantized catalog) + "
                         "torch.topk over (B, N)",
        })
    emit({"quantized_topk": rows})
    del codes, scales, bias, deq
    # the other instantiation (A fragments read from shared memory) of
    # kernels 3-5, at widths other than E = 128 up to the widest, on
    # integer inputs (with -inf bias rows for 3-4)
    for width in (64, 256, qt.INT8_KERNEL_MAX_E):
        L, n_rows, B = 1024, 16384, 37
        codes, scales, bias = scaled_catalog(gen, dev, n_rows, width, n_rows)
        q = torch.randint(-4, 5, (B, width), generator=gen,
                          device=dev).to(torch.bfloat16)
        for name, args in ((SINGLE_PASS_KERNELS[0], (scales, bias, L)),
                           (SINGLE_PASS_KERNELS[1], (scales, bias, L, 2)),
                           (SINGLE_PASS_KERNELS[2], (L, 1)),
                           (SINGLE_PASS_KERNELS[2], (L, 2))):
            got = run_pass(name, q, codes, args)
            want = run_pass(name, q, codes, args, plain=True)
            torch.cuda.synchronize()
            F = pass_args(name, args)[1]
            hold_cells(stats[name], f"{name} E={width} F={F}", "integer", got,
                       want, None)
        emit({"quantized_kernel_check": {"E": width, "L": L, "B": B,
                                         "inputs": "integer", "ok": True}})
    return stats


def plain_rounds():
    """Inside the block the int8 rounds driver runs the plain passes."""
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    return swapped(
        qt,
        bin_max2_scaled_first_round=lambda q, c, sc, bi, L, n: (
            qt.scaled_round_plain(q, c, sc, bi, L, n)),
        bin_max2_scaled_round=lambda q, c, sc, bi, ts, ti, L, n: (
            qt.scaled_round_plain(q, c, sc, bi, L, n, ts, ti)),
    )


def hold_cells(st, name, kind, got, want, scores_fn):
    """A pass's cells against its plain version's: bit-identical for
    integer inputs, else values within TOL and ids wherever the competing
    scores differ by more (``scores_fn()`` gives them)."""
    if kind == "integer":
        for g, w in zip(got, want):
            require(torch.equal(g, w), f"{name}: integer inputs not "
                    "bit-identical to the plain version")
        return
    scores = scores_fn()
    for vi in range(0, len(got), 2):
        err, mism = compare_ranked(got[vi], got[vi + 1], want[vi],
                                   want[vi + 1], scores)
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["id_mismatches"] += mism


def random_rows(gen, dev, kind, n):
    """(n, E) bf16 rows: integers in [-4, 4], or normal."""
    if kind == "integer":
        x = torch.randint(-4, 5, (n, E), generator=gen, device=dev)
    else:
        x = torch.randn(n, E, generator=gen, device=dev)
    return x.to(torch.bfloat16)


ROUNDS_KERNELS = ("bin_max2_scaled_first_round", "bin_max2_scaled_round")


def scaled_catalog(gen, dev, n_rows, width, n_valid):
    """Random int8 codes and per-row scales of ``n_rows`` rows, a -inf bias
    on 1% of the first ``n_valid`` and 0 past them: as quantized_topk pads
    what the rounds stream."""
    codes = torch.randint(-127, 128, (n_rows, width), generator=gen,
                          device=dev, dtype=torch.int8)
    scales = torch.rand(n_rows, generator=gen, device=dev) * 0.05 + 1e-3
    bias = torch.zeros(n_rows, device=dev)
    bias[:n_valid][torch.rand(n_valid, generator=gen, device=dev)
                   < 0.01] = float("-inf")
    return codes, scales, bias


def phase_rounds_kernels(gen, dev):
    """Kernels 6-8 against their plain versions at the served shapes:
    kernels 6-7 at every (B, L) of KERNEL_BATCHES x (2048, 1024), timed at
    TIMED_BATCHES, and at E = 64 and 256; kernel 8 at L = 2048 and 512."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    stats = {n: {"max_abs_err": 0.0, "id_mismatches": 0, "shapes": []}
             for n in ROUNDS_KERNELS + ("bin_max_round",)}
    # quantized_topk streams the chunks that hold a valid row: 106,496 of
    # the 131,072 rows at L = 2048 and at L = 1024 alike
    n_rows = -(-N_ARTICLES // 2048) * 2048
    n_valid = N_ARTICLES
    codes, scales, bias = scaled_catalog(gen, dev, n_rows, E, n_valid)
    for k, L in ((SERVE_K, 2048), (100, 1024)):
        require(bt.default_bins(k) == L and -(-n_valid // L) * L == n_rows,
                f"the rounds at k={k} do not stream {n_rows} rows at L={L}")
        for B in KERNEL_BATCHES:
            check_clusters({n: bt.launch_info(
                B, E, L, threshold=n == ROUNDS_KERNELS[1], catalog="scaled",
                device=dev) for n in ROUNDS_KERNELS}, L, B)
        for kind in ("integer", "normal"):
            q_all = random_rows(gen, dev, kind, Q_BLOCK)
            for B in KERNEL_BATCHES:
                q = q_all[:B]
                k6 = qt.bin_max2_scaled_first_round(q, codes, scales, bias, L,
                                                    n_valid)
                p6 = qt.scaled_round_plain(q, codes, scales, bias, L, n_valid)
                # each chain refines on the thresholds its own round 1
                # revealed
                k7 = qt.bin_max2_scaled_round(q, codes, scales, bias, k6[2],
                                              k6[3], L, n_valid)
                p7 = qt.scaled_round_plain(q, codes, scales, bias, L, n_valid,
                                           p6[2], p6[3])
                torch.cuda.synchronize()
                for name, got, want in ((ROUNDS_KERNELS[0], k6, p6),
                                        (ROUNDS_KERNELS[1], k7, p7)):
                    hold_cells(stats[name], f"{name} L={L} B={B}", kind, got,
                               want, lambda: pass_scores(q, codes, scales,
                                                         bias))
                emit({"rounds_kernel_check": {"kernels": "int8 rounds",
                                              "L": L, "B": B, "inputs": kind,
                                              "ok": True}})
                if kind != "normal" or L != 2048 or B not in TIMED_BATCHES:
                    continue
                for name, thr, plain in (
                    (ROUNDS_KERNELS[0], (), ()),
                    (ROUNDS_KERNELS[1], k6[2:], p6[2:]),
                ):
                    bound, by = single_pass_bound_ms(B, n_rows, L, True,
                                                     bool(thr))

                    def launch():
                        return getattr(qt, name)(q, codes, scales, bias,
                                                 *thr, L, n_valid)

                    row = {
                        "L": L, "B": B, "rows": n_rows,
                        "ms": graph_ms(launch, 50),
                        "events_ms": cuda_ms(launch, 50),
                        "plain_ms": cuda_ms(lambda: qt.scaled_round_plain(
                            q, codes, scales, bias, L, n_valid, *plain), 3),
                        "bound_ms": bound, "bound_by": by,
                    }
                    stats[name]["shapes"].append(row)
                    if B == Q_BLOCK:
                        stats[name].update({key: row[key] for key in (
                            "ms", "events_ms", "plain_ms", "bound_ms",
                            "bound_by")})
    del codes, scales, bias
    # the other instantiation (A fragments read from shared memory), at
    # widths other than E = 128, on integer inputs
    for width in (64, 256):
        L, B, n_valid = 1024, 37, 16000
        codes, scales, bias = scaled_catalog(gen, dev, 16384, width, n_valid)
        q = torch.randint(-4, 5, (B, width), generator=gen,
                          device=dev).to(torch.bfloat16)
        k6 = qt.bin_max2_scaled_first_round(q, codes, scales, bias, L,
                                            n_valid)
        p6 = qt.scaled_round_plain(q, codes, scales, bias, L, n_valid)
        checks = ((ROUNDS_KERNELS[0], k6, p6),
                  (ROUNDS_KERNELS[1],
                   qt.bin_max2_scaled_round(q, codes, scales, bias, k6[2],
                                            k6[3], L, n_valid),
                   qt.scaled_round_plain(q, codes, scales, bias, L, n_valid,
                                         p6[2], p6[3])))
        torch.cuda.synchronize()
        for name, got, want in checks:
            hold_cells(stats[name], f"{name} E={width}", "integer", got, want,
                       None)
        emit({"rounds_kernel_check": {"kernels": "int8 rounds", "E": width,
                                      "L": L, "B": B, "inputs": "integer",
                                      "ok": True}})

    st = stats["bin_max_round"]
    for L in (2048, 512):  # default_bins(k, 1) at k = 1000 and 100
        n_pad = -(-N_ARTICLES // L) * L
        inf_s = torch.full((Q_BLOCK, L), float("inf"), device=dev)
        inf_i = torch.full((Q_BLOCK, L), -1, dtype=torch.int32, device=dev)
        for kind in ("integer", "normal"):
            q = random_rows(gen, dev, kind, Q_BLOCK)
            c_pad = torch.zeros(n_pad, E, dtype=torch.bfloat16, device=dev)
            c_pad[:N_ARTICLES] = random_rows(gen, dev, kind, N_ARTICLES)
            k1 = bt.bin_max_round(q, c_pad, inf_s, inf_i, L, N_ARTICLES)
            p1 = bt.bin_max_plain(q, c_pad, inf_s, inf_i, L, N_ARTICLES)
            k2 = bt.bin_max_round(q, c_pad, *k1, L, N_ARTICLES)
            p2 = bt.bin_max_plain(q, c_pad, *p1, L, N_ARTICLES)
            torch.cuda.synchronize()
            for got, want in ((k1, p1), (k2, p2)):
                hold_cells(st, "bin_max_round", kind, got, want,
                           lambda: bt.plain_scores(q, c_pad))
            emit({"rounds_kernel_check": {"kernels": "single keep", "L": L,
                                          "B": Q_BLOCK, "inputs": kind,
                                          "ok": True}})
            if kind != "normal":
                continue
            bound, by = pass_bound_ms(Q_BLOCK, n_pad, L, True, outputs=2)
            def launch():
                return bt.bin_max_round(q, c_pad, *k1, L, N_ARTICLES)

            row = {
                "L": L, "B": Q_BLOCK, "rows": n_pad,
                "ms": graph_ms(launch, 50),
                "events_ms": cuda_ms(launch, 50),
                "plain_ms": cuda_ms(lambda: bt.bin_max_plain(
                    q, c_pad, *p1, L, N_ARTICLES), 3),
                "bound_ms": bound, "bound_by": by,
            }
            st["shapes"].append(row)
            if L == 2048:
                st.update({k: row[k] for k in ("ms", "events_ms", "plain_ms",
                                               "bound_ms", "bound_by")})
    return stats


def phase_rounds_drivers(gen, dev):
    """The drivers of kernels 6-8 and the lockstep driver. Returns the
    launches of the single-keep path (exact_topk(keep_per_bin=1))."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    codes, scales, _ = int8_catalog(gen, dev)
    deq = (codes[:N_ARTICLES].float() * scales[:N_ARTICLES, None]).to(
        torch.bfloat16)
    rows = []
    for B in (128, 1024):
        q = torch.randn(B, E, generator=gen, device=dev)
        v, i, rounds = qt.quantized_topk(q, codes, scales, SURVIVORS,
                                         n_valid=N_ARTICLES)
        blocks = [qt.quantized_topk(q[s:s + Q_BLOCK], codes, scales, SURVIVORS,
                                    n_valid=N_ARTICLES)
                  for s in range(0, B, Q_BLOCK)]
        require(torch.equal(v, torch.cat([b[0] for b in blocks]))
                and torch.equal(i, torch.cat([b[1] for b in blocks]))
                and rounds == max(b[2] for b in blocks),
                f"B={B}: the rounds do not answer as their blocks alone")
        per_block = [b[2] for b in blocks]
        done = torch.tensor([r < MAX_ROUNDS for r in per_block],
                            device=dev).repeat_interleave(Q_BLOCK)
        err, mism = 0.0, 0
        if bool(done.any()):  # the dequantized scores of the bf16 queries
            scores = (bt.plain_scores(q[done].to(torch.bfloat16),
                                      codes[:N_ARTICLES]) * scales[:N_ARTICLES])
            sv, si = torch.sort(scores, dim=1, descending=True, stable=True)
            err, mism = compare_ranked(v[done], i[done], sv[:, :SURVIVORS],
                                       si[:, :SURVIVORS], scores)
            del scores, sv, si
        rows.append({
            "driver": "quantized_topk", "B": B, "k": SURVIVORS, "L": 2048,
            "rounds_per_block": per_block, "exact_rows": int(done.sum()),
            "max_abs_err_vs_exact": err, "id_mismatches": mism,
            "ms": cuda_ms(lambda: qt.quantized_topk(
                q, codes, scales, SURVIVORS, n_valid=N_ARTICLES), 10),
            "yardstick_ms": cuda_ms(lambda: torch.topk(torch.matmul(
                q.to(torch.bfloat16), deq.T).float(), SURVIVORS), 10),
            "yardstick": "torch.matmul (bf16, dequantized catalog) + "
                         "torch.topk over (B, N)",
        })
    del codes, scales, deq

    c = torch.randn(N_ARTICLES, E, generator=gen, device=dev)
    cb = c.to(torch.bfloat16)
    q = torch.randn(Q_BLOCK, E, generator=gen, device=dev)
    # --- the single-keep path: counts from 0 -----------------------------
    bt.reset_launches()
    keep1 = {k: bt.exact_topk(q, c, k, keep_per_bin=1) for k in (100, 1000)}
    launches = dict(bt.LAUNCHES)
    # ---------------------------------------------------------------------
    require(launches["bin_max_round"] > 0 and launches["bin_max2_round"] == 0
            and launches["bin_max2_first_round"] == 0,
            f"exact_topk(keep_per_bin=1) launched {launches}")
    scores = bt.plain_scores(q.to(torch.bfloat16), cb)
    sv, si = torch.sort(scores, dim=1, descending=True, stable=True)
    for k, (v, i, rounds) in keep1.items():
        with swapped(bt, bin_max_round=bt.bin_max_plain):
            pv, pi, prounds = bt.exact_topk(q, c, k, keep_per_bin=1)
        require(rounds == prounds, f"keep 1, k={k}: {rounds} rounds, the "
                f"plain pass {prounds}")
        err, mism = compare_ranked(v, i, pv, pi, scores)
        row = {"driver": "exact_topk(keep_per_bin=1)", "B": Q_BLOCK, "k": k,
               "L": bt.default_bins(k, 1), "rounds": rounds,
               "max_abs_err_vs_plain_driver": err,
               "id_mismatches_vs_plain_driver": mism}
        if rounds < MAX_ROUNDS:
            row["max_abs_err_vs_exact"], row["id_mismatches_vs_exact"] = (
                compare_ranked(v, i, sv[:, :k], si[:, :k], scores))
        row.update(
            ms=cuda_ms(lambda: bt.exact_topk(q, c, k, keep_per_bin=1), 10),
            keep2_ms=cuda_ms(lambda: bt.exact_topk(q, c, k), 10),
            keep2_rounds=bt.exact_topk(q, c, k)[2],
            yardstick_ms=cuda_ms(lambda: torch.topk(torch.matmul(
                q.to(torch.bfloat16), cb.T).float(), k), 10),
        )
        rows.append(row)
    del scores, sv, si

    q = torch.randn(1024, E, generator=gen, device=dev)
    bt.reset_launches()
    v1, i1, r1 = bt.exact_topk(q, c, SERVE_K, lockstep=True)
    lock_launches = dict(bt.LAUNCHES)
    v0, i0, r0 = bt.exact_topk(q, c, SERVE_K)
    require(torch.equal(i1, i0) and torch.equal(v1, v0),
            "lockstep ids differ from the per-block driver's")
    require(lock_launches["bin_max2_first_round"] == 1
            and lock_launches["bin_max2_round"] == r1 - 1,
            f"lockstep did not launch once per round: {lock_launches}")
    rows.append({
        "driver": "exact_topk(lockstep=True)", "B": 1024, "k": SERVE_K,
        "L": 2048, "rounds": r1, "per_block_rounds": r0,
        "launches": lock_launches,
        "ms": cuda_ms(lambda: bt.exact_topk(q, c, SERVE_K, lockstep=True), 5),
        "per_block_ms": cuda_ms(lambda: bt.exact_topk(q, c, SERVE_K), 5),
    })
    for row in rows:
        emit({"rounds_driver": row})
    return launches


def phase_rounds_serving(shared, single_pass_recall, repeats, dev, workdir):
    """Quantized serving with the int8 rounds (pallas_rounds = 8)."""
    from hm_retrieval_tpu_torch.indices import quantized as pq
    from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.serving import RetrievalService

    requests = shared["requests"]
    services = {}
    for mode in ("per_row", "global"):
        t0 = time.perf_counter()
        index = QuantizedIndex(SERVE_K, shared["ids"], shared["emb"],
                               method="auto", scale_mode=mode,
                               pallas_rounds=MAX_ROUNDS, device=dev)
        require(index.method == "pallas" and index.k_over == SURVIVORS,
                f"rounds {mode}: auto resolved to {index.method!r} with "
                f"{index.k_over} survivors")
        path = workdir / f"rounds_{mode}"
        index.save(str(path))
        svc = RetrievalService.load(str(shared["schema_dir"]),
                                    str(shared["model_dir"]), str(path),
                                    device=dev)
        loaded = svc.index
        require(isinstance(loaded, QuantizedIndex) and loaded.method == "pallas"
                and loaded.pallas_rounds == MAX_ROUNDS
                and loaded.k_over == SURVIVORS and loaded.scale_mode == mode
                and loaded.codes.shape[0] == N_PAD_Q,
                f"rounds {mode}: the loaded index does not run the rounds")
        services[mode] = svc
        emit({"rounds_setup": {"scale_mode": mode,
                               "seconds": time.perf_counter() - t0,
                               "pallas_rounds": loaded.pallas_rounds,
                               "k_over": loaded.k_over}})

    # --- the main path: counts from 0, served requests only -------------
    bt.reset_launches()
    qt.reset_launches()
    rows, answers = [], {}
    for mode, svc in services.items():
        for B in SERVE_BATCHES:
            before = dict(qt.LAUNCHES)
            svc.retrieve(requests[B])  # warm-up
            times = []
            for _ in range(repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                answers[mode, B] = svc.retrieve(requests[B])
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            per_batch = {n: (qt.LAUNCHES[n] - before[n]) / (repeats + 1)
                         for n in qt.LAUNCHES}
            rows.append({"scale_mode": mode, "B": B,
                         "median_ms": statistics.median(times),
                         "min_ms": min(times), "max_ms": max(times),
                         "launches_per_batch": per_batch})
    launches = dict(qt.LAUNCHES)
    exact_launches = dict(bt.LAUNCHES)
    # ---------------------------------------------------------------------
    require(all(launches[n] > 0 for n in ROUNDS_KERNELS)
            and not any(launches[n] for n in SINGLE_PASS_KERNELS)
            and not any(exact_launches.values()),
            f"the rounds path launched {launches}, {exact_launches}")

    emb_real = shared["emb"]
    for row in rows:
        mode, B = row["scale_mode"], row["B"]
        svc = services[mode]
        index = svc.index
        got = answers[mode, B]
        require(len(got) == B, f"rounds {mode} B={B}: {len(got)} answers")
        for ans in got:
            require(len(ans) == SERVE_K and len(set(ans)) == SERVE_K,
                    f"rounds {mode} B={B}: an answer is not {SERVE_K} "
                    "distinct articles")
            require(set(ans) <= shared["article_vocab"],
                    f"rounds {mode} B={B}: unknown article")
        with torch.no_grad():
            q = svc.embed(svc.encode_query(requests[B]))
        survivors = []

        def recording(queries, codes, scales, *args, **kwargs):
            out = qt.quantized_topk(queries, codes, scales, *args, **kwargs)
            survivors.append((queries, codes, scales, out))
            return out

        with swapped(pq, quantized_topk=recording):
            kv, kid = index.topk_from_embeddings(q)
            with plain_rounds():
                pv, pid = index.topk_from_embeddings(q)
        decoded = svc.schema.candidate_id_feature.decode(kid.cpu().numpy())
        require(decoded.tolist() == got,
                f"rounds {mode} B={B}: served answers differ from a rerun")
        (qs, codes, scales, (ksv, ks, k_rounds)), (_, _, _, (psv, ps, p_rounds)) = (
            survivors)
        # every row's survivors against the plain passes', over the
        # dequantized scores (bf16 queries, fp32 sums, * scale)
        n = index.num_candidates
        deq = bt.plain_scores(qs.to(torch.bfloat16), codes[:n]) * scales[:n]
        surv_err, surv_mism = compare_ranked(ksv, ks, psv, ps, deq)
        diff = ks != ps
        swapped_at = diff.nonzero()  # (row, rank) of each swapped survivor
        swap_gap = (deq[swapped_at[:, 0], ks[diff].long()]
                    - deq[swapped_at[:, 0], ps[diff].long()]).abs()
        del deq
        survivors_differ = diff.any(1)
        answers_differ = ((kid != pid) | (kv != pv)).any(1)
        require(not bool((answers_differ & ~survivors_differ).any()),
                f"rounds {mode} B={B}: answers differ from the plain "
                "composition where the survivors agree")
        exact = bt.plain_scores(q, emb_real)
        top = torch.sort(exact, dim=1, descending=True, stable=True)[1][:, :SERVE_K]
        del exact
        hit = torch.zeros((B, N_ARTICLES), dtype=torch.bool, device=dev)
        hit.scatter_(1, top, True)
        recall = float(torch.gather(hit, 1, kid.long() - 1).float().mean())
        row.update(rounds=k_rounds, plain_rounds=p_rounds,
                   survivors_max_abs_err_vs_plain=surv_err,
                   survivor_id_mismatches=surv_mism,
                   survivor_swap_max_score_gap=(
                       float(swap_gap.max()) if surv_mism else 0.0),
                   survivor_first_swapped_rank=(
                       int(swapped_at[:, 1].min()) if surv_mism else None),
                   rows_with_other_survivors=int(survivors_differ.sum()),
                   rows_answered_otherwise=int(answers_differ.sum()),
                   recall_vs_exact=recall,
                   single_pass_recall_vs_exact=single_pass_recall[mode, B],
                   **serve_breakdown(svc, requests[B], repeats))
        emit({"rounds_serve": row})
    return launches


@contextlib.contextmanager
def swapped(module, **fns):
    """Inside the block, ``module.<name>`` is ``fns[name]``."""
    saved = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def recorded_passes(plain):
    """Inside the block the single-pass drivers reach the kernel wrappers
    (or, with ``plain``, the plain versions) through recording stand-ins.
    Yields the list of (q, codes, scales, bias, outputs) of each pass."""
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    record = []

    def stand_in(name):
        wrapper = getattr(qt, name)

        def run(q, codes, *args):
            L, F, sc, bi = pass_args(name, args)
            out = (qt.single_pass_plain(q, codes, L, F, sc, bi) if plain
                   else wrapper(q, codes, *args))
            record.append((q, codes, sc, bi, out))
            return out
        return run

    with swapped(qt, **{n: stand_in(n) for n in SINGLE_PASS_KERNELS}):
        yield record


def check_device_build(index, emb_host, mode):
    """The index quantized on the card must equal the host quantization of
    the same catalog bit for bit: codes, scales (one global scale, or one
    per row), zero codes and scales on pad rows, bias 0 / -inf."""
    from hm_retrieval_tpu_torch.indices.quantized import (
        quantize_rows, quantize_rows_global,
    )

    n = N_ARTICLES
    if mode == "global":
        codes, g = quantize_rows_global(emb_host)
        scales = np.full(n, g, np.float32)
        require(index.global_scale == float(g),
                f"global: device scale {index.global_scale} != host {float(g)}")
    else:
        codes, scales = quantize_rows(emb_host)
    require(np.array_equal(index.codes[:n].cpu().numpy(), codes)
            and np.array_equal(index.scales[:n].cpu().numpy(), scales),
            f"{mode}: the device build's codes or scales differ from the "
            "host build's")
    bias = index._score_bias
    require(not bool(index.codes[n:].any()) and not bool(index.scales[n:].any())
            and not bool(bias[:n].any()) and bool(torch.isneginf(bias[n:]).all()),
            f"{mode}: the device build's padding is wrong")


def phase_quantized_serving(shared, repeats, dev, workdir):
    from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.serving import RetrievalService

    requests = shared["requests"]
    emb_host = shared["emb"].cpu().numpy()
    services = {}
    for mode in ("per_row", "global"):
        t0 = time.perf_counter()
        index = QuantizedIndex(SERVE_K, shared["ids"], shared["emb"],
                               method="auto", scale_mode=mode, device=dev)
        require(index.method == "pallas" and index.k_over == SURVIVORS,
                f"{mode}: auto resolved to {index.method!r} with "
                f"{index.k_over} survivors")
        check_device_build(index, emb_host, mode)
        path = workdir / f"quantized_{mode}"
        index.save(str(path))
        svc = RetrievalService.load(str(shared["schema_dir"]),
                                    str(shared["model_dir"]), str(path),
                                    device=dev)
        loaded = svc.index
        require(isinstance(loaded, QuantizedIndex) and loaded.method == "pallas"
                and loaded.k_over == SURVIVORS and loaded.scale_mode == mode,
                f"{mode}: the loaded index does not run the kernels")
        require(loaded.codes.shape[0] == N_PAD_Q, "codes are not padded to "
                f"{N_PAD_Q} rows")
        require(torch.equal(loaded.codes, index.codes)
                and torch.equal(loaded.scales, index.scales)
                and loaded.global_scale == index.global_scale,
                f"{mode}: the loaded index's codes or scales differ from the "
                "device build's")
        services[mode] = svc
        emit({"quantized_setup": {"scale_mode": mode,
                                  "seconds": time.perf_counter() - t0,
                                  "k_over": loaded.k_over,
                                  "codes": list(loaded.codes.shape)}})

    # --- the main path: counts from 0, served requests only -------------
    bt.reset_launches()
    qt.reset_launches()
    rows, answers = [], {}
    for mode, svc in services.items():
        for B in SERVE_BATCHES:
            before = dict(qt.LAUNCHES)
            svc.retrieve(requests[B])  # warm-up
            times = []
            for _ in range(repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                answers[mode, B] = svc.retrieve(requests[B])
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            per_batch = {n: (qt.LAUNCHES[n] - before[n]) / (repeats + 1)
                         for n in qt.LAUNCHES}
            rows.append({"scale_mode": mode, "B": B,
                         "median_ms": statistics.median(times),
                         "min_ms": min(times), "max_ms": max(times),
                         "launches_per_batch": per_batch})
    launches = dict(qt.LAUNCHES)
    exact_launches = dict(bt.LAUNCHES)
    # ---------------------------------------------------------------------
    require(all(launches[n] > 0 for n in SINGLE_PASS_KERNELS)
            and not any(launches[n] for n in launches
                        if n not in SINGLE_PASS_KERNELS),
            f"the single-pass path launched {launches}")
    require(not any(exact_launches.values()),
            f"the quantized path launched the exact kernels: {exact_launches}")

    emb_real = shared["emb"]
    for row in rows:
        mode, B = row["scale_mode"], row["B"]
        svc = services[mode]
        index = svc.index
        if mode == "global":
            expected = "bin_max2_raw_fold_pass"
            plan = qt.single_pass_plan(B, E, SURVIVORS, N_ARTICLES)
        else:
            expected = SINGLE_PASS_KERNELS[1 if B <= 128 else 0]
            plan = qt.single_pass_plan(B, E, SURVIVORS, N_PAD_Q)
        require(row["launches_per_batch"][expected] == 1,
                f"{mode} B={B}: {expected} did not run once per batch: "
                f"{row['launches_per_batch']}")
        got = answers[mode, B]
        require(len(got) == B, f"{mode} B={B}: {len(got)} answers")
        for ans in got:
            require(len(ans) == SERVE_K and len(set(ans)) == SERVE_K,
                    f"{mode} B={B}: an answer is not {SERVE_K} distinct "
                    "articles")
            require(set(ans) <= shared["article_vocab"],
                    f"{mode} B={B}: unknown article")
        with torch.no_grad():
            q = svc.embed(svc.encode_query(requests[B]))
        with recorded_passes(plain=False) as rec_k:
            kv, kid = index.topk_from_embeddings(q)
        with recorded_passes(plain=True) as rec_p:
            pv, pid = index.topk_from_embeddings(q)
        decoded = svc.schema.candidate_id_feature.decode(kid.cpu().numpy())
        require(decoded.tolist() == got,
                f"{mode} B={B}: served answers differ from a rerun")
        # the pass against its plain version on the served queries
        qp, c, sc, bi, kout = rec_k[0]
        pout = rec_p[0][4]
        scores = pass_scores(qp, c, sc, bi)
        err, mism = 0.0, 0
        for vi, ii in ((0, 1), (2, 3)):
            e, m = compare_ranked(kout[vi], kout[ii], pout[vi], pout[ii],
                                  scores)
            err, mism = max(err, e), mism + m
        del scores
        # where both passes keep the same survivors, the answers are equal
        survivors_differ = ((kout[1] != pout[1]) | (kout[3] != pout[3])).any(1)
        answers_differ = ((kid != pid) | (kv != pv)).any(1)
        require(not bool((answers_differ & ~survivors_differ).any()),
                f"{mode} B={B}: answers differ from the plain composition "
                "where the survivors agree")
        # recall against the exact fp32 top-1000 (a reading, not a gate)
        exact = bt.plain_scores(q, emb_real)
        top = torch.sort(exact, dim=1, descending=True, stable=True)[1][:, :SERVE_K]
        del exact
        hit = torch.zeros((B, N_ARTICLES), dtype=torch.bool, device=dev)
        hit.scatter_(1, top, True)
        recall = float(torch.gather(hit, 1, kid.long() - 1).float().mean())
        row.update(plan=plan, pass_max_abs_err_vs_plain=err,
                   pass_id_mismatches=mism,
                   rows_with_other_survivors=int(survivors_differ.sum()),
                   rows_answered_otherwise=int(answers_differ.sum()),
                   recall_vs_exact=recall,
                   **serve_breakdown(svc, requests[B], repeats))
        emit({"quantized_serve": row})
    recalls = {(row["scale_mode"], row["B"]): row["recall_vs_exact"]
               for row in rows}
    return launches, recalls


WIDTH_ROWS = 20_000  # over 16,384: BruteForceIndex("auto") takes the kernels
WIDTH_K = 100  # the quantized indices' k (400 survivors)


class Records(logging.Handler):
    """Collects the port's log records."""

    def __init__(self, level=logging.WARNING):
        super().__init__(level)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def phase_widths(seed, dev):
    """Widths the kernels do not take as they are, on the card against the
    same indices on the CPU, over WIDTH_ROWS rows of integer-valued
    embeddings (exact in bf16 and in fp32 sums, so the answers must be
    bit-identical): BruteForceIndex("auto") and QuantizedIndex one pass and
    with 8 rounds at E = 8 and 100 run the kernels on E padded to a
    multiple of 16; at E = 520 BruteForceIndex runs "full" and the rounds
    "scan" (past KERNEL_MAX_E = 512), the one pass the kernels (528 <=
    INT8_KERNEL_MAX_E = 576), and at E = 600 the one pass runs "scan", each
    route with a log line."""
    from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
    from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    rng = np.random.default_rng(seed)
    indices = {
        "exact": lambda i, x, d: BruteForceIndex(SERVE_K, i, x, device=d),
        "quantized_one_pass": lambda i, x, d: QuantizedIndex(
            WIDTH_K, i, x, device=d),
        "quantized_rounds": lambda i, x, d: QuantizedIndex(
            WIDTH_K, i, x, pallas_rounds=MAX_ROUNDS, device=d),
    }
    cases = [(w, name, "pallas") for w in (8, 100) for name in indices]
    cases += [(520, "exact", "full"), (520, "quantized_rounds", "scan"),
              (520, "quantized_one_pass", "pallas"),
              (600, "quantized_one_pass", "scan")]
    log = Records()
    logging.getLogger("hm_retrieval_tpu_torch").addHandler(log)
    rows = []
    try:
        for width, name, engine in cases:
            ids = np.arange(1, WIDTH_ROWS + 1, dtype=np.int32)
            emb = rng.integers(-4, 5, (WIDTH_ROWS, width)).astype(np.float32)
            q = rng.integers(-4, 5, (16, width)).astype(np.float32)
            del log.records[:]
            card = indices[name](ids, emb, dev)
            host = indices[name](ids, emb, "cpu")
            routed = [m for m in log.records if "widest" in m]
            require(card._engine == host._engine == engine
                    and len(routed) == 2 * (engine != "pallas"),
                    f"{name} E={width}: engine {card._engine!r}, expected "
                    f"{engine!r}; log {log.records}")
            # --- this path: counts from 0 ---------------------------------
            bt.reset_launches()
            qt.reset_launches()
            got = card.topk_from_embeddings(torch.tensor(q, device=dev))
            torch.cuda.synchronize()
            launches = {n: c for n, c in {**bt.LAUNCHES, **qt.LAUNCHES}.items()
                        if c}
            # -----------------------------------------------------------------
            require(bool(launches) == (engine == "pallas"),
                    f"{name} E={width}: launched {launches}")
            want = host.topk_from_embeddings(torch.tensor(q))
            require(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
                    f"{name} E={width}: the card's answers differ from the "
                    "CPU's")
            rows.append({"E": width, "index": name, "engine": engine,
                         "launches": launches, "log": routed[:1],
                         "identical_to_cpu": True})
    finally:
        logging.getLogger("hm_retrieval_tpu_torch").removeHandler(log)
    for row in rows:
        emit({"width": row})
    # the one pass's kernels at the widest padded widths they serve
    for width in (528, qt.INT8_KERNEL_MAX_E):
        for B in (16, Q_BLOCK):
            emit({"width_launch": {"E": width, "B": B, **{
                name: bt.launch_info(B, width, 2048, threshold=False,
                                     catalog=catalog_of(name), fold=F,
                                     device=dev)
                for name, F in (("bin_max2_scaled_single_pass", 1),
                                ("bin_max2_scaled_fold_pass", 2),
                                ("bin_max2_raw_fold_pass", 2))}}})


# --- phase 9: training ------------------------------------------------------
TRAIN_B = 512  # TrainingConfig's train_batch_size
TRAIN_WARMUP, TRAIN_STEPS = 8, 48  # untimed, then timed steps a path
TRAIN_ROWS = 64 * TRAIN_B  # rows of the synthetic shards
SHARD_ROWS = 8192
ACTIVE_CUSTOMERS = 4096  # customers that buy, spread over the full table
HISTORY_LEN = 16  # BASELINE config[3]'s purchase history
NUM_NEGATIVES = 512  # uniform negatives of the mixed path
CHUNK_K = 8  # steps a chunk on the chunked path
SMALL_CUSTOMERS, SMALL_ARTICLES = 5000, 2000  # the card-against-CPU check
ADAM_LR = 1e-3  # the reference's Keras Adam default
# Adam's eps in the card-against-CPU check only: at 1e-8 Adam divides
# rounding noise by eps where a gradient is zero in exact arithmetic (the
# candidate tower's last bias, which the in-batch softmax cannot see), so two
# summation orders differ there by up to lr
CHECK_ADAM_EPS = 1e-3
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5  # card vs CPU, fp32, 3 steps
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores, published
# (name, TrainingConfig fields, purchase history?)
TRAIN_PATHS = (
    ("sparse_adagrad", {}, False),
    ("sparse_adagrad_history", {}, True),
    ("dense_adagrad", {"use_sparse_embedding_optimizer": False}, False),
    ("dense_adam", {"optimizer_name": "adam",
                    "optimizer_kwargs": {"learning_rate": ADAM_LR}}, False),
    ("mixed_negatives", {"num_uniform_negatives": NUM_NEGATIVES}, False),
    ("chunked_k8", {"steps_per_dispatch": CHUNK_K}, False),
)


def sized_feature(name, kind, family, width, rows, **kw):
    """A feature whose table holds ``rows`` ids past OOV, without building a
    vocab of ``rows`` strings (as bench.py's H&M-scale model does)."""
    from hm_retrieval_tpu_torch.schema import Feature

    class Sized(Feature):
        @property
        def num_embeddings(self):
            return rows + 1

    return Sized(name, kind, family, embedding_size=width,
                 vocab=np.array(["x"]), **kw)


def article_popularity(n_articles):
    """bench.py's logQ: Dirichlet(0.5) popularity from seed 0; logq[0] = 0."""
    probs = np.random.default_rng(0).dirichlet(np.full(n_articles, 0.5))
    logq = np.zeros(n_articles + 1, np.float32)
    logq[1:] = np.log(probs + 1e-12).astype(np.float32)
    return probs, logq


def train_model(n_customers, n_articles, logq, history, dev):
    """bench.py's H&M model (``hm_scale_model``) from the port's classes."""
    from hm_retrieval_tpu_torch.models import TwoTowerModel

    query = [sized_feature("customer_id", "categorical", "query", E,
                           n_customers)]
    if history:
        query.append(sized_feature(
            "purchase_history", "sequence", "query", E, n_articles,
            max_len=HISTORY_LEN, pooling="mean"))
    candidate = [
        sized_feature("article_id", "categorical", "candidate", E, n_articles),
        sized_feature("product_type_name", "categorical", "candidate", 16,
                      N_PRODUCT_TYPES),
        sized_feature("colour_group_name", "categorical", "candidate", 8,
                      N_COLOURS),
    ]
    return TwoTowerModel(query, candidate, "article_id", E, [256], [256],
                         logq=logq, device=dev)


def train_columns(rng, n_rows, n_customers, n_articles, probs):
    """A learnable stream: each of ACTIVE_CUSTOMERS customers (spread over
    the whole table) buys its favourite article 80% of the time and a
    popular one otherwise; the history mixes the favourite with popular
    articles, padded at random lengths. Product type and colour are
    attributes of the article. Returns the rows and the catalog columns."""
    n_active = min(ACTIVE_CUSTOMERS, n_customers)
    active = rng.choice(n_customers, n_active, replace=False) + 1
    favourite = rng.choice(n_articles, n_active, p=probs) + 1
    product_type = rng.integers(1, N_PRODUCT_TYPES + 1, n_articles + 1)
    colour = rng.integers(1, N_COLOURS + 1, n_articles + 1)
    who = rng.integers(0, n_active, n_rows)
    article = np.where(rng.random(n_rows) < 0.8, favourite[who],
                       rng.choice(n_articles, n_rows, p=probs) + 1)
    hist = np.where(rng.random((n_rows, HISTORY_LEN)) < 0.5,
                    favourite[who][:, None],
                    rng.choice(n_articles, (n_rows, HISTORY_LEN), p=probs) + 1)
    hist[np.arange(HISTORY_LEN) >= rng.integers(0, HISTORY_LEN + 1,
                                                n_rows)[:, None]] = 0
    rows = {
        "customer_id": active[who].astype(np.int32),
        "purchase_history": hist.astype(np.int32),
        "article_id": article.astype(np.int32),
        "product_type_name": product_type[article].astype(np.int32),
        "colour_group_name": colour[article].astype(np.int32),
    }
    ids = np.arange(1, n_articles + 1)
    catalog = {"article_id": ids.astype(np.int32),
               "product_type_name": product_type[ids].astype(np.int32),
               "colour_group_name": colour[ids].astype(np.int32)}
    return rows, catalog


def write_shards(dirpath, rows):
    """``shard_*.npz`` plus the manifest ``ShardDataset`` reads."""
    from hm_retrieval_tpu_torch.data import MANIFEST_NAME

    dirpath.mkdir(parents=True)
    n = len(next(iter(rows.values())))
    for s, lo in enumerate(range(0, n, SHARD_ROWS)):
        np.savez(dirpath / f"shard_{s:05d}.npz",
                 **{k: v[lo:lo + SHARD_ROWS] for k, v in rows.items()})
    (dirpath / MANIFEST_NAME).write_text(json.dumps({
        "num_rows": n, "num_shards": -(-n // SHARD_ROWS),
        "max_rows": SHARD_ROWS,
        "features": {k: str(v.dtype) for k, v in rows.items()}}))


def training_config(fields, check=False):
    from hm_retrieval_tpu_torch.schema import TrainingConfig

    fields = dict(fields)
    if check and fields.get("optimizer_name") == "adam":
        fields["optimizer_kwargs"] = {**fields["optimizer_kwargs"],
                                      "eps": CHECK_ADAM_EPS}
    return TrainingConfig(**fields)


def to_device(batch, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def phase_training_vs_cpu(dev):
    """Each path's card step against the port's own CPU step at a reduced
    vocabulary and the full widths: 3 steps (one chunk of 3 on the chunked
    path) from one state, the loss and every tensor of the state within
    TRAIN_RTOL / TRAIN_ATOL."""
    from hm_retrieval_tpu_torch.data import make_chunked_train_step
    from hm_retrieval_tpu_torch.models import (
        make_single_device_trainer, train_state_from_numpy,
        train_state_to_numpy,
    )
    from hm_retrieval_tpu_torch.models.mixed_negatives import (
        CandidateCatalog, step_seed,
    )

    rng = np.random.default_rng(1)
    probs, logq = article_popularity(SMALL_ARTICLES)
    rows, catalog_cols = train_columns(rng, 3 * TRAIN_B, SMALL_CUSTOMERS,
                                       SMALL_ARTICLES, probs)
    batches = [{k: v[i * TRAIN_B:(i + 1) * TRAIN_B] for k, v in rows.items()}
               for i in range(3)]
    out = {}
    for name, fields, history in TRAIN_PATHS:
        tc = training_config(fields, check=True)
        side = []  # (catalog, state, step) on the card, then on the CPU
        for d in (dev, torch.device("cpu")):
            model = train_model(SMALL_CUSTOMERS, SMALL_ARTICLES, logq, history,
                                d)
            catalog = (CandidateCatalog(catalog_cols, device=d)
                       if tc.num_uniform_negatives else None)
            side.append((catalog,
                         *make_single_device_trainer(model, tc, catalog)))
        (card_cat, card_state, card_step), (_, cpu_state, cpu_step) = side
        # one seed gives the card the CPU's initial weights, bit for bit
        require(all(torch.equal(t.cpu(), cpu_state.params[key])
                    for key, t in card_state.params.items()),
                f"{name}: one seed drew other initial weights on the card")
        cpu_state = train_state_from_numpy(cpu_state,
                                           train_state_to_numpy(card_state))
        losses = {"cuda": [], "cpu": []}
        if name.startswith("chunked"):
            stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
            card_state, m = make_chunked_train_step(card_step)(
                card_state, to_device(stacked, dev))
            losses["cuda"] = m["losses"].tolist()
            for b in batches:
                cpu_state, m = cpu_step(cpu_state, to_device(b, "cpu"))
                losses["cpu"].append(float(m["loss"]))
        else:
            gen = torch.Generator(device=dev)
            for b in batches:
                kw = [{}, {}]
                if card_cat is not None:  # the same rows on both sides
                    gen.manual_seed(step_seed(tc.seed, card_state.step))
                    neg = card_cat.sample(gen, tc.num_uniform_negatives)
                    kw = [{"negatives": neg},
                          {"negatives": {k: v.cpu() for k, v in neg.items()}}]
                card_state, m = card_step(card_state, to_device(b, dev), **kw[0])
                losses["cuda"].append(float(m["loss"]))
                cpu_state, m = cpu_step(cpu_state, to_device(b, "cpu"), **kw[1])
                losses["cpu"].append(float(m["loss"]))
        got = {k: t.cpu() for k, t in state_tensors(card_state).items()}
        want = state_tensors(cpu_state)
        require(set(got) == set(want), f"{name}: state layouts differ")
        worst, worst_name = 0.0, None
        for key, w in want.items():
            g = got[key]
            if not w.is_floating_point():
                require(torch.equal(g, w), f"{name}: {key} differs")
                continue
            err = (g - w).abs()
            require(bool((err <= TRAIN_ATOL + TRAIN_RTOL * w.abs()).all()),
                    f"{name}: {key} outside tolerance, max err "
                    f"{float(err.max())}")
            if float(err.max()) > worst:
                worst, worst_name = float(err.max()), key
        lc, lh = np.array(losses["cuda"]), np.array(losses["cpu"])
        require(np.all(np.abs(lc - lh) <= TRAIN_ATOL + TRAIN_RTOL * np.abs(lh)),
                f"{name}: losses {lc} on the card, {lh} on the CPU")
        require(card_state.step == cpu_state.step == 3, f"{name}: step count")
        out[name] = {"init_bitwise": True,
                     "losses_card": lc.tolist(), "losses_cpu": lh.tolist(),
                     "max_abs_err_state": worst, "worst_tensor": worst_name,
                     "tensors": len(want)}
        del side, card_state, cpu_state
    emit({"training_vs_cpu": {"customers": SMALL_CUSTOMERS,
                              "articles": SMALL_ARTICLES, "B": TRAIN_B,
                              "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL,
                              "paths": out}})


def train_step_bound(model, batches, tc):
    """Least time of one step at these batches: (ms, what bounds it, ms of
    the operations at the fp32 peak). Bytes: each batch column and gathered
    row read once; the sparse path reads and writes each touched row of a
    table and its accumulator once (unique ids of this run's batches,
    averaged), the dense path writes a gradient of every parameter and reads
    it with the parameter and its state, writing both back. Operations: the
    towers' products and Q @ Cᵀ, forward and two backward products each."""
    from hm_retrieval_tpu_torch.models.train_path import uses_sparse_step

    sparse = uses_sparse_step(tc)
    adam = tc.optimizer_name.lower() == "adam"
    state_bufs = 2 if adam else 1
    m_neg = tc.num_uniform_negatives
    nbytes = sum(v.nbytes for v in batches[0].values())
    tables = {}
    for tower in (model.query_tower, model.candidate_tower):
        for f in tower.features:
            table = tower.embeddings[f.name]
            rows = TRAIN_B * (f.max_len or 1)
            if tower is model.candidate_tower:
                rows += m_neg
            nbytes += rows * table.shape[1] * 4  # gathered rows
            tables[f.name] = table
    params = dict(model.named_parameters())
    dense_floats = sum(p.numel() for n, p in params.items()
                       if ".embeddings." not in n)
    table_floats = sum(t.numel() for t in tables.values())
    if sparse:
        touched = sum(
            np.mean([len(np.unique(b[f])) for b in batches])
            * tables[f].shape[1] for f in tables)
        nbytes += 4 * touched * 4  # table and accumulator rows, in and out
        opt_floats = dense_floats
    else:
        opt_floats = dense_floats + table_floats
    # gradient written, then gradient, parameter and state read, parameter
    # and state written
    nbytes += opt_floats * 4 * (1 + 1 + 1 + state_bufs + 1 + state_bufs)
    flops = 0
    for tower, n in ((model.query_tower, TRAIN_B),
                     (model.candidate_tower, TRAIN_B + m_neg)):
        flops += sum(2 * n * layer.weight.numel() for layer in tower.dense)
    flops += 2 * TRAIN_B * (TRAIN_B + m_neg) * E
    flops *= 3  # forward, and the two products of the backward
    ms, by = roofline_ms(nbytes, flops)
    return ms, by, flops / FP32_FLOPS * 1e3, nbytes, flops


def profile_steps(step_fn, state, dev_batches, steps_per_call=1):
    """Calls over ``dev_batches`` under torch.profiler: the window's wall ms
    a step, device ms a step, the share of the window the card ran nothing,
    device operations a step and the top device operations by time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for b in dev_batches:
            state, _ = step_fn(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in spans:
        by_name.setdefault(e.name, [0, 0.0])
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    n = len(dev_batches) * steps_per_call
    busy = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return state, {
        "steps": n, "wall_ms": wall_ms / n, "device_ms": busy / n,
        "idle_share": 1 - busy / wall_ms if spans else None,
        "device_ops_per_step": len(spans) / n,
        "top_ops": [{"name": k[:90], "per_step": c / n, "ms_per_step": ms / n}
                    for k, (c, ms) in top],
    }


def run_training_path(name, fields, history, shards, catalog_cols, logq, dev):
    """One path at full H&M width, through the entry points a trainer
    calls: ``make_single_device_trainer``, then
    ``ShardDataset.iter_batches(shuffle) -> device_feed -> step`` (chunked:
    ``device_feed_chunked -> make_chunked_train_step``). TRAIN_WARMUP
    untimed steps, one of them under ``set_sync_debug_mode("error")``, then
    TRAIN_STEPS timed steps; the same steps again on batches already on the
    card; a profiled window. The loss must be finite on every step and lower
    at the end than at the start; on the sparse paths every table row and
    accumulator row no batch touched must be bit-unchanged."""
    from hm_retrieval_tpu_torch.data import (
        ShardDataset, device_feed, device_feed_chunked,
        make_chunked_train_step,
    )
    from hm_retrieval_tpu_torch.models import make_single_device_trainer
    from hm_retrieval_tpu_torch.models.mixed_negatives import CandidateCatalog
    from hm_retrieval_tpu_torch.models.sparse_optimizer import SparseTrainState

    tc = training_config(fields)
    t0 = time.perf_counter()
    model = train_model(N_CUSTOMERS, N_ARTICLES, logq, history, dev)
    catalog = (CandidateCatalog(catalog_cols, device=dev)
               if tc.num_uniform_negatives else None)
    state, step = make_single_device_trainer(model, tc, catalog)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sparse = isinstance(state, SparseTrainState)
    before = {}
    if sparse:
        before = {n: (state.params[n].detach().clone(), acc.clone())
                  for n, acc in state.sparse_state.accumulators.items()}
    k = tc.steps_per_dispatch
    n_batches = TRAIN_WARMUP + TRAIN_STEPS
    host = []

    def recorded(batches):
        for b in batches:
            host.append(b)
            yield b

    batches = recorded(itertools.islice(
        ShardDataset(str(shards)).iter_batches(
            TRAIN_B, tc.shuffle_buffer_size, seed=tc.seed,
            drop_remainder=True),
        n_batches))
    if k > 1:
        feed = device_feed_chunked(batches, k, device=dev)
        fn = make_chunked_train_step(step)
    else:
        feed, fn = device_feed(batches, device=dev), step
    warm_calls = max(2, TRAIN_WARMUP // k)
    timed_steps = n_batches - warm_calls * k
    losses, starts, ends = [], [], []
    for i, b in enumerate(feed):
        if i == warm_calls - 1:  # a warm step must not sync the host
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, m = fn(state, b)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            if i == warm_calls:
                torch.cuda.synchronize()
                wall0 = time.perf_counter()
            if i >= warm_calls:
                starts.append(torch.cuda.Event(enable_timing=True))
                ends.append(torch.cuda.Event(enable_timing=True))
                starts[-1].record()
            state, m = fn(state, b)
            if i >= warm_calls:
                ends[-1].record()
        losses.append(m["losses"] if k > 1 else m["loss"][None])
    torch.cuda.synchronize()
    fed_ms = (time.perf_counter() - wall0) * 1e3 / timed_steps
    event_ms = [s.elapsed_time(e) / k for s, e in zip(starts, ends)]
    losses = torch.cat(losses).cpu().numpy()
    require(len(losses) == n_batches, f"{name}: {len(losses)} steps ran")
    require(bool(np.isfinite(losses).all()), f"{name}: a loss is not finite")
    require(losses[-5:].mean() < losses[:5].mean(),
            f"{name}: the loss did not fall ({losses[:5]} -> {losses[-5:]})")

    # the same steps on batches already on the card: what the feed costs
    timed = host[warm_calls * k:]
    if k > 1:
        timed = [{c: np.stack([b[c] for b in timed[j:j + k]]) for c in timed[0]}
                 for j in range(0, len(timed), k)]
    on_card = [to_device(b, dev) for b in timed]
    torch.cuda.synchronize()
    wall0 = time.perf_counter()
    for b in on_card:
        state, _ = fn(state, b)
    torch.cuda.synchronize()
    on_card_ms = (time.perf_counter() - wall0) * 1e3 / timed_steps
    state, prof = profile_steps(fn, state, on_card[:max(1, 3 // k)], k)

    untouched = {}
    for table, (p0, a0) in before.items():
        feature = table.split(".")[-1]
        mask = torch.ones(p0.shape[0], dtype=torch.bool, device=dev)
        ids = np.unique(np.concatenate([b[feature].reshape(-1) for b in host]))
        mask[torch.from_numpy(ids).to(dev).long()] = False
        p1 = state.params[table].detach()
        a1 = state.sparse_state.accumulators[table]
        require(torch.equal(p1[mask], p0[mask]) and torch.equal(a1[mask],
                                                                 a0[mask]),
                f"{name}: an untouched row of {table} changed")
        touched = ~mask
        touched[0] = False  # OOV / pad row
        moved = (a1[touched] != a0[touched]).any(dim=1)
        require(bool(moved.any()), f"{name}: no touched row of {table} moved")
        untouched[table] = {"untouched_rows": int(mask.sum()),
                            "touched_rows": int(touched.sum()),
                            "touched_rows_moved": int(moved.sum())}
    bound_ms, bound_by, fp32_ops_ms, nbytes, flops = train_step_bound(
        model, host, tc)
    median_ms = statistics.median(event_ms)
    row = {
        "path": name, "B": TRAIN_B, "sparse": sparse,
        "optimizer": tc.optimizer_name, "history_len": HISTORY_LEN * history,
        "uniform_negatives": tc.num_uniform_negatives,
        "steps_per_call": k, "timed_steps": timed_steps, "setup_s": setup_s,
        "median_step_ms": median_ms, "min_step_ms": min(event_ms),
        "max_step_ms": max(event_ms),
        "examples_per_s": TRAIN_B / median_ms * 1e3,
        "fed_wall_ms_per_step": fed_ms, "on_card_wall_ms_per_step": on_card_ms,
        "feed_cost_ms_per_step": fed_ms - on_card_ms,
        "loss_first5": losses[:5].tolist(), "loss_last5": losses[-5:].tolist(),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "fp32_ops_ms": fp32_ops_ms, "bytes": nbytes, "flops": flops,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": prof, "untouched": untouched, "sync_free_step": True,
    }
    emit({"training": row})
    return row


def phase_training_determinism(shards, logq, dev):
    """At full width, 3 sparse and 3 dense Adagrad steps replayed twice from
    one saved state: tables, accumulators, dense params and losses must be
    bit-identical."""
    from hm_retrieval_tpu_torch.data import ShardDataset
    from hm_retrieval_tpu_torch.models import make_single_device_trainer

    host = list(itertools.islice(ShardDataset(str(shards)).iter_batches(
        TRAIN_B, 0, drop_remainder=True), 3))
    batches = [to_device(b, dev) for b in host]
    out = {}
    for name, fields in (("sparse_adagrad", {}),
                         ("dense_adagrad",
                          {"use_sparse_embedding_optimizer": False})):
        model = train_model(N_CUSTOMERS, N_ARTICLES, logq, False, dev)
        state, step = make_single_device_trainer(model,
                                                 training_config(fields), None)
        saved = {n: t.detach().clone() for n, t in state_tensors(state).items()}
        runs = []
        for _ in range(2):
            with torch.no_grad():
                for n, t in state_tensors(state).items():
                    t.copy_(saved[n])
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(m["loss"])
            runs.append(({n: t.detach().clone()
                          for n, t in state_tensors(state).items()},
                         torch.stack(losses)))
        (s1, l1), (s2, l2) = runs
        require(torch.equal(l1, l2), f"{name}: replayed losses differ")
        differ = [n for n in s1 if not torch.equal(s1[n], s2[n])]
        require(not differ, f"{name}: replay differs in {differ}")
        changed = sum(not torch.equal(s1[n], saved[n]) for n in s1)
        out[name] = {"tensors": len(s1), "changed_by_the_steps": changed,
                     "losses": l1.tolist()}
        del model, state, saved, runs, s1, s2
        torch.cuda.empty_cache()
    emit({"training_determinism": out})


def phase_training_chunk_pairs(shards, logq, dev, rounds=8):
    """CHUNK_K single sparse steps against one chunked call of the same
    steps on the same batches already on the card, in turns (which runs
    first alternates): wall ms a step, synchronized, each round."""
    from hm_retrieval_tpu_torch.data import (
        ShardDataset, make_chunked_train_step,
    )
    from hm_retrieval_tpu_torch.models import make_single_device_trainer

    host = list(itertools.islice(ShardDataset(str(shards)).iter_batches(
        TRAIN_B, 0, drop_remainder=True), CHUNK_K))
    model = train_model(N_CUSTOMERS, N_ARTICLES, logq, False, dev)
    state, step = make_single_device_trainer(model, training_config({}),
                                             None)
    singles = [to_device(b, dev) for b in host]
    stacked = to_device({c: np.stack([b[c] for b in host]) for c in host[0]},
                        dev)
    chunk_step = make_chunked_train_step(step)

    def run_single(s):
        for b in singles:
            s, _ = step(s, b)
        return s

    def run_chunked(s):
        return chunk_step(s, stacked)[0]

    runs = [("single", run_single), ("chunked", run_chunked)]
    for _, fn in runs * 2:  # warm-up
        state = fn(state)
    ms = {"single": [], "chunked": []}
    for r in range(rounds):
        for name, fn in runs if r % 2 == 0 else runs[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = fn(state)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / CHUNK_K)
    emit({"training_chunk_pairs": {
        "steps": CHUNK_K, "rounds": rounds, **{f"{n}_ms": v for n, v in
                                               ms.items()},
        **{f"{n}_median_ms": statistics.median(v) for n, v in ms.items()},
        "chunked_faster_rounds": sum(c < s for s, c in zip(ms["single"],
                                                           ms["chunked"]))}})


def phase_training(seed, dev, workdir):
    """Phase 9 (see the module docstring)."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "TF32 is on: the towers must run fp32")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    probs, logq = article_popularity(N_ARTICLES)
    rows, catalog_cols = train_columns(rng, TRAIN_ROWS, N_CUSTOMERS,
                                       N_ARTICLES, probs)
    shards = workdir / "train_shards"
    write_shards(shards, rows)
    emit({"training_setup": {"rows": TRAIN_ROWS, "shards": -(-TRAIN_ROWS //
                                                            SHARD_ROWS),
                             "seconds": time.perf_counter() - t0}})
    phase_training_vs_cpu(dev)
    torch.cuda.empty_cache()
    # --- the main path: counts from 0; training launches no bin-max kernel
    bt.reset_launches()
    qt.reset_launches()
    rows_out = []
    for name, fields, history in TRAIN_PATHS:
        torch.cuda.reset_peak_memory_stats()
        rows_out.append(run_training_path(name, fields, history, shards,
                                          catalog_cols, logq, dev))
        torch.cuda.empty_cache()
    launches = {**bt.LAUNCHES, **qt.LAUNCHES}
    # ----------------------------------------------------------------------
    require(set(launches.values()) == {0},
            f"training launched bin-max kernels: {launches}")
    phase_training_determinism(shards, logq, dev)
    phase_training_chunk_pairs(shards, logq, dev)
    torch.cuda.empty_cache()
    return rows_out


# --- phase 10: the modelling runner -----------------------------------------
RUNNER_TRAIN_ROWS = 128 * TRAIN_B  # one epoch of 128 steps
RUNNER_TEST_ROWS = 8 * 2048  # 8 batches at TrainingConfig's test_batch_size
RUNNER_CHECKED_BATCHES = 2  # test batches held against the plain passes
# Article i of the stream is H&M's article id HM_ARTICLE_BASE + i, written
# zero-padded to 10 digits in the transactions CSV as H&M writes it
# ("0108775015"): read back as integers, as pandas reads them (trap j)
HM_ARTICLE_BASE = 108_775_014
TRAIN_DAYS, TEST_DAYS = 45, 7
TRAIN_START, TEST_START = np.datetime64("2020-08-01"), np.datetime64("2020-09-15")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def runner_settings(rng, n_customers, n_articles, workdir):
    """The runner's inputs: bench.py's H&M schema (ks 10, 100, 1000 and
    TrainingConfig's defaults) with phase 9's logQ, saved with the port's
    ``Schema.save``; train, test and candidate shards written with phase 9's
    writer. Train and test are consecutive rows of one learnable stream, so
    the test rows are held out from the same customers' purchases."""
    from hm_retrieval_tpu_torch.utils import Settings

    probs, logq = article_popularity(n_articles)
    rows, catalog = train_columns(rng, RUNNER_TRAIN_ROWS + RUNNER_TEST_ROWS,
                                  n_customers, n_articles, probs)
    rows.pop("purchase_history")
    write_shards(workdir / "train",
                 {k: v[:RUNNER_TRAIN_ROWS] for k, v in rows.items()})
    write_shards(workdir / "test",
                 {k: v[RUNNER_TRAIN_ROWS:] for k, v in rows.items()})
    write_shards(workdir / "candidates", catalog)
    write_transactions(workdir / "transactions.csv", rows["article_id"])
    article_vocab = np.array([str(HM_ARTICLE_BASE + i)
                              for i in range(1, n_articles + 1)])
    hm_schema(n_customers, n_articles, logq,
              article_vocab).save(str(workdir / "schema"))
    return Settings(
        transactions_filepath=str(workdir / "transactions.csv"),
        train_start_date=str(TRAIN_START),
        train_end_date=str(TRAIN_START + TRAIN_DAYS - 1),
        test_start_date=str(TEST_START),
        test_end_date=str(TEST_START + TEST_DAYS - 1),
        baseline_index_dirpath=str(workdir / "baseline_index"),
        schema_dirpath=str(workdir / "schema"),
        train_shards_dirpath=str(workdir / "train"),
        test_shards_dirpath=str(workdir / "test"),
        candidate_shards_dirpath=str(workdir / "candidates"),
        model_dirpath=str(workdir / "model"),
        index_dirpath=str(workdir / "index"),
        checkpoint_dirpath=str(workdir / "checkpoints"),
        tensorboard_logs_dir=str(workdir / "logs"),
    )  # profile_steps: the default trace window, steps 20-40


def stream_dates(n_train, n_test):
    """t_dat of the stream's rows: the train rows spread over TRAIN_DAYS
    from TRAIN_START, the test rows over TEST_DAYS from TEST_START."""
    train = TRAIN_START + (np.arange(n_train) * TRAIN_DAYS) // n_train
    test = TEST_START + (np.arange(n_test) * TEST_DAYS) // n_test
    return np.concatenate([train, test]).astype(str)


def write_transactions(path, articles):
    """The stream as a transactions CSV (t_dat, article_id), in row order,
    each article written as its zero-padded H&M id."""
    dates = stream_dates(RUNNER_TRAIN_ROWS, RUNNER_TEST_ROWS)
    with open(path, "w") as f:
        f.write("t_dat,article_id\n")
        f.writelines(f"{d},{HM_ARTICLE_BASE + int(a):010d}\n"
                     for d, a in zip(dates, articles))


@contextlib.contextmanager
def host_copies():
    """Inside the block, every copy of a tensor from the card to the host
    (``.cpu()``, ``.to(...)``, ``.tolist()``, ``.copy_`` into a host tensor)
    is recorded as (method, shape, elements)."""
    seen = []
    saved = {name: getattr(torch.Tensor, name)
             for name in ("cpu", "to", "tolist", "copy_")}

    def wrap(name):
        original = saved[name]

        def method(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            if name == "copy_":
                src = args[0] if args else kwargs["src"]
                moved = self.device.type == "cpu" and src.device.type != "cpu"
            else:
                src = self
                moved = self.device.type != "cpu" and (
                    name == "tolist" or out.device.type == "cpu")
            if moved:
                seen.append((name, tuple(src.shape), src.numel()))
            return out
        return method

    for name in saved:
        setattr(torch.Tensor, name, wrap(name))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def profile_eval_batch(model, index, batch, dev):
    """One evaluate batch (query tower, top-k, metric) under torch.profiler:
    wall ms, device ms, idle share, device operations."""
    from torch.profiler import ProfilerActivity, profile

    from hm_retrieval_tpu_torch.metrics import IndexRecall

    metric = IndexRecall([10, 100, SERVE_K])
    sync(dev)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.no_grad(), profile(activities=activities) as prof:
        start = time.perf_counter()
        q = model.query_forward(batch)
        _, ids = index.topk_from_embeddings(q)
        metric.update(ids, batch["article_id"])
        sync(dev)
        wall_ms = (time.perf_counter() - start) * 1e3
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in spans) / 1e3
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1 - busy / wall_ms if spans else None,
            "device_ops": len(spans)}


def trace_reading(settings, dev):
    """The runner's profiler trace over its default window: the file must
    exist and, on the card, hold the card's kernels."""
    path = Path(settings.tensorboard_logs_dir,
                f"trace_from_step_{settings.profile_steps[0]}.json")
    require(path.exists(), f"no profiler trace at {path}")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    require(dev.type != "cuda" or kernels > 0,
            "the profiler trace holds no kernel of the card")
    return {"file": path.name, "bytes": path.stat().st_size,
            "events": len(events), "kernel_events": kernels}


def check_runner_recall(name, res, ks):
    require(set(res) == set(ks), f"{name}: recall at {sorted(res)}")
    require(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()),
            f"{name}: a recall outside [0, 1]: {res}")


def hold_exact_path(model, index, test_ds, tc, dev):
    """The exact index's answers on the first test batches against the same
    index with exact_topk's kernels swapped for their plain versions: values
    within TOL·max(1, |s|), ids swapped only between scores within it, and
    equal recall counts."""
    from hm_retrieval_tpu_torch.metrics import IndexRecall
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    n = index.num_candidates
    require(torch.equal(index.identifiers[:n].cpu(),
                        torch.arange(1, n + 1, dtype=torch.int32)),
            "the catalog is not articles 1..N in order")
    cb = index.embeddings[:n].to(torch.bfloat16)
    plain = {
        "bin_max2_first_round": lambda q, c, L, nv: bt.bin_max2_plain(
            q, c, L, nv),
        "bin_max2_round": lambda q, c, ts, ti, L, nv: bt.bin_max2_plain(
            q, c, L, nv, ts, ti),
    }
    worst, mismatches, recalls = 0.0, 0, []
    batches = itertools.islice(test_ds.iter_batches(tc.test_batch_size),
                               RUNNER_CHECKED_BATCHES)
    for b in batches:
        tb = to_device(b, dev)
        with torch.no_grad():
            q = model.query_forward(tb)
        got_v, got_ids = index.topk_from_embeddings(q)
        with swapped(bt, **plain):
            want_v, want_ids = index.topk_from_embeddings(q)
        scores = bt.plain_scores(q.to(torch.bfloat16), cb)
        finite = torch.isfinite(want_v)
        require(bool(finite.all()) and bool(torch.isfinite(got_v).all()),
                "an unfilled slot in the exact answers")
        err = (got_v - want_v).abs()
        require(bool((err <= TOL * want_v.abs().clamp_min(1.0)).all()),
                f"exact values outside TOL, max err {float(err.max())}")
        diff = got_ids != want_ids
        rows = diff.nonzero()[:, 0]
        s_got = scores[rows, (got_ids[diff] - 1).long()]
        s_want = scores[rows, (want_ids[diff] - 1).long()]
        require(bool(((s_got - s_want).abs()
                      <= TOL * s_want.abs().clamp_min(1.0)).all()),
                "exact ids differ between well-separated scores")
        counts = []
        for ids in (got_ids, want_ids):
            metric = IndexRecall([10, 100, SERVE_K])
            metric.update(ids, tb["article_id"])
            counts.append(metric.hits.tolist())
        require(counts[0] == counts[1],
                f"recall counts differ: kernels {counts[0]}, plain {counts[1]}")
        worst = max(worst, float(err.max()))
        mismatches += int(diff.sum())
        recalls.append(counts[0])
    return {"batches": RUNNER_CHECKED_BATCHES, "B": tc.test_batch_size,
            "max_abs_err": worst, "id_mismatches": mismatches,
            "hits_at_10_100_1000": recalls, "tol": TOL}


def hold_quantized_path(model, qindex, test_ds, tc, dev):
    """The quantized index's single pass on the first test batches, at the
    B, plan and inputs evaluate gives it, against its plain version: the
    pass's (B, L) cells within TOL, ids differing only between pass scores
    within 2*TOL; the answers with the plain pass swapped in bit-equal on
    every row where the two passes keep the same survivors; equal recall
    counts over the batch. Rows whose survivors differ (only by near ties,
    by the cells' check) are counted."""
    from hm_retrieval_tpu_torch.metrics import IndexRecall

    worst, mismatches, other, recalls = 0.0, 0, 0, []
    batches = itertools.islice(test_ds.iter_batches(tc.test_batch_size),
                               RUNNER_CHECKED_BATCHES)
    for b in batches:
        tb = to_device(b, dev)
        with torch.no_grad():
            q = model.query_forward(tb)
        with recorded_passes(plain=False) as rec_k:
            got_v, got_ids = qindex.topk_from_embeddings(q)
        with recorded_passes(plain=True) as rec_p:
            want_v, want_ids = qindex.topk_from_embeddings(q)
        require(len(rec_k) == 1 and len(rec_p) == 1,
                f"{len(rec_k)} passes a batch, plain {len(rec_p)}")
        qp, c, sc, bi, kout = rec_k[0]
        require(qp.shape[0] == tc.test_batch_size,
                f"the pass ran at B = {qp.shape[0]}")
        pout = rec_p[0][4]
        scores = pass_scores(qp, c, sc, bi)
        for vi, ii in ((0, 1), (2, 3)):
            e, m = compare_ranked(kout[vi], kout[ii], pout[vi], pout[ii],
                                  scores)
            worst, mismatches = max(worst, e), mismatches + m
        del scores
        same = ~((kout[1] != pout[1]) | (kout[3] != pout[3])).any(1)
        require(torch.equal(got_v[same], want_v[same])
                and torch.equal(got_ids[same], want_ids[same]),
                "quantized answers differ from the plain pass's where the "
                "survivors agree")
        counts = []
        for ids in (got_ids, want_ids):
            metric = IndexRecall([10, 100, SERVE_K])
            metric.update(ids, tb["article_id"])
            counts.append(metric.hits.tolist())
        require(counts[0] == counts[1], f"quantized recall counts differ: "
                f"kernel {counts[0]}, plain {counts[1]}")
        other += int((~same).sum())
        recalls.append(counts[0])
    return {"batches": RUNNER_CHECKED_BATCHES, "B": tc.test_batch_size,
            "max_abs_err": worst, "id_mismatches": mismatches,
            "rows_with_other_survivors": other,
            "hits_at_10_100_1000": recalls, "tol": TOL}


def phase_runner(seed, dev, workdir, n_customers=N_CUSTOMERS,
                 n_articles=N_ARTICLES):
    """Phase 10 (see the module docstring). Returns each kernel's launches
    in the two paths driven from 0: the runner, then the quantized
    family's build_index + evaluate."""
    from hm_retrieval_tpu_torch.data import ShardDataset
    from hm_retrieval_tpu_torch.indices.builder import collect_catalog_device
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.models.train_path import (
        create_single_device_state,
    )
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.runners import (
        CheckpointManager, build_index, evaluate, evaluation_runner,
        modelling_runner,
    )
    from hm_retrieval_tpu_torch.schema import Schema

    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    settings = runner_settings(np.random.default_rng(seed), n_customers,
                               n_articles, workdir)
    setup_s = time.perf_counter() - t0
    log = Records(logging.INFO)
    runner_log = logging.getLogger("hm_retrieval_tpu_torch.runners.modelling")
    level = runner_log.level
    runner_log.setLevel(logging.INFO)
    runner_log.addHandler(log)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # --- the main path: the runner, counts from 0 -------------------------
    bt.reset_launches()
    qt.reset_launches()
    t0 = time.perf_counter()
    try:
        results = modelling_runner(settings, device=dev)
    finally:
        runner_log.removeHandler(log)
        runner_log.setLevel(level)
    runner_s = time.perf_counter() - t0
    runner_launches = {**bt.LAUNCHES, **qt.LAUNCHES}
    # ----------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    schema = Schema.load(settings.schema_dirpath)
    tc, mc = schema.training_config, schema.model_config
    for name in ("initial", "final"):
        check_runner_recall(name, results[name], mc.ks)
    require(results["final"][100] > results["initial"][100],
            f"recall@100 did not rise: {results}")
    # (on the CPU, where the phase can be rehearsed small, nothing launches)
    require(not cuda or (runner_launches["bin_max2_first_round"] > 0
                         and runner_launches["bin_max2_round"] > 0),
            f"evaluate did not launch kernels 1-2: {runner_launches}")
    require(all(v == 0 for k, v in runner_launches.items()
                if k not in ("bin_max2_first_round", "bin_max2_round")),
            f"the runner launched other kernels: {runner_launches}")
    steps = RUNNER_TRAIN_ROWS // tc.train_batch_size
    ckpt = CheckpointManager(settings.checkpoint_dirpath, device=dev)
    require(ckpt.latest_step() == steps,
            f"checkpoint at step {ckpt.latest_step()}, not {steps}")
    for path in ("two_tower", "query_tower", "candidate_tower"):
        require(Path(settings.model_dirpath, path, "params.npz").exists(),
                f"no exported {path}")
    require(Path(settings.index_dirpath, "index.npz").exists(),
            "no index artifact")
    throughput = [float(m.split()[2]) for m in log.records
                  if m.startswith("Training throughput")]
    require(len(throughput) == 1, f"throughput lines: {throughput}")
    trace = trace_reading(settings, dev)

    # --- eval only, from the checkpoint: equal to the runner's final -------
    t0 = time.perf_counter()
    eval_only = evaluation_runner(settings, device=dev)
    eval_runner_s = time.perf_counter() - t0
    require(eval_only == results["final"],
            f"evaluation_runner {eval_only} != final {results['final']}")

    # --- the restored model: checkpoint, build and evaluate times ---------
    model = TwoTowerModel.create_from_schema(schema, device=dev)
    state = create_single_device_state(model, tc)
    sync(dev)
    t0 = time.perf_counter()
    state = ckpt.restore(state)
    sync(dev)
    restore_ms = (time.perf_counter() - t0) * 1e3
    ckpt.close()
    timing = CheckpointManager(str(workdir / "checkpoint_timing"), device=dev)
    t0 = time.perf_counter()
    timing.save(state.step, state)
    save_copy_ms = (time.perf_counter() - t0) * 1e3
    timing.wait_until_finished()
    save_ms = (time.perf_counter() - t0) * 1e3
    ckpt_bytes = (workdir / "checkpoint_timing" / str(state.step)
                  / "state.npz").stat().st_size
    timing.close()
    shutil.rmtree(workdir / "checkpoint_timing")

    cand_ds = ShardDataset(settings.candidate_shards_dirpath)
    test_ds = ShardDataset(settings.test_shards_dirpath)
    k = min(max(mc.ks), cand_ds.num_rows)
    cbs = tc.candidate_batch_size
    sync(dev)
    t0 = time.perf_counter()
    with host_copies() as build_copies:
        index = build_index(model, cand_ds, cbs, k, device=dev)
        sync(dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    # in all, less than one candidate batch's embeddings may reach the host
    build_moved = sum(n for *_, n in build_copies)
    require(build_moved < cbs * E, f"the build copied {build_moved} "
            f"elements to the host: {build_copies}")
    require(index.method == "pallas" and index._engine == "pallas",
            f"the exact index runs {index._engine!r}")
    n_batches = -(-test_ds.num_rows // tc.test_batch_size)
    t0 = time.perf_counter()
    exact = evaluate(model, index, test_ds, tc.test_batch_size, mc.ks)
    eval_ms = (time.perf_counter() - t0) * 1e3
    require(exact == results["final"],
            f"the restored model's recall {exact} != final {results['final']}")
    t0 = time.perf_counter()
    index.save(str(workdir / "index_timing"))
    index_save_ms = (time.perf_counter() - t0) * 1e3
    first = to_device(next(test_ds.iter_batches(tc.test_batch_size)), dev)
    eval_profile = profile_eval_batch(model, index, first, dev)

    def embed(batch):
        return model.candidate_forward(to_device(batch, dev))

    with host_copies() as copies:
        ids, emb = collect_catalog_device(model.candidate_id_col, embed,
                                          cand_ds.iter_batches(cbs), cbs)
    require(emb.device == index.embeddings.device
            and tuple(emb.shape) == (n_articles, E)
            and sum(n for *_, n in copies) < cbs * E,
            f"collect_catalog_device: {emb.device}, {tuple(emb.shape)}, "
            f"host copies {copies}")
    del emb

    # --- kernels 1-2 against their plain versions on this path ------------
    held = hold_exact_path(model, index, test_ds, tc, dev)

    # --- the quantized family: a reading ----------------------------------
    t0 = time.perf_counter()
    qindex = build_index(model, cand_ds, cbs, k, index_type="quantized",
                         device=dev)
    sync(dev)
    qbuild_ms = (time.perf_counter() - t0) * 1e3
    require(qindex._engine == "pallas", f"quantized runs {qindex._engine!r}")
    # --- the quantized path: counts from 0 --------------------------------
    bt.reset_launches()
    qt.reset_launches()
    t0 = time.perf_counter()
    quantized = evaluate(model, qindex, test_ds, tc.test_batch_size, mc.ks)
    q_eval_ms = (time.perf_counter() - t0) * 1e3
    q_launches = {**bt.LAUNCHES, **qt.LAUNCHES}
    # ----------------------------------------------------------------------
    check_runner_recall("quantized", quantized, mc.ks)
    single = {n: q_launches[n] for n in SINGLE_PASS_KERNELS[:2]}
    require(not cuda or sum(single.values()) > 0,
            f"the quantized evaluate launched no single pass: {q_launches}")
    # --- kernels 3-4 against their plain versions on this path ------------
    q_held = hold_quantized_path(model, qindex, test_ds, tc, dev)
    emit({"runner": {
        "catalog": n_articles, "customers": n_customers, "E": E,
        "train_rows": RUNNER_TRAIN_ROWS, "test_rows": RUNNER_TEST_ROWS,
        "steps": steps, "setup_s": setup_s, "runner_s": runner_s,
        "initial": results["initial"], "final": results["final"],
        "train_examples_per_s": throughput[0],
        "profiler_window": list(settings.profile_steps), "trace": trace,
        "runner_launches": runner_launches,
        "eval_runner_s": eval_runner_s, "eval_runner_equals_final": True,
        "build_index_ms": build_ms, "build_host_copies": len(build_copies),
        "build_host_elements": build_moved,
        "evaluate_ms": eval_ms, "test_batches": n_batches,
        "evaluate_ms_per_batch": eval_ms / n_batches,
        "eval_batch_profile": eval_profile,
        "checkpoint_bytes": ckpt_bytes, "checkpoint_save_ms": save_ms,
        "checkpoint_save_copy_ms": save_copy_ms,
        "checkpoint_restore_ms": restore_ms, "index_save_ms": index_save_ms,
        "peak_mem_gb": peak_gb, "exact_vs_plain": held,
        "quantized": {"recall": quantized, "exact_recall": exact,
                      "k_over": qindex.k_over, "build_ms": qbuild_ms,
                      "evaluate_ms": q_eval_ms,
                      "single_pass_launches": single,
                      "launches": q_launches, "vs_plain": q_held}}})
    launches = {name: runner_launches[name] + q_launches[name]
                for name in runner_launches}
    return launches, {"settings": settings, "initial": results["initial"],
                      "final": results["final"],
                      "model": model, "index": index, "qindex": qindex,
                      "test_ds": test_ds, "tc": tc, "mc": mc}


# --- phase 11: the popularity baseline -------------------------------------


def popularity_reference(articles):
    """The popularity order counted directly: count descending, ties in
    order of first appearance."""
    uniq, first, counts = np.unique(articles, return_index=True,
                                    return_counts=True)
    return uniq[np.lexsort((first, -counts))]


def phase_baseline(ctx, dev):
    """Phase 11 (see the module docstring)."""
    from hm_retrieval_tpu_torch.data import ShardDataset
    from hm_retrieval_tpu_torch.indices import StaticIndex, load_index
    from hm_retrieval_tpu_torch.runners import baseline_modelling_runner

    settings, mc = ctx["settings"], ctx["mc"]
    t0 = time.perf_counter()
    res = baseline_modelling_runner(settings, device=dev)
    sync(dev)
    seconds = time.perf_counter() - t0
    check_runner_recall("baseline", res, mc.ks)
    index = load_index(settings.baseline_index_dirpath, device=dev)
    require(isinstance(index, StaticIndex)
            and index.identifiers.device.type == dev.type,
            f"the static artifact loads as {type(index).__name__}")
    k = max(mc.ks)
    train = ShardDataset(settings.train_shards_dirpath).load_all()["article_id"]
    want = popularity_reference(train)[:k]
    got = index.identifiers.cpu().numpy()
    require(len(got) == k and np.array_equal(got, want),
            "the popularity index is not the train rows' k most popular "
            "articles (the CSV's zero-padded ids read as integers)")
    test = ShardDataset(settings.test_shards_dirpath).load_all()["article_id"]
    plain = {kk: float(np.isin(test, want[:kk]).mean()) for kk in mc.ks}
    require(all(abs(res[kk] - plain[kk]) <= 1e-9 for kk in mc.ks),
            f"baseline recall {res} != counted {plain}")
    emit({"baseline": {"recall": res, "trained_final_recall": ctx["final"],
                       "index_k": int(len(got)), "train_rows": int(len(train)),
                       "test_rows": int(len(test)), "seconds": seconds}})


# --- phase 12: the sharded serving index ------------------------------------

SHARDS = 4  # model shards of phase 12's mesh, all on the one card
PAD_B = 37  # query rows on the (2, 2) mesh, padded to 38


def kernel_counts():
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    return {**bt.LAUNCHES, **qt.LAUNCHES}


def timed_ms(fn, reps, dev):
    """Device ms of ``fn`` by CUDA events on the card; wall ms elsewhere."""
    if dev.type == "cuda":
        return cuda_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


@contextlib.contextmanager
def plain_exact():
    """Inside the block exact_topk runs kernels 1-2's plain versions."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    with swapped(
        bt,
        bin_max2_first_round=lambda q, c, L, nv: bt.bin_max2_plain(q, c, L, nv),
        bin_max2_round=lambda q, c, ts, ti, L, nv: bt.bin_max2_plain(
            q, c, L, nv, ts, ti),
    ):
        yield


@contextlib.contextmanager
def recorded_survivors():
    """Inside the block every quantized_topk call (one a shard) is recorded
    as (q, codes, scales, bias, values, rows)."""
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    record, driver = [], qt.quantized_topk

    def run(q, codes, scales, k, **kw):
        v, i, r = driver(q, codes, scales, k, **kw)
        record.append((q, codes, scales, kw.get("bias"), v, i))
        return v, i, r

    with swapped(qt, quantized_topk=run):
        yield record


def answers_ok(v, ids, k, n):
    """No NaN, every slot filled with a real article, k distinct a row."""
    require(not bool(torch.isnan(v).any()) and bool(torch.isfinite(v).all()),
            "a NaN or unfilled slot in a sharded answer")
    require(bool(((ids >= 1) & (ids <= n)).all()), "a pad row in an answer")
    require(all(len(set(r)) == k for r in ids.cpu().tolist()),
            "repeated articles in a sharded answer")


def hold_sharded_quantized(index, q, rounds):
    """A sharded quantized index's answers against the same index with its
    passes' plain versions: each shard's survivors within TOL, ids
    differing only between pass scores within 2*TOL; the answers bit-equal
    on every row where all shards keep the same survivors."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    with recorded_survivors() as rec_k:
        got = index.topk_from_embeddings(q)
    plain = plain_rounds() if rounds else recorded_passes(plain=True)
    with recorded_survivors() as rec_p, plain:
        want = index.topk_from_embeddings(q)
    require(len(rec_k) == len(rec_p) == SHARDS,
            f"{len(rec_k)} survivor calls, plain {len(rec_p)}")
    worst, mismatches = 0.0, 0
    same = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    for (qs, codes, sc, bi, kv, ki), (*_, pv, pi) in zip(rec_k, rec_p):
        scores = pass_scores(qs.to(torch.bfloat16), codes, sc, bi)
        err, mism = compare_ranked(kv, ki, pv, pi, scores)
        worst, mismatches = max(worst, err), mismatches + mism
        same &= (ki == pi).all(1)
        del scores
    require(torch.equal(got[0][same], want[0][same])
            and torch.equal(got[1][same], want[1][same]),
            "sharded answers differ from the plain passes' where the "
            "survivors agree")
    return got, {"max_abs_err": worst, "id_mismatches": mismatches,
                 "rows_with_other_survivors": int((~same).sum())}


def recall_vs(ids, exact_ids):
    """Mean share of each row's exact top-k found in ``ids``."""
    hit = (ids.unsqueeze(2) == exact_ids.unsqueeze(1)).any(2)
    return float(hit.float().mean())


def check_pad_rows(index, q, dev):
    """The last shard's pad rows through the bias column: their fp32 scores
    of the bf16 operands are exactly -inf and the real rows' finite, and
    kernel 1 on the same operands returns no NaN and none of them."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    s = SHARDS - 1
    emb, bias = index._emb.shard(s), index._bias.shard(s)
    per = emb.shape[0]
    real = int(torch.isfinite(bias).sum())
    ones = torch.ones((q.shape[0], 1), device=dev)
    q_aug = torch.cat([q, ones], 1).to(torch.bfloat16)
    c_aug = torch.cat([emb, bias[:, None]], 1).to(torch.bfloat16)
    scores = bt.plain_scores(q_aug, c_aug)
    require(bool(torch.isneginf(scores[:, real:]).all())
            and bool(torch.isfinite(scores[:, :real]).all()),
            "a pad row's score is not exactly -inf")
    L = bt.default_bins(SERVE_K)
    width = bt.padded_width(E + 1)
    cells = bt.bin_max2_first_round(
        bt._padded(q_aug, q.shape[0], width),
        bt._padded(c_aug, -(-per // L) * L, width), L, per)
    require(not any(bool(torch.isnan(c).any()) for c in cells[::2]),
            "kernel 1 returned NaN over the bias column")
    for rows in cells[1::2]:
        require(not bool(((rows >= real) & (rows < per)).any()),
                "kernel 1 returned a pad row")
    return {"shard": s, "rows": per, "pad_rows": per - real, "width": width}


def phase_sharded(ctx, repeats, dev, workdir):
    """Phase 12 (see the module docstring). Returns each kernel's launches
    over the main path: the three sharded indices at every served B, the
    (2, 2) mesh at B = 37, the sharded service and evaluation_runner."""
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex, DistributedQuantizedIndex,
        QuantizedIndex, load_distributed_index,
    )
    from hm_retrieval_tpu_torch.metrics import IndexRecall
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import evaluation_runner
    from hm_retrieval_tpu_torch.serving import RetrievalService

    settings, model, exact1 = ctx["settings"], ctx["model"], ctx["index"]
    tc, mc, test_ds = ctx["tc"], ctx["mc"], ctx["test_ds"]
    n = exact1.num_candidates
    k = SERVE_K
    ids = exact1.identifiers[:n].cpu().numpy()
    emb = exact1.embeddings[:n]
    first = to_device(next(test_ds.iter_batches(tc.test_batch_size)), dev)
    with torch.no_grad():
        q_all = model.query_forward(first)[: max(SERVE_BATCHES)]
    mesh = make_mesh(1, SHARDS, devices=[dev] * SHARDS)
    mesh22 = make_mesh(2, 2, devices=[dev] * 4)
    t0 = time.perf_counter()
    single = {
        "exact": exact1,
        "quantized": ctx["qindex"],
        "rounds": QuantizedIndex(k, ids, emb, method="pallas",
                                 pallas_rounds=MAX_ROUNDS, device=dev),
    }
    sharded = {
        "exact": DistributedBruteForceIndex(k, ids, emb, mesh=mesh,
                                            method="pallas"),
        "quantized": DistributedQuantizedIndex(k, ids, emb, mesh=mesh,
                                               method="pallas"),
        "rounds": DistributedQuantizedIndex(k, ids, emb, mesh=mesh,
                                            method="pallas",
                                            pallas_rounds=MAX_ROUNDS),
    }
    pad_index = DistributedBruteForceIndex(k, ids, emb, mesh=mesh22,
                                           method="pallas")
    sync(dev)
    build_s = time.perf_counter() - t0
    require(all(ix._engine == "pallas" for ix in sharded.values()),
            "a sharded index does not run the kernels")
    schema_dir = settings.schema_dirpath
    raw_ids = first["customer_id"][:max(SERVE_BATCHES[:-1])].cpu().tolist()
    raw = {"customer_id": [f"c{c - 1:07d}" for c in raw_ids]}
    sharded_dir = str(workdir / "index_sharded")

    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    per_index, answers = {}, {}
    for name, index in sharded.items():
        per_index[name], answers[name] = {}, {}
        for B in SERVE_BATCHES:
            before = kernel_counts()
            answers[name][B] = index.topk_from_embeddings(q_all[:B])
            per_index[name][B] = {kn: v - before[kn]
                                  for kn, v in kernel_counts().items()
                                  if v > before[kn]}
    padded = pad_index.topk_from_embeddings(q_all[:PAD_B])
    svc_d = RetrievalService.load(schema_dir, settings.model_dirpath,
                                  settings.index_dirpath, mesh=mesh,
                                  distributed_index=True, device=dev)
    served = svc_d.retrieve(raw)
    res_d = evaluation_runner(
        dataclasses.replace(settings, index_dirpath=sharded_dir),
        mesh=mesh, distributed_index=True, device=dev)
    sync(dev)
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    cuda = dev.type == "cuda"
    want_kernels = {
        "exact": ("bin_max2_first_round", "bin_max2_round"),
        "quantized": SINGLE_PASS_KERNELS[:2],
        "rounds": ROUNDS_KERNELS,
    }
    for name, kernels in want_kernels.items():
        require(not cuda or all(
            sum(by_b.get(kn, 0) for by_b in per_index[name].values()) > 0
            for kn in kernels), f"sharded {name} launched {per_index[name]}")
    require(launches["bin_max_round"] == 0
            and launches["bin_max2_raw_fold_pass"] == 0,
            f"the sharded path launched kernels 5 or 8: {launches}")

    # --- each index against its plain passes and the single-device one ---
    held = {}
    for B in SERVE_BATCHES:
        q = q_all[:B]
        exact_scores = bt.plain_scores(q.to(torch.bfloat16),
                                       emb.to(torch.bfloat16))
        fp32_top = torch.topk(bt.plain_scores(q, emb), k, dim=1).indices + 1
        got = answers["exact"][B]
        with plain_exact():
            want = sharded["exact"].topk_from_embeddings(q)
        answers_ok(*got, k, n)
        e_plain = compare_ranked(got[0], got[1] - 1, want[0], want[1] - 1,
                                 exact_scores, gap=TOL)
        one = single["exact"].topk_from_embeddings(q)
        e_single = compare_ranked(got[0], got[1] - 1, one[0], one[1] - 1,
                                  exact_scores, gap=TOL)
        held[f"exact_B{B}"] = {"vs_plain": e_plain, "vs_single": e_single}
        del exact_scores
        for name, rounds in (("quantized", False), ("rounds", True)):
            got, st = hold_sharded_quantized(sharded[name], q, rounds)
            answers_ok(*got, k, n)
            one = single[name].topk_from_embeddings(q)
            st["recall_vs_fp32"] = recall_vs(got[1], fp32_top)
            st["single_recall_vs_fp32"] = recall_vs(one[1], fp32_top)
            require(st["recall_vs_fp32"] >= st["single_recall_vs_fp32"] - 0.005,
                    f"sharded {name} at B={B} loses recall: {st}")
            held[f"{name}_B{B}"] = st
        del fp32_top
    pad_rows = check_pad_rows(sharded["exact"], q_all[:128], dev)
    scores = bt.plain_scores(q_all[:PAD_B].to(torch.bfloat16),
                             emb.to(torch.bfloat16))
    wide = sharded["exact"].topk_from_embeddings(q_all[:PAD_B])
    answers_ok(*padded, k, n)
    held["mesh_2x2_B37"] = compare_ranked(padded[0], padded[1] - 1, wide[0],
                                          wide[1] - 1, scores, gap=TOL)

    # --- the service: the sharded catalog against the single-device one ----
    svc = RetrievalService.load(schema_dir, settings.model_dirpath,
                                settings.index_dirpath, device=dev)
    require(isinstance(svc_d.index, DistributedBruteForceIndex)
            and svc_d.index._engine == "pallas",
            "the sharded service does not run the kernels")
    feat = svc.schema.candidate_id_feature
    want_s = svc.retrieve(raw)
    q_s = svc.embed(svc.encode_query(raw))
    scores = bt.plain_scores(q_s.to(torch.bfloat16), emb.to(torch.bfloat16))
    got_i = torch.from_numpy(feat.encode(np.array(served)).reshape(
        len(served), k)).to(dev)
    want_i = torch.from_numpy(feat.encode(np.array(want_s)).reshape(
        len(want_s), k)).to(dev)
    require(bool((got_i > 0).all()) and all(len(set(r)) == k for r in served),
            "the sharded service answered an unknown or repeated article")
    diff = got_i != want_i
    rows = diff.nonzero()[:, 0]
    s_got = scores[rows, (got_i[diff] - 1).long()]
    s_want = scores[rows, (want_i[diff] - 1).long()]
    require(bool(((s_got - s_want).abs()
                  <= TOL * s_want.abs().clamp_min(1.0)).all()),
            "the sharded service's strings differ between separated scores")
    held["service"] = {"B": len(served), "id_mismatches": int(diff.sum())}

    # --- evaluation_runner: recall counts equal up to ties ----------------
    loaded = load_distributed_index(sharded_dir, mesh)
    files = sorted(p.name for p in Path(sharded_dir).glob("index_shard_*"))
    require(len(files) == SHARDS and loaded.num_candidates == n,
            f"the sharded artifact holds {files}")
    differing = {kk: 0 for kk in mc.ks}
    hits = {"single": [0] * len(mc.ks), "sharded": [0] * len(mc.ks)}
    for b in test_ds.iter_batches(tc.test_batch_size):
        tb = to_device(b, dev)
        with torch.no_grad():
            q = model.query_forward(tb)
        pair = {"single": exact1.topk_from_embeddings(q)[1],
                "sharded": loaded.topk_from_embeddings(q)[1]}
        for side, got_ids in pair.items():
            metric = IndexRecall(mc.ks)
            metric.update(got_ids, tb["article_id"])
            hits[side] = [a + int(h) for a, h in
                          zip(hits[side], metric.hits.tolist())]
        for kk in mc.ks:
            a = pair["single"][:, :kk].sort(1).values
            c = pair["sharded"][:, :kk].sort(1).values
            differing[kk] += int((a != c).any(1).sum())
    rows_n = test_ds.num_rows
    for j, kk in enumerate(mc.ks):
        require(abs(hits["sharded"][j] - hits["single"][j]) <= differing[kk],
                f"recall@{kk}: hit counts {hits} differ beyond the "
                f"{differing[kk]} rows whose top {kk} differ")
        require(abs(res_d[kk] * rows_n - hits["sharded"][j]) < 0.5
                and abs(ctx["final"][kk] * rows_n - hits["single"][j]) < 0.5,
                f"recall@{kk}: runner {res_d[kk]}, counted "
                f"{hits['sharded'][j]} of {rows_n}")

    # --- times: each sharded index beside its single-device one -----------
    times = {}
    for name in sharded:
        for B in SERVE_BATCHES:
            q = q_all[:B]
            times[f"{name}_B{B}"] = {
                side: timed_ms(lambda ix=ix: ix.topk_from_embeddings(q),
                               repeats, dev)
                for side, ix in (("single", single[name]),
                                 ("sharded", sharded[name]))}
    ctx["sharded_ms"] = times
    emit({"sharded": {
        "catalog": n, "E": E, "k": k, "shards": SHARDS,
        "mesh": mesh.shape, "rows_per_shard": sharded["exact"]._emb.per,
        "build_s": build_s, "launches": launches, "per_index": per_index,
        "held": held, "pad_rows": pad_rows, "eval_runner": res_d,
        "eval_runner_single": ctx["final"], "differing_rows": differing,
        "ms": times, "timing": "cuda events, mean of repeats" if cuda
        else "wall"}})
    return launches


# --- phase 13: training over a one-process mesh ------------------------------
MESH_STEPS = 5  # steps each pair holds against the single-device step
MESH_WARMUP, MESH_TIMED = 3, 20  # untimed, then timed steps a mesh path
MESH_SHARDED = ["customer_id", "article_id"]
# (mesh path, its single-device counterpart in TRAIN_PATHS, (data, model),
# row-sharded features), grouped by counterpart
MESH_PATHS = (
    ("dp_dense_adagrad", "dense_adagrad", (4, 1), []),
    ("row_sharded_dense_adagrad_2x2", "dense_adagrad", (2, 2), MESH_SHARDED),
    ("dp_dense_adam", "dense_adam", (4, 1), []),
    ("dp_mixed_negatives", "mixed_negatives", (4, 1), []),
    ("dp_sparse_adagrad", "sparse_adagrad", (4, 1), []),
    ("row_sharded_sparse_2x2", "sparse_adagrad", (2, 2), MESH_SHARDED),
    ("row_sharded_sparse_1x4", "sparse_adagrad", (1, 4), MESH_SHARDED),
)
MESH_RUNNER_SHAPE = (2, 2)


def leaf_tensors(x):
    """The tensors of a state's value: a ``ShardedTable``'s shards, else
    the tensor itself."""
    return list(x.shards) if hasattr(x, "shards") else [x]


def state_values(state):
    """Every value of a single-device or mesh training state by a name:
    tensors, and ``ShardedTable``s of the row-sharded tables and their
    optimizer state."""
    out = {f"params/{n}": p for n, p in state.params.items()}
    opt = getattr(state, "opt_state", None) or state.dense_opt_state
    for field_name, value in opt._asdict().items():
        if isinstance(value, torch.Tensor):
            out[f"opt/{field_name}"] = value
        else:
            out.update({f"opt/{field_name}/{n}": t for n, t in value.items()})
    if hasattr(state, "sparse_state"):
        out.update({f"acc/{n}": t
                    for n, t in state.sparse_state.accumulators.items()})
    return out


def state_tensors(state, rows=None):
    """Every tensor of a training state by a name (``state_values``): a
    row-sharded value joined on the card and cut to ``rows``, the unpadded
    row counts by parameter name."""
    rows = rows or {}
    out = {}
    for key, value in state_values(state).items():
        parts = [p.detach() for p in leaf_tensors(value)]
        t = parts[0] if len(parts) == 1 else torch.cat(parts)
        n = rows.get(key.rsplit("/", 1)[-1])
        out[key] = t[:n] if n is not None else t
    return out


def all_tensors(state):
    return [t for v in state_values(state).values() for t in leaf_tensors(v)]


def snapshot(state):
    """A copy of every tensor of ``state``, in the order ``restore`` reads
    it back."""
    return [t.detach().clone() for t in all_tensors(state)]


@torch.no_grad()
def restore(state, saved, step):
    for t, s in zip(all_tensors(state), saved):
        t.copy_(s)
    return state._replace(step=step)


@torch.no_grad()
def load_values(state, want, step):
    """Copy a single-device state's tensors (``state_tensors``' names)
    into ``state``; a row-sharded value shard by shard, its pad rows left
    as they are."""
    for key, value in state_values(state).items():
        src = want[key]
        if not hasattr(value, "shards"):
            value.detach().copy_(src)
            continue
        r = value.rows_per_shard
        for s, shard in enumerate(value.shards):
            lo, hi = s * r, min((s + 1) * r, src.shape[0])
            if lo < hi:
                shard[: hi - lo].copy_(src[lo:hi])
    return state._replace(step=step)


def step_under(step, state, batch, kw, sync_check):
    """One step; under ``set_sync_debug_mode("error")`` when
    ``sync_check``: a step that reads a value back to the host raises."""
    if not sync_check:
        return step(state, batch, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return step(state, batch, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def hold_close(name, got, want, rtol, atol):
    """Every tensor of ``want`` in ``got`` within rtol / atol; the worst
    absolute error and its tensor."""
    require(set(got) == set(want), f"{name}: state layouts differ: "
            f"{sorted(set(got) ^ set(want))}")
    worst, worst_name = 0.0, None
    for key, w in want.items():
        g = got[key]
        if not w.is_floating_point():
            require(torch.equal(g, w), f"{name}: {key} differs")
            continue
        require(not g.isnan().any(), f"{name}: NaN in {key}")
        err = (g - w).abs()
        require(bool((err <= atol + rtol * w.abs()).all()),
                f"{name}: {key} outside tolerance, max err "
                f"{float(err.max())}")
        if err.numel() and float(err.max()) > worst:
            worst, worst_name = float(err.max()), key
    return worst, worst_name


def max_err(got, want):
    return max(float((g.float() - want[k].float()).abs().max())
               for k, g in got.items() if g.numel())


def check_lookups(table, mesh, ids):
    """``make_sharded_lookup``'s two strategies over a row-sharded table on
    the card against ``table[ids]`` bit for bit; an overflowing capacity
    poisons with NaN."""
    from hm_retrieval_tpu_torch.parallel import make_sharded_lookup

    want = torch.cat(table.shards)[ids.long()]
    out = {}
    for strategy in ("psum", "all_to_all"):
        got = make_sharded_lookup(mesh, strategy)(table, ids)
        require(torch.equal(got, want), f"{strategy} lookup != table[ids]")
        out[strategy] = "bitwise"
    # a capacity of one distinct id an owner, against hundreds
    over = make_sharded_lookup(mesh, "all_to_all", capacity=1)(table, ids)
    require(bool(over.isnan().all()), "capacity overflow did not give NaN")
    out["overflow_nan"] = True
    return out


def time_mesh_path(step, state, host_batches, mesh, negatives_of):
    """``MESH_WARMUP`` untimed and ``MESH_TIMED`` timed steps through
    ``device_feed(mesh=mesh)``, CUDA events each; then 3 steps under the
    profiler."""
    from hm_retrieval_tpu_torch.data import device_feed

    starts, ends, on_card = [], [], []
    for i, b in enumerate(device_feed(iter(host_batches), mesh=mesh)):
        kw = negatives_of(state.step)
        if i >= MESH_WARMUP:
            starts.append(torch.cuda.Event(enable_timing=True))
            ends.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()
        state, _ = step(state, b, **kw)
        if i >= MESH_WARMUP:
            ends[-1].record()
        if len(on_card) < 3:
            on_card.append(b)
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    kw = negatives_of(state.step)
    state, prof = profile_steps(lambda s, b: step(s, b, **kw), state, on_card)
    return state, ms, prof


def phase_mesh_training(seed, dev, n_customers=N_CUSTOMERS,
                        n_articles=N_ARTICLES):
    """Phase 13 (a) and (b) (see the module docstring). Returns a row per
    mesh path."""
    from hm_retrieval_tpu_torch.models import make_single_device_trainer
    from hm_retrieval_tpu_torch.models.mixed_negatives import (
        CandidateCatalog, step_seed,
    )
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.parallel import make_mesh

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed + 13)
    probs, logq = article_popularity(n_articles)
    n_batches = MESH_STEPS + (MESH_WARMUP + MESH_TIMED if cuda else 0)
    rows, catalog_cols = train_columns(rng, n_batches * TRAIN_B, n_customers,
                                       n_articles, probs)
    rows.pop("purchase_history")
    host = [{k: v[i * TRAIN_B:(i + 1) * TRAIN_B] for k, v in rows.items()}
            for i in range(n_batches)]
    batches = [to_device(b, dev) for b in host[:MESH_STEPS]]
    fields = {name: f for name, f, _ in TRAIN_PATHS}
    out, lookups, single = [], None, {}
    for path, single_name, shape, sharded in MESH_PATHS:
        tc = training_config(fields[single_name], check=True)
        if single.get("name") != single_name:
            # the counterpart: its state at the start of each step, from one
            # free-running chain over the same batches (and negatives)
            single.clear()
            if cuda:
                torch.cuda.empty_cache()
            catalog = (CandidateCatalog(catalog_cols, device=dev)
                       if tc.num_uniform_negatives else None)
            negatives = []
            if catalog is not None:  # each step's rows, given to both
                gen = torch.Generator(device=dev)
                for i in range(MESH_STEPS):
                    gen.manual_seed(step_seed(tc.seed, i))
                    negatives.append(
                        catalog.sample(gen, tc.num_uniform_negatives))
            model = train_model(n_customers, n_articles, logq, False, dev)
            state, step = make_single_device_trainer(model, tc, catalog)
            rows_of = {n: p.shape[0] for n, p in state.params.items()}
            chain = [{k: v.clone() for k, v in
                      state_tensors(state, rows_of).items()}]
            losses = []
            for i, b in enumerate(batches):
                kw = {"negatives": negatives[i]} if negatives else {}
                state, m = step(state, b, **kw)
                losses.append(m["loss"])
                chain.append({k: v.clone() for k, v in
                              state_tensors(state, rows_of).items()})
            single = {"name": single_name, "catalog": catalog,
                      "negatives": negatives, "rows": rows_of,
                      "chain": chain, "losses": torch.stack(losses)}
            del model, state, step
        catalog, negatives = single["catalog"], single["negatives"]
        rows_of, chain = single["rows"], single["chain"]
        touched = {f: np.unique(np.concatenate(
            [b[f].reshape(-1) for b in host[:MESH_STEPS]]
            + [n[f].cpu().numpy() for n in negatives if f in n]))
            for f in host[0]}

        t0 = time.perf_counter()
        mesh = make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        model = train_model(n_customers, n_articles, logq, False, dev)
        tc_mesh = dataclasses.replace(tc, sharded_embedding_features=sharded)
        state, step = make_mesh_trainer(model, tc_mesh, mesh, catalog)
        sync(dev)
        setup_s = time.perf_counter() - t0
        # one seed gives the mesh path the single-device initial state
        got = state_tensors(state, rows_of)
        require(all(torch.equal(got[k], v) for k, v in chain[0].items()),
                f"{path}: the initial state differs from the single "
                f"device's")
        saved = snapshot(state)
        full = {k: torch.cat([t.detach() for t in leaf_tensors(v)])
                for k, v in state_values(state).items()
                if hasattr(v, "shards")}
        pads0 = {k: t[rows_of[k.rsplit("/", 1)[-1]]:].clone()
                 for k, t in full.items()}
        del full
        if sharded and lookups is None:
            lookups = check_lookups(
                state.params["query_tower.embeddings.customer_id"], mesh,
                batches[0]["customer_id"])
        # --- (a) each step from the single-device chain's state -----------
        worst, worst_name, losses = 0.0, None, []
        for i, b in enumerate(batches):
            state = load_values(state, chain[i], i)
            kw = {"negatives": negatives[i]} if negatives else {}
            state, m = step_under(step, state, b, kw, cuda and i == 1)
            losses.append(m["loss"])
            got = state_tensors(state, rows_of)
            err, err_name = hold_close(f"{path} step {i}", got, chain[i + 1],
                                       TRAIN_RTOL, TRAIN_ATOL)
            if err >= worst:
                worst, worst_name = err, f"step {i}: {err_name}"
        losses = torch.stack(losses)
        require(bool(torch.isfinite(losses).all()), f"{path}: a loss is NaN")
        require(bool(torch.allclose(losses, single["losses"], rtol=1e-5,
                                    atol=0)),
                f"{path}: losses {losses.tolist()} against the single "
                f"device's {single['losses'].tolist()}")
        # --- replays: 5 free-running steps twice from the initial state ---
        runs = []
        for _ in range(2):
            state = restore(state, saved, 0)
            run_losses = []
            for i, b in enumerate(batches):
                kw = {"negatives": negatives[i]} if negatives else {}
                state, m = step(state, b, **kw)
                run_losses.append(m["loss"])
            runs.append((snapshot(state), torch.stack(run_losses)))
        require(torch.equal(runs[0][1], runs[1][1]),
                f"{path}: replayed losses differ")
        require(all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0])),
                f"{path}: the replays' states differ")
        # the free-running chain against the single-device one: a reading
        # (a ReLU whose input is within rounding of 0 can take another side)
        free = state_tensors(state, rows_of)
        free_err = max_err({k: v for k, v in free.items()
                            if k.startswith("params/")}, chain[-1])
        # pad rows as they started; rows no step touched bit-unchanged
        init = dict(zip([id(t) for t in all_tensors(state)], saved))
        for k, pad in pads0.items():
            now = torch.cat([t.detach() for t in
                             leaf_tensors(state_values(state)[k])])
            require(torch.equal(now[rows_of[k.rsplit("/", 1)[-1]]:], pad),
                    f"{path}: a pad row of {k} changed")
        untouched = 0
        for key, value in state_values(state).items():
            if ".embeddings." not in key or key.startswith("opt/"):
                continue
            feature = key.rsplit(".", 1)[-1]
            for s, t in enumerate(leaf_tensors(value)):
                ids = touched[feature] - s * t.shape[0]
                ids = ids[(ids >= 0) & (ids < t.shape[0])]
                mask = torch.ones(t.shape[0], dtype=torch.bool, device=dev)
                mask[torch.from_numpy(ids).to(dev).long()] = False
                require(torch.equal(t.detach()[mask], init[id(t)][mask]),
                        f"{path}: an untouched row of {key} changed")
                untouched += int(mask.sum())
        del runs, init, saved
        row = {"path": path, "single_device": single_name,
               "mesh": {"data": shape[0], "model": shape[1]},
               "sharded": sharded, "B": TRAIN_B, "setup_s": setup_s,
               "losses": losses.tolist(),
               "single_losses": single["losses"].tolist(),
               "max_abs_err_per_step": worst, "worst_tensor": worst_name,
               "free_running_params_max_abs_err": free_err,
               "tensors": len(chain[0]), "pad_rows": sum(
                   v.shape[0] for k, v in pads0.items()
                   if k.startswith("params/")),
               "untouched_rows_checked": untouched,
               "replay_bitwise": True, "sync_free_step": cuda,
               "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL}
        # --- (b) time ---------------------------------------------------------
        if cuda:
            def negatives_of(step_no, catalog=catalog, tc=tc):
                if catalog is None:
                    return {}
                g = torch.Generator(device=dev)
                g.manual_seed(step_seed(tc.seed, step_no))
                return {"negatives": catalog.sample(
                    g, tc.num_uniform_negatives)}

            # the baseline holds the single-device chain and this path's
            # state; the peak adds what the steps allocate
            torch.cuda.reset_peak_memory_stats()
            base_gb = torch.cuda.memory_allocated() / 1e9
            state, ms, prof = time_mesh_path(step, state, host[MESH_STEPS:],
                                             mesh, negatives_of)
            median = statistics.median(ms)
            row.update({
                "timed_steps": len(ms), "median_step_ms": median,
                "min_step_ms": min(ms), "max_step_ms": max(ms),
                "examples_per_s": TRAIN_B / median * 1e3, "profile": prof,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "held_before_steps_gb": base_gb})
        emit({"mesh_training": row})
        out.append(row)
        del model, state, step, got, free, pads0
        if cuda:
            torch.cuda.empty_cache()
    single.clear()
    emit({"mesh_lookups": lookups})
    return out


def phase_mesh_runner(ctx, dev, workdir):
    """Phase 13 (c) (see the module docstring). Returns each kernel's
    launches over the runner over the mesh."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import (
        CheckpointManager, evaluation_runner, modelling_runner,
    )
    from hm_retrieval_tpu_torch.schema import Schema
    from hm_retrieval_tpu_torch.utils.pytree_io import load_pytree_npz

    cuda = dev.type == "cuda"
    settings = ctx["settings"]
    schema = Schema.load(settings.schema_dirpath)
    schema.training_config = dataclasses.replace(
        schema.training_config, sharded_embedding_features=MESH_SHARDED)
    schema.save(str(workdir / "mesh_schema"))
    settings = dataclasses.replace(
        settings, schema_dirpath=str(workdir / "mesh_schema"),
        checkpoint_dirpath=str(workdir / "mesh_checkpoints"),
        model_dirpath=str(workdir / "mesh_model"),
        index_dirpath=str(workdir / "mesh_index"),
        tensorboard_logs_dir=None, profile_steps=None)
    D, S = MESH_RUNNER_SHAPE
    mesh = make_mesh(D, S, devices=[dev] * (D * S))
    log = Records(logging.INFO)
    loggers = [logging.getLogger(f"hm_retrieval_tpu_torch.{name}")
               for name in ("runners.modelling", "models.train_path")]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.INFO)
        lg.addHandler(log)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # --- the main path: the runner over the mesh, counts from 0 ------------
    bt.reset_launches()
    qt.reset_launches()
    t0 = time.perf_counter()
    try:
        results = modelling_runner(settings, mesh=mesh, distributed_index=True,
                                   device=dev)
    finally:
        for lg, level in zip(loggers, levels):
            lg.removeHandler(log)
            lg.setLevel(level)
    runner_s = time.perf_counter() - t0
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    tc, mc = schema.training_config, schema.model_config
    for name in ("initial", "final"):
        check_runner_recall(name, results[name], mc.ks)
    require(results["final"][100] > results["initial"][100],
            f"recall@100 over the mesh did not rise: {results}")
    require(not cuda or (launches["bin_max2_first_round"] > 0
                         and launches["bin_max2_round"] > 0),
            f"the mesh's evaluate did not launch kernels 1-2: {launches}")
    require(all(v == 0 for k, v in launches.items()
                if k not in ("bin_max2_first_round", "bin_max2_round")),
            f"the runner over the mesh launched other kernels: {launches}")
    throughput = [float(m.split()[2]) for m in log.records
                  if m.startswith("Training throughput")]
    require(len(throughput) == 1, f"throughput lines: {throughput}")
    require(any("row-sharded sparse" in m for m in log.records),
            "the runner did not take the row-sharded sparse step")
    steps = RUNNER_TRAIN_ROWS // tc.train_batch_size
    ckpt = CheckpointManager(settings.checkpoint_dirpath, device=dev)
    require(ckpt.latest_step() == steps,
            f"checkpoint at step {ckpt.latest_step()}, not {steps}")
    # the exported towers: phase 10's unpadded shapes
    for tower in ("query_tower", "candidate_tower"):
        got = load_pytree_npz(f"{settings.model_dirpath}/{tower}/params.npz")
        want = load_pytree_npz(
            f"{ctx['settings'].model_dirpath}/{tower}/params.npz")
        shapes = [(np.shape(a), np.shape(b)) for a, b in zip(
            flatten_tree(got), flatten_tree(want))]
        require(all(a == b for a, b in shapes) and len(shapes) == len(
            flatten_tree(want)), f"exported {tower} shapes {shapes}")

    # --- eval only over the mesh, from the checkpoint ----------------------
    ckpt.close()
    with checkpoint_times() as ckpt_ms:
        t0 = time.perf_counter()
        eval_only = evaluation_runner(
            dataclasses.replace(settings,
                                index_dirpath=str(workdir / "mesh_index_eval")),
            mesh=mesh, distributed_index=True, device=dev)
        eval_runner_s = time.perf_counter() - t0
        require(eval_only == results["final"],
                f"evaluation_runner {eval_only} != final {results['final']}")
        # --- a resumed run continues the step count -------------------------
        resumed = modelling_runner(settings, mesh=mesh, resume=True,
                                   distributed_index=True, device=dev)
    ckpt = CheckpointManager(settings.checkpoint_dirpath, device=dev)
    require(ckpt.latest_step() == 2 * steps,
            f"the resumed run ended at step {ckpt.latest_step()}")
    require(resumed["initial"] == results["final"],
            f"the resumed run began at {resumed['initial']}, not "
            f"{results['final']}")
    require(len(ckpt_ms["restore"]) == 2 and len(ckpt_ms["write"]) == 1,
            f"checkpoint operations: {ckpt_ms}")
    ckpt_bytes = (Path(settings.checkpoint_dirpath) / str(2 * steps)
                  / "state.npz").stat().st_size
    ctx.update(mesh_settings=settings, mesh_initial=results["initial"],
               mesh_final=results["final"], mesh_resumed=resumed["final"])
    emit({"mesh_runner": {
        "mesh": mesh.shape, "sharded": MESH_SHARDED,
        "distributed_index": True, "steps": steps, "runner_s": runner_s,
        "initial": results["initial"], "final": results["final"],
        "single_device_initial": ctx["initial"],
        "single_device_final": ctx["final"],
        "train_examples_per_s": throughput[0], "trace": "off",
        "launches": launches, "eval_runner_s": eval_runner_s,
        "eval_runner_equals_final": True, "checkpoint_bytes": ckpt_bytes,
        "checkpoint_save_copy_ms": ckpt_ms["copy"][0],
        "checkpoint_save_ms": ckpt_ms["copy"][0] + ckpt_ms["write"][0],
        "checkpoint_restore_ms": ckpt_ms["restore"],
        "resumed_final": resumed["final"], "resumed_steps": 2 * steps,
        "peak_mem_gb": peak_gb}})
    return launches


# --- phase 14: several processes on the one card ----------------------------
PROC_RANKS = 2  # ranks of phase 14's gloo group, both on the one card
PROC_TIMEOUT = 480  # seconds the parent waits for both ranks
PROC_STEPS = 3  # steps each path holds against the single-device chain
# timed steps after the held ones, and steps under the profiler on rank 0
PROC_TIMED = {"sparse": 10, "dense": 2}
PROC_PROFILED = {"sparse": 3, "dense": 1}
# (path, its single-device counterpart in TRAIN_PATHS, (data, model),
# row-sharded features)
PROC_PATHS = (
    ("dp_sparse_adagrad", "sparse_adagrad", (4, 1), []),
    ("row_sharded_sparse_1x4", "sparse_adagrad", (1, 4), MESH_SHARDED),
    ("dp_dense_adagrad", "dense_adagrad", (4, 1), []),
)


def sync_card():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def exchanged():
    """Inside the block, the bytes this rank sends through the group's
    exchanges (``exchange_bytes``, ``broadcast_from``) and their wall ms,
    synchronised."""
    from hm_retrieval_tpu_torch.parallel import collectives as co

    rec = {"calls": 0, "bytes": 0, "ms": 0.0}
    fns = {"exchange_bytes": co.exchange_bytes,
           "broadcast_from": co.broadcast_from}

    def sent(name, args):
        if name == "exchange_bytes":
            return sum(t.numel() * t.element_size() for t in args[0])
        shape, dtype = args[1], args[2]
        return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()

    def timed(name):
        def run(*args, **kwargs):
            sync_card()
            t0 = time.perf_counter()
            out = fns[name](*args, **kwargs)
            sync_card()
            rec["ms"] += (time.perf_counter() - t0) * 1e3
            rec["calls"] += 1
            rec["bytes"] += sent(name, args)
            return out
        return run

    with swapped(co, **{name: timed(name) for name in fns}):
        yield rec


def fingerprint(t, chunk=1 << 24):
    """An exact integer of ``t``'s bits (a weighted sum of its 32-bit
    words, in chunks), equal on two ranks only if their tensors almost
    surely are."""
    words = t.detach().contiguous().reshape(-1).view(torch.int32)
    total = 0
    for lo in range(0, words.numel(), chunk):
        w = words[lo:lo + chunk].long()
        weights = torch.arange(lo, lo + w.numel(), device=w.device) % 1000003
        total += int((w * (weights + 1)).sum())
    return total


def local_pieces(state):
    """Each value of a training state (``state_values``) as this rank's
    (first row, tensor) pieces: a row-sharded value's held shards."""
    out = {}
    for key, value in state_values(state).items():
        if hasattr(value, "shards"):
            r = value.rows_per_shard
            out[key] = [(s * r, t) for s, t in enumerate(value.shards)
                        if t is not None]
        else:
            out[key] = [(0, value)]
    return out


@torch.no_grad()
def load_pieces(state, want, step):
    """Copy a single-device state's tensors into this rank's pieces, pad
    rows left as they are."""
    for key, pieces in local_pieces(state).items():
        src = want[key]
        for lo, t in pieces:
            n = max(0, min(t.shape[0], src.shape[0] - lo))
            t[:n].copy_(src[lo:lo + n])
    return state._replace(step=step)


def hold_pieces(name, state, want):
    """This rank's pieces against a single-device state within rtol / atol;
    the worst absolute error."""
    worst = 0.0
    for key, pieces in local_pieces(state).items():
        for lo, t in pieces:
            n = max(0, min(t.shape[0], want[key].shape[0] - lo))
            g, w = t.detach()[:n], want[key][lo:lo + n]
            if not w.is_floating_point():
                require(torch.equal(g, w), f"{name}: {key} differs")
                continue
            err = (g - w).abs()
            require(bool((err <= TRAIN_ATOL + TRAIN_RTOL * w.abs()).all()),
                    f"{name}: {key} outside tolerance, max err "
                    f"{float(err.max())}")
            if err.numel():
                worst = max(worst, float(err.max()))
    return worst


def replicated_prints(state):
    """Fingerprints of the state's replicated tensors, in a fixed order:
    every rank holds them, and they must agree bit for bit."""
    return [fingerprint(v) for _, v in sorted(state_values(state).items())
            if not hasattr(v, "shards")]


def proc_serve(rank, spec, dev, repeats, workdir):
    """Phase 14 (a) on one rank: the exact and the one-pass sharded index
    over (1, 4), shards 2r and 2r + 1 here."""
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex, DistributedQuantizedIndex,
    )
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh

    with np.load(spec["catalog"]) as z:
        ids, emb = z["identifiers"], z["embeddings"]
    q_all = torch.from_numpy(np.load(spec["queries"])).to(dev)
    mesh = make_mesh(1, SHARDS, devices=[dev] * (SHARDS // PROC_RANKS))
    mine = [SHARDS // PROC_RANKS * rank + j for j in range(SHARDS // PROC_RANKS)]
    require(mesh.local_cols() == mine and mesh.process_count == PROC_RANKS,
            f"rank {rank} holds columns {mesh.local_cols()}")
    indices = {
        "exact": DistributedBruteForceIndex(SERVE_K, ids, emb, mesh=mesh,
                                            method="pallas"),
        "quantized": DistributedQuantizedIndex(SERVE_K, ids, emb, mesh=mesh,
                                               method="pallas"),
    }
    require(all(ix._engine == "pallas" for ix in indices.values()),
            "a sharded index does not run the kernels")
    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    answers = {}
    with exchanged() as ex:
        for name, ix in indices.items():
            for B in SERVE_BATCHES:
                v, i = ix.topk_from_embeddings(q_all[:B])
                answers[f"{name}_B{B}_scores"] = v.cpu().numpy()
                answers[f"{name}_B{B}_ids"] = i.cpu().numpy()
    sync(dev)
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    np.savez(workdir / f"answers{rank}.npz", **answers)
    times = {}
    for name, ix in indices.items():
        for B in SERVE_BATCHES:
            q = q_all[:B]
            ms = timed_ms(lambda ix=ix, q=q: ix.topk_from_embeddings(q),
                          repeats, dev)
            with exchanged() as one:
                ix.topk_from_embeddings(q)
            times[f"{name}_B{B}"] = {"ms": ms, "exchange_bytes": one["bytes"],
                                     "exchange_ms": one["ms"]}
    return {"mesh": [1, SHARDS], "columns": mine, "launches": launches,
            "exchange": ex, "ms": times}


def proc_eval(rank, spec, dev, workdir):
    """Phase 14 (b) on one rank: ``evaluation_runner`` over (2, 2), data
    row r here, with and without the sharded index; ``to_local``."""
    import hashlib

    from hm_retrieval_tpu_torch.indices import DistributedBruteForceIndex
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import evaluation_runner
    from hm_retrieval_tpu_torch.utils.settings import Settings

    settings = Settings.from_json(spec["settings"])
    mesh = make_mesh(2, 2, devices=[dev] * 2)
    require(mesh.local_rows() == [rank], f"rank {rank}: rows "
            f"{mesh.local_rows()}")
    plain_dir, dist_dir = workdir / "proc_index", workdir / "proc_index_dist"
    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    with exchanged() as ex:
        t0 = time.perf_counter()
        plain = evaluation_runner(
            dataclasses.replace(settings, index_dirpath=str(plain_dir)),
            mesh=mesh, device=dev)
        t1 = time.perf_counter()
        sharded = evaluation_runner(
            dataclasses.replace(settings, index_dirpath=str(dist_dir)),
            mesh=mesh, distributed_index=True, device=dev)
        t2 = time.perf_counter()
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    index = DistributedBruteForceIndex.load(str(dist_dir), mesh=mesh)
    with exchanged() as to_local_ex:
        flat = index.to_local()
    n = flat.num_candidates
    digest = hashlib.sha256(
        flat.embeddings[:n].cpu().numpy().tobytes()
        + flat.identifiers[:n].cpu().numpy().tobytes()).hexdigest()
    files = sorted(p.name for p in dist_dir.glob("index_shard_*.npz"))
    return {"mesh": [2, 2], "row": rank,
            "recall": {str(k): v for k, v in plain.items()},
            "recall_sharded": {str(k): v for k, v in sharded.items()},
            "runner_s": t1 - t0, "runner_sharded_s": t2 - t1,
            "launches": launches, "exchange": ex, "to_local_digest": digest,
            "to_local_exchange": to_local_ex, "shard_files": files}


def proc_train_path(rank, path, single_name, shape, sharded, host, logq,
                    dev, sizes):
    """Phase 14 (c) for one path on one rank (see ``proc_train``)."""
    from hm_retrieval_tpu_torch.data import device_feed
    from hm_retrieval_tpu_torch.models import make_single_device_trainer
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.parallel import make_mesh

    kind = "sparse" if "sparse" in path else "dense"
    fields = {name: f for name, f, _ in TRAIN_PATHS}
    tc = training_config(fields[single_name], check=True)
    batches = [to_device(b, dev) for b in host[:PROC_STEPS]]
    # the single-device chain: its state at each step (the same bits on
    # both ranks: one card, one program)
    model = train_model(*sizes, logq, False, dev)
    state, step = make_single_device_trainer(model, tc)
    rows_of = {n: p.shape[0] for n, p in state.params.items()}
    chain = [{k: v.clone() for k, v in state_tensors(state, rows_of).items()}]
    single_losses = []
    for b in batches:
        state, m = step(state, b)
        single_losses.append(m["loss"])
        chain.append({k: v.clone() for k, v in
                      state_tensors(state, rows_of).items()})
    single_losses = torch.stack(single_losses)
    del model, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    D, S = shape
    mesh = make_mesh(D, S, devices=[dev] * (D * S // PROC_RANKS))
    rows = mesh.local_rows()
    b = TRAIN_B // D

    def local(batch):
        """This rank's rows of a global batch: its data rows'."""
        return {k: v[rows[0] * b:(rows[-1] + 1) * b] for k, v in
                batch.items()}

    model = train_model(*sizes, logq, False, dev)
    state, step = make_mesh_trainer(
        model, dataclasses.replace(tc, sharded_embedding_features=sharded),
        mesh)
    sync(dev)
    held0 = hold_pieces(f"{path} initial", state, chain[0])
    require(held0 == 0.0, f"{path}: the initial state differs from the "
            "single device's")
    saved = [t.detach().clone() for p in local_pieces(state).values()
             for _, t in p]
    # --- (c) each step from the single-device chain's state ---------------
    worst, losses, prints = 0.0, [], []
    bytes_a_step = []
    for i, batch in enumerate(batches):
        state = load_pieces(state, chain[i], i)
        with exchanged() as ex:
            state, m = step(state, local(batch))
            sync(dev)
        bytes_a_step.append(ex["bytes"])
        losses.append(m["loss"])
        worst = max(worst, hold_pieces(f"{path} step {i}", state,
                                       chain[i + 1]))
        prints.append(replicated_prints(state))
    losses = torch.stack(losses)
    require(bool(torch.isfinite(losses).all()), f"{path}: a loss is NaN")
    require(bool(torch.allclose(losses, single_losses, rtol=1e-6, atol=0)),
            f"{path}: losses {losses.tolist()} against the single device's "
            f"{single_losses.tolist()}")
    # --- replays from the initial state, bit-identical --------------------
    replay_steps = PROC_STEPS if kind == "sparse" else 1
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, s0 in zip([t for p in local_pieces(state).values()
                              for _, t in p], saved):
                t.copy_(s0)
        state = state._replace(step=0)
        run_losses = []
        for batch in batches[:replay_steps]:
            state, m = step(state, local(batch))
            run_losses.append(m["loss"])
        runs.append(([t.detach().clone() for p in
                      local_pieces(state).values() for _, t in p],
                     torch.stack(run_losses)))
    require(torch.equal(runs[0][1], runs[1][1]),
            f"{path}: replayed losses differ")
    require(all(torch.equal(x, y) for x, y in zip(runs[0][0], runs[1][0])),
            f"{path}: the replays' states differ")
    # pad rows as they started; table rows no step touched bit-unchanged
    touched = {f: np.unique(np.concatenate(
        [h[f].reshape(-1) for h in host[:replay_steps]])) for f in host[0]}
    init = dict(zip([id(t) for p in local_pieces(state).values()
                     for _, t in p], saved))
    untouched = pad_rows = 0
    for key, pieces in local_pieces(state).items():
        if ".embeddings." not in key or key.startswith("opt/"):
            continue
        feature = key.rsplit(".", 1)[-1]
        true_rows = chain[0][key].shape[0]
        for lo, t in pieces:
            ids = touched[feature] - lo
            ids = ids[(ids >= 0) & (ids < t.shape[0])]
            mask = torch.ones(t.shape[0], dtype=torch.bool, device=dev)
            mask[torch.from_numpy(ids).to(dev).long()] = False
            require(torch.equal(t.detach()[mask], init[id(t)][mask]),
                    f"{path}: an untouched or pad row of {key} changed")
            untouched += int(mask.sum())
            pad_rows += max(0, lo + t.shape[0] - true_rows)
    del runs, init, saved
    # --- time: steps through device_feed, CUDA events on the card ---------
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    timed = PROC_TIMED[kind]
    marks = []
    feed = [local(h) for h in host[PROC_STEPS:PROC_STEPS + timed]]
    with exchanged() as ex_t:
        for fb in device_feed(iter(feed), mesh=mesh):
            marks.append([torch.cuda.Event(enable_timing=True)
                          for _ in range(2)] if cuda else [time.perf_counter()])
            if cuda:
                marks[-1][0].record()
            state, _ = step(state, fb)
            if cuda:
                marks[-1][1].record()
            else:
                marks[-1].append(time.perf_counter())
    sync(dev)
    ms = [x.elapsed_time(y) if cuda else (y - x) * 1e3 for x, y in marks]
    on_card = [to_device(local(h), dev) for h in
               host[PROC_STEPS + timed:PROC_STEPS + timed
                    + PROC_PROFILED[kind]]]
    if rank == 0 and cuda:
        state, prof = profile_steps(step, state, on_card)
    else:  # the same steps, so the collectives pair up
        for fb in on_card:
            state, _ = step(state, fb)
        prof = None
    sync(dev)
    return {
        "path": path, "single_device": single_name,
        "mesh": {"data": D, "model": S}, "rows": rows,
        "columns": mesh.local_cols(), "sharded": sharded,
        "local_B": b * len(rows), "global_B": TRAIN_B,
        "losses": losses.tolist(), "single_losses": single_losses.tolist(),
        "max_abs_err_per_step": worst, "rtol": TRAIN_RTOL,
        "atol": TRAIN_ATOL, "replicated_prints": prints,
        "replay_bitwise": True, "replay_steps": replay_steps,
        "untouched_rows_checked": untouched, "pad_rows": pad_rows,
        "bytes_sent_per_step": bytes_a_step, "timed_steps": len(ms),
        "median_step_ms": statistics.median(ms), "step_ms": ms,
        "exchange_ms_per_step": ex_t["ms"] / max(1, len(ms)),
        "profile": prof,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
        else None,
    }


def proc_train(rank, seed, dev, sizes):
    """Phase 14 (c) on one rank: phase 13's stream and model, each path's
    mesh split over the ranks (data-parallel: this rank's data rows fed its
    rows; row-sharded (1, 4): both ranks fed the whole batch)."""
    rng = np.random.default_rng(seed + 13)
    probs, logq = article_popularity(sizes[1])
    n_batches = PROC_STEPS + max(PROC_TIMED.values()) + max(
        PROC_PROFILED.values())
    cols, _ = train_columns(rng, n_batches * TRAIN_B, *sizes, probs)
    cols.pop("purchase_history")
    host = [{k: v[i * TRAIN_B:(i + 1) * TRAIN_B] for k, v in cols.items()}
            for i in range(n_batches)]
    out = []
    for path, single_name, shape, sharded in PROC_PATHS:
        row = proc_train_path(rank, path, single_name, shape, sharded, host,
                              logq, dev, sizes)
        emit({"process_training": {"rank": rank, **{
            k: v for k, v in row.items() if k != "replicated_prints"}}})
        out.append(row)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def proc_runner(rank, spec, dev, workdir):
    """Phase 14 (d) on one rank: phase 13's one-process checkpoint restored
    by the group, then ``modelling_runner`` over (2, 2), both id tables
    row-sharded, the sharded index."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import (
        evaluation_runner, modelling_runner,
    )
    from hm_retrieval_tpu_torch.utils.settings import Settings

    settings = Settings.from_json(spec["mesh_settings"])
    mesh = make_mesh(2, 2, devices=[dev] * 2)
    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    with exchanged() as ex:
        t0 = time.perf_counter()
        reverse = evaluation_runner(
            dataclasses.replace(settings,
                                index_dirpath=str(workdir / "proc_rev")),
            mesh=mesh, distributed_index=True, device=dev)
        t1 = time.perf_counter()
        res = modelling_runner(proc_runner_settings(settings, workdir),
                               mesh=mesh, distributed_index=True, device=dev)
        t2 = time.perf_counter()
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    return {"mesh": [2, 2], "reverse_recall": {str(k): v for k, v in
                                               reverse.items()},
            "initial": {str(k): v for k, v in res["initial"].items()},
            "final": {str(k): v for k, v in res["final"].items()},
            "eval_runner_s": t1 - t0, "runner_s": t2 - t1,
            "launches": launches, "exchange": ex}


def proc_runner_settings(settings, workdir):
    """Where phase 14's group runner writes."""
    return dataclasses.replace(
        settings, checkpoint_dirpath=str(workdir / "proc_ckpt"),
        model_dirpath=str(workdir / "proc_model"),
        index_dirpath=str(workdir / "proc_runner_index"))


def process_rank(rank, workdir, seed, repeats):
    """Phase 14's rank ``rank``: joins the gloo group on the one card, runs
    (a)-(c) and writes its results to ``workdir/rank{rank}.json``."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from hm_retrieval_tpu_torch.parallel.mesh import initialize_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workdir = Path(workdir)
    spec = json.loads((workdir / "spec.json").read_text())
    want = torch.device(spec["device"])
    dev = initialize_multihost(f"file://{workdir / 'rdzv'}", PROC_RANKS, rank,
                               device=None if want.type == "cuda" else want)
    require(dev == want and dist.get_backend() == "gloo",
            f"rank {rank} on {dev} over {dist.get_backend()}")
    t0 = time.perf_counter()
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "world": dist.get_world_size()}
    out["serve"] = proc_serve(rank, spec, dev, repeats, workdir)
    out["eval"] = proc_eval(rank, spec, dev, workdir)
    out["train"] = proc_train(rank, seed, dev, spec["sizes"])
    out["runner"] = proc_runner(rank, spec, dev, workdir)
    out["seconds"] = time.perf_counter() - t0
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if dev.type == "cuda" else None)
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "hm_retrieval_tpu"))
    emit({"process_rank": {k: out[k] for k in (
        "rank", "device", "backend", "world", "seconds", "peak_mem_gb",
        "foreign_modules")}, "serve": out["serve"],
        "eval": out["eval"], "runner": out["runner"]})
    (workdir / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def phase_processes(ctx, seed, repeats, dev, workdir, mesh_rows,
                    n_customers=N_CUSTOMERS, n_articles=N_ARTICLES):
    """Phase 14 (see the module docstring). Returns each kernel's launches
    over both ranks' main paths. On the CPU it rehearses small (phase 10's
    rehearsal sizes for ``ctx``, ``n_customers`` / ``n_articles`` for (c))."""
    import torch.multiprocessing as mp

    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex, DistributedQuantizedIndex,
        load_distributed_index,
    )
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import (
        evaluation_runner, modelling_runner,
    )

    settings, exact1, model = ctx["settings"], ctx["index"], ctx["model"]
    tc = ctx["tc"]
    n = exact1.num_candidates
    ids = exact1.identifiers[:n].cpu().numpy()
    emb = exact1.embeddings[:n]
    first = to_device(next(ctx["test_ds"].iter_batches(tc.test_batch_size)),
                      dev)
    with torch.no_grad():
        q_all = model.query_forward(first)[: max(SERVE_BATCHES)]
    np.savez(workdir / "catalog.npz", identifiers=ids,
             embeddings=emb.cpu().numpy())
    np.save(workdir / "queries.npy", q_all.cpu().numpy())
    settings.to_json(str(workdir / "settings.json"))
    ctx["mesh_settings"].to_json(str(workdir / "mesh_settings.json"))
    # the references: phase 12's one-process S = 4 indices on the same
    # queries, and evaluation_runner over a one-process (2, 2) mesh
    mesh = make_mesh(1, SHARDS, devices=[dev] * SHARDS)
    ref = {}
    for name, ix in (
        ("exact", DistributedBruteForceIndex(SERVE_K, ids, emb, mesh=mesh,
                                             method="pallas")),
        ("quantized", DistributedQuantizedIndex(SERVE_K, ids, emb,
                                                mesh=mesh, method="pallas")),
    ):
        for B in SERVE_BATCHES:
            v, i = ix.topk_from_embeddings(q_all[:B])
            ref[f"{name}_B{B}_scores"] = v.cpu().numpy()
            ref[f"{name}_B{B}_ids"] = i.cpu().numpy()
    ref_sharded = evaluation_runner(
        dataclasses.replace(settings,
                            index_dirpath=str(workdir / "ref_index_22")),
        mesh=make_mesh(2, 2, devices=[dev] * 4), distributed_index=True,
        device=dev)
    del mesh
    (workdir / "spec.json").write_text(json.dumps({
        "catalog": str(workdir / "catalog.npz"),
        "queries": str(workdir / "queries.npy"),
        "settings": str(workdir / "settings.json"),
        "mesh_settings": str(workdir / "mesh_settings.json"),
        "device": str(dev), "sizes": [n_customers, n_articles]}))
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- the ranks ----------------------------------------------------------
    t0 = time.perf_counter()
    procs = mp.start_processes(process_rank,
                               args=(str(workdir), seed, repeats),
                               nprocs=PROC_RANKS, join=False,
                               start_method="spawn")
    deadline = time.monotonic() + PROC_TIMEOUT
    try:
        while not procs.join(timeout=5):
            require(time.monotonic() < deadline,
                    f"phase 14's ranks ran past {PROC_TIMEOUT} s")
    finally:
        for proc in procs.processes:
            if proc.is_alive():
                proc.kill()
        for proc in procs.processes:
            proc.join(10)
    ranks_s = time.perf_counter() - t0
    results = []
    for r in range(PROC_RANKS):
        path = workdir / f"rank{r}.json"
        require(path.exists(), f"rank {r} printed no result")
        results.append(json.loads(path.read_text()))

    # --- (a) bit for bit against phase 12's one-process index --------------
    for r in range(PROC_RANKS):
        require(results[r]["foreign_modules"] == [],
                f"rank {r} imported {results[r]['foreign_modules']}")
        with np.load(workdir / f"answers{r}.npz") as z:
            for key, want in ref.items():
                require(z[key].tobytes() == want.tobytes(),
                        f"rank {r}: {key} differs from the one-process "
                        "sharded index")
    # --- (b) the same recall everywhere -------------------------------------
    final = {str(k): v for k, v in ctx["final"].items()}
    want_sharded = {str(k): v for k, v in ref_sharded.items()}
    ev = [x["eval"] for x in results]
    for r, e in enumerate(ev):
        require(e["recall"] == final,
                f"rank {r}: recall {e['recall']} != phase 10's {final}")
        require(e["recall_sharded"] == want_sharded,
                f"rank {r}: sharded recall {e['recall_sharded']} != the "
                f"one-process (2, 2) runner's {want_sharded}")
        require(e["to_local_digest"] == ev[0]["to_local_digest"],
                "to_local() assembled another catalog on a rank")
        require(len(e["shard_files"]) == 2, f"shard files {e['shard_files']}")
    # --- (c) the ranks' replicated state bit for bit ------------------------
    for j, (path, *_) in enumerate(PROC_PATHS):
        rows = [x["train"][j] for x in results]
        require(all(r["replicated_prints"] == rows[0]["replicated_prints"]
                    and r["losses"] == rows[0]["losses"] for r in rows),
                f"{path}: the ranks' replicated state or losses differ")
    # --- (d) the runner over the group --------------------------------------
    rn = [x["runner"] for x in results]
    resumed = {str(k): v for k, v in ctx["mesh_resumed"].items()}
    for r, x in enumerate(rn):
        require(x["initial"] == rn[0]["initial"]
                and x["final"] == rn[0]["final"],
                f"rank {r}: the runner's recall differs between the ranks")
        require(x["reverse_recall"] == resumed,
                f"rank {r}: phase 13's checkpoint restored by the group gave "
                f"{x['reverse_recall']}, phase 13's run {resumed}")
    # before any step the group evaluates phase 13's initial model exactly;
    # after the epoch its recall is a reading: the ranks feed their own
    # shards in their own order (as JAX's runner does), and the order alone
    # moves recall@100: phase 13's one-process run reshuffled is printed
    # beside it
    mesh_final = {str(k): v for k, v in ctx["mesh_final"].items()}
    require(rn[0]["initial"] == {str(k): v for k, v in
                                 ctx["mesh_initial"].items()},
            f"the group runner began at {rn[0]['initial']}, phase 13's at "
            f"{ctx['mesh_initial']}")
    require(rn[0]["final"]["100"] > rn[0]["initial"]["100"],
            f"recall@100 over the group did not rise: {rn[0]}")
    other_order = modelling_runner(
        proc_runner_settings(ctx["mesh_settings"], workdir / "order"),
        mesh=make_mesh(2, 2, devices=[dev] * 4), distributed_index=True,
        device=dev, training_overrides={"shuffle_buffer_size": SHARD_ROWS})
    g = proc_runner_settings(ctx["mesh_settings"], workdir)
    one = evaluation_runner(
        dataclasses.replace(g, index_dirpath=str(workdir / "proc_one_index")),
        mesh=make_mesh(2, 2, devices=[dev] * 4), distributed_index=True,
        device=dev)
    require({str(k): v for k, v in one.items()} == rn[0]["final"],
            f"the group's checkpoint restored in one process gave {one}, "
            f"the group {rn[0]['final']}")
    loaded = load_distributed_index(g.index_dirpath,
                                    make_mesh(2, 2, devices=[dev] * 4))
    require(loaded.num_candidates == n, "the group's index does not load")
    del loaded
    launches = {}
    for x in results:
        for part in ("serve", "eval", "runner"):
            for k, v in x[part]["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for kn in ("bin_max2_first_round", "bin_max2_round",
               "bin_max2_scaled_single_pass"):
        require(dev.type != "cuda" or launches.get(kn, 0) > 0,
                f"phase 14 launched {launches}")
    phase13 = {row["path"]: row.get("median_step_ms") for row in mesh_rows}
    sharded_ms = ctx.get("sharded_ms", {})
    emit({"processes": {
        "ranks": PROC_RANKS, "backend": results[0]["backend"],
        "device": results[0]["device"], "ranks_s": ranks_s,
        "rank_seconds": [x["seconds"] for x in results],
        "peak_mem_gb": [x["peak_mem_gb"] for x in results],
        "serve_ms": {k: {"ranks": [x["serve"]["ms"][k] for x in results],
                         "phase12_one_process": sharded_ms.get(k)}
                     for k in results[0]["serve"]["ms"]},
        "serve_bitwise_vs_phase12": True,
        "recall": final, "recall_sharded": want_sharded,
        "eval_runner_s": [[x["eval"]["runner_s"], x["eval"]["runner_sharded_s"]]
                          for x in results],
        "train": [{"path": path,
                   "median_step_ms": [x["train"][j]["median_step_ms"]
                                      for x in results],
                   "phase13_one_process_ms": phase13.get(path),
                   "bytes_sent_per_step": [x["train"][j]["bytes_sent_per_step"]
                                           for x in results],
                   "exchange_ms_per_step": [
                       x["train"][j]["exchange_ms_per_step"] for x in results],
                   "profile_rank0": results[0]["train"][j]["profile"],
                   "peak_mem_gb": [x["train"][j]["peak_mem_gb"]
                                   for x in results]}
                  for j, (path, *_) in enumerate(PROC_PATHS)],
        "runner": {"initial": rn[0]["initial"], "final": rn[0]["final"],
                   "phase13_final": mesh_final,
                   "phase13_other_order_final": {
                       str(k): v for k, v in other_order["final"].items()},
                   "other_order": f"shuffle_buffer_size={SHARD_ROWS}",
                   "reverse_recall": rn[0]["reverse_recall"],
                   "phase13_resumed_final": resumed,
                   "one_process_restore": {str(k): v for k, v in one.items()},
                   "runner_s": [x["runner_s"] for x in rn],
                   "eval_runner_s": [x["eval_runner_s"] for x in rn],
                   "exchange": [x["exchange"] for x in rn]},
        "launches": launches}})
    return launches


@contextlib.contextmanager
def checkpoint_times():
    """Inside the block, ms of each ``CheckpointManager`` host copy
    (``save``), background write and ``restore``, synchronised."""
    from hm_retrieval_tpu_torch.runners.checkpoint import CheckpointManager

    ms = {"copy": [], "write": [], "restore": []}
    fns = {"copy": CheckpointManager.save, "write": CheckpointManager._write,
           "restore": CheckpointManager.restore}

    def timed(kind):
        def run(self, *args, **kwargs):
            sync(self.device)
            t0 = time.perf_counter()
            out = fns[kind](self, *args, **kwargs)
            sync(self.device)
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    with swapped(CheckpointManager, save=timed("copy"), _write=timed("write"),
                 restore=timed("restore")):
        yield ms


def flatten_tree(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten_tree(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in flatten_tree(v)]
    return [tree]


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

    seconds = {}
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now

    card = phase_device()
    lap("1_device")
    stats = phase_kernels(gen, dev)
    lap("2_kernels")
    build_root = ROOT / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke-") as d:
        launches, shared = phase_serving(args.seed, args.repeats, dev, Path(d))
        lap("3_serving")
        stats.update(phase_quantized_kernels(gen, dev))
        lap("4_quantized_kernels")
        quantized, recalls = phase_quantized_serving(shared, args.repeats, dev,
                                                     Path(d))
        launches.update(quantized)
        lap("5_quantized_serving")
        rounds_stats = phase_rounds_kernels(gen, dev)
        # kernel 8's errors over phase 2's shapes and phase 6's
        k8, k8_phase2 = rounds_stats["bin_max_round"], stats["bin_max_round"]
        k8["max_abs_err"] = max(k8["max_abs_err"], k8_phase2["max_abs_err"])
        k8["id_mismatches"] += k8_phase2["id_mismatches"]
        stats.update(rounds_stats)
        launches["bin_max_round"] = phase_rounds_drivers(gen, dev)[
            "bin_max_round"]
        lap("6_rounds_kernels")
        rounds = phase_rounds_serving(shared, recalls, args.repeats, dev,
                                      Path(d))
        for name in ROUNDS_KERNELS:
            launches[name] = rounds[name]
        lap("7_rounds_serving")
    phase_widths(args.seed, dev)
    lap("8_widths")
    with tempfile.TemporaryDirectory(dir=build_root,
                                     prefix="chip_smoke-train-") as d:
        phase_training(args.seed, dev, Path(d))
    lap("9_training")
    with tempfile.TemporaryDirectory(dir=build_root,
                                     prefix="chip_smoke-runner-") as d:
        # phases 10 and 12's launches are added to each kernel's count
        runner_launches, ctx = phase_runner(args.seed, dev, Path(d))
        for name, n in runner_launches.items():
            launches[name] += n
        lap("10_runner")
        phase_baseline(ctx, dev)
        lap("11_baseline")
        for name, n in phase_sharded(ctx, args.repeats, dev, Path(d)).items():
            launches[name] += n
        lap("12_sharded")
        # phase 13: training over a mesh; (c)'s launches join the count
        mesh_rows = phase_mesh_training(args.seed, dev)
        for name, n in phase_mesh_runner(ctx, dev, Path(d)).items():
            launches[name] += n
        lap("13_mesh_training")
        # phase 14: two ranks on the card; both ranks' launches join
        for name, n in phase_processes(ctx, args.seed, args.repeats, dev,
                                       Path(d), mesh_rows).items():
            launches[name] += n
        lap("14_processes")
        del ctx
    emit({"phase_seconds": seconds})

    pallas = "hm_retrieval_tpu/ops/pallas_retrieval.py"
    kernel_files = {
        "bin_max2_first_round": ("bin_max2.cu", 276),
        "bin_max2_round": ("bin_max2.cu", 207),
        "bin_max2_scaled_single_pass": ("bin_max2.cu", 352),
        "bin_max2_scaled_fold_pass": ("bin_max2.cu", 464),
        "bin_max2_raw_fold_pass": ("bin_max2.cu", 593),
        "bin_max2_scaled_first_round": ("bin_max2.cu", 311),
        "bin_max2_scaled_round": ("bin_max2.cu", 701),
        "bin_max_round": ("bin_max2.cu", 158),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"hm_retrieval_tpu_torch/csrc/{kernel_files[name][0]}",
            "replaces": f"{pallas}:{kernel_files[name][1]}",
            "launches": launches[name],
            **st,  # max_abs_err, id_mismatches, ms, plain_ms, bound_ms, ...
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
