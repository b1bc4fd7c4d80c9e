#!/usr/bin/env python3
"""Time the kernels of csrc/bin_max2.cu (the exact passes, kernels 1, 2, 8,
the int8 single passes, kernels 3-5, and the int8 rounds, kernels 6-7) and
of csrc/partial_reduce.cu (kernel 9) on one card: two trees side by side, or ablated builds of this tree's
bin_max2.cu. An earlier tree may keep some of them in other sources (its
own csrc/), which ``ab`` builds and times alike.

    python3 bin_max_bench.py ab --tree OLD --tree NEW [--seed 0]
        [--only partial_reduce] [--width 128|1024|2048]
    python3 bin_max_bench.py serve --tree OLD --tree NEW [--pairs 5]
    python3 bin_max_bench.py ablate [--seed 0] [--width 128|1024|2048]
    python3 bin_max_bench.py splits [--seed 0]

``ab`` times kernels 1-9, ``exact_topk``, ``quantized_topk`` (8 rounds
and one pass) and ``quantized_topk_global`` (with ``--only
partial_reduce``, kernel 9 alone) from each tree's own
``hm_retrieval_tpu_torch`` (for example a ``git archive`` of an earlier
commit unpacked under ``build/``), one process per tree in the order OLD,
NEW, NEW, OLD, so that a drift of the card or host shows as a difference
between the two readings of one tree. Every tree is timed by the same
functions (``chip_smoke.graph_ms``, ``chip_smoke.cuda_ms``) over the same
seeded inputs: the 105,542-row H&M-sized catalog, E=128, bf16, normal, and
as int8 codes with per-row scales. Each process saves every output it
timed, and ``ab`` then prints whether each is bit-identical across the two
trees (``bitwise``).

- kernel 9 (``partial_reduce``, csrc/partial_reduce.cu, called as the
  tree's own wrapper calls it: an earlier tree walks each bin unsplit) at
  every (n, L, r) of ``chip_smoke.partial_reduce_shapes()`` (phase 20's)
  and B = 1, 16, 128, 1024, on normal scores, timed alike, beside its bound
  (B*n*4 + B*L*8 bytes over 3.35 TB/s).
- kernel 1 (``bin_max2_first_round``) and kernel 2 (``bin_max2_round``, on
  the thresholds of its own round 1) at B = 1, 16, 128, L=2048; kernel 8
  (``bin_max_round`` on the thresholds of its own +inf round) at B=128,
  L = 2048 and 512. ``ms``: 50 launches replayed from one CUDA graph
  (device time); ``events_ms``: 50 back-to-back launches by CUDA events
  (the wrapper's host time where that is longer).
- kernel 6 (``bin_max2_scaled_first_round``) and kernel 7
  (``bin_max2_scaled_round``, on the thresholds of its own round 1) at
  B = 1, 16, 128, L=2048, over the 106,496 rows the rounds stream (a -inf
  bias on 1% of the valid rows), timed alike.
- kernels 3-5 at the served (fold F, bins L, batch B) of each single-pass
  plan (``chip_smoke.QUANT_PLANS``: (1, 2048, 1024), (2, 2048, 128),
  (8, 2048, 16), (8, 2048, 1), (16, 512, 16)): kernel 3
  (``bin_max2_scaled_single_pass``) at F = 1, kernel 4
  (``bin_max2_scaled_fold_pass``) at F > 1, over phase 4's per-row int8
  catalog (131,072 rows, a -inf bias on the pad rows), and kernel 5
  (``bin_max2_raw_fold_pass``) over its full chunks of real rows, timed
  alike.
- ``exact_topk`` at k=1000, ``quantized_topk`` at k=2000 with 8 rounds
  and with one pass (phase 4's per-row int8 catalog, 131,072 rows), and
  ``quantized_topk_global`` at k=2000, one pass over the same codes under
  one global scale (the raw pass over the full chunks of the 105,542 real
  rows, the tail by a plain product), B = 1, 16, 128, 1024: the median of
  10 calls, each timed by CUDA events (host syncs included, as served);
  then 5 calls under ``torch.profiler``: device ms a call of the bin-max
  kernels and of every other kernel, and the share of the profiled window
  in which the card ran no kernel (the profiler's own host cost
  included).

With ``--width`` past the whole-E instances (1024, 2048: bin_max2.cu's
K-sliced walks), ``ab`` times kernels 1-8 alone at ``wide_rows``' shapes,
PERF.md's sliced table: kernels 1-2 and 6-7 at B = 1, 16, 128, L = 2048
over the 106,496 rows a pass streams, kernel 8 at B = 128, kernels 3-5 at
the plans (1, 2048, 1024) and (2, 2048, 128), each beside ``matmul_ms``,
``torch.matmul`` of the same (B, E) x (E, rows) bf16 product alone (a
yardstick of the product, not a library version of the kernel), in the
same OLD, NEW, NEW, OLD order and with the same ``bitwise`` lines.

``serve`` runs ``chip_smoke.py``'s phase 3 (the exact index serving string
requests at full H&M width, B = 1, 16, 128, 1024, with its stage breakdown,
then the wide slice: the same model at joint width 1024 through the exact,
one-pass and 8-round indices, ``wide_serve`` lines) on each tree's package,
one process each, in ``--pairs`` pairs that alternate which tree runs
first.

``ablate`` builds this tree's ``bin_max2.cu`` as it is and with parts of
the kernel's walk replaced (the outputs of those builds are wrong; only
their time is read) and with the cluster size or the warp groups forced,
and times kernels 1-2 and the int8 rounds, kernels 6-7, at B = 1, 16, 128,
L=2048 (kernel 1 also at L = 1024 and 512 for the cluster sizes), and the
int8 single passes, kernels 3-5, at every served plan. The forced cluster
sizes and groups must give the as-is outputs bit for bit, kernels 3-7's
included (kernel 5 at F = 1, 2, 8 over the full chunks of real rows).
Variants:

- ``as_is``: the kernel as it is;
- ``no_cascade``: the top-2 cascade replaced by one max a cell (the fold
  tournament kept);
- ``no_mma``: each ``mma.sync`` removed, its operands still loaded;
- ``neither``: both;
- ``ring_only``: the ring's copies and barriers (and the int8 instances'
  conversion to bf16), nothing computed;
- ``no_convert``: the int8 instances' conversion of each landed tile to
  bf16 and its barrier removed (the mma reads a stale tile);
- ``no_epilogue``: the per-row int8 instances' ``sum * scale + bias``
  removed (the raw instance has none);
- ``no_tournament``: the fold pass's tournament removed (each chunk's last
  sub-tile goes to the cascade);
- ``c1`` .. ``c8``: the cluster size forced to 1, 2, 4, 8;
- ``g1``, ``g2``: at most 1 or 2 warp groups a block;
- ``no_barrier``: the ring's group barrier after each landed step removed
  (the walk races its own ring; its time only);
- ``no_copies``: the K-sliced walks' slice copies removed (the mma reads
  whatever the ring holds): the walk's compute alone.

With ``--width`` 1024 or 2048, ``ablate`` builds ``WIDE_VARIANTS``
(``as_is``, ``no_cascade``, ``no_mma``, ``neither``, ``ring_only`` and
``no_convert`` reaching the K-sliced walks too, ``no_barrier``,
``no_copies``, ``g1``, ``g2``) and times kernels 1-2 and 6-7 at B = 1,
16, 128 at ``wide_rows``' shapes; the forced builds (``g1``, ``g2``) must
answer as the as-is one, bit for bit.

``splits`` times this tree's kernel 9 at every split it takes, at every
shape of phase 20, beside ``split_plan``'s choice (``split_sweep``).

Each line printed is one JSON object; needs a card, exits 2 without one.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (torch and numpy only at import)

TIMED = (1, 16, 128)
TOPK_BATCHES = (1, 16, 128, 1024)
K = 1000
L8 = 2048  # the int8 rounds' bins at k = 2000
GLOBAL_SCALE = 0.02  # quantized_topk_global's one scale


def emit(obj):
    print(json.dumps(obj), flush=True)


def catalog(gen, dev, L):
    n_pad = -(-cs.N_ARTICLES // L) * L
    c_pad = torch.zeros(n_pad, cs.E, dtype=torch.bfloat16, device=dev)
    c_pad[: cs.N_ARTICLES] = cs.random_rows(gen, dev, "normal", cs.N_ARTICLES)
    return c_pad


def time_launch(launch):
    return {"ms": cs.graph_ms(launch, 50), "events_ms": cs.cuda_ms(launch, 50)}


def kernel_rows(bt, gen, dev, batches=TIMED, bins=(2048,), kernels=(1, 2)):
    """Timings of kernels 1-2 (and 8) at each (L, B), with their bounds,
    each with the outputs of one launch."""
    N = cs.N_ARTICLES
    for L in bins:
        c_pad = catalog(gen, dev, L)
        q_all = cs.random_rows(gen, dev, "normal", cs.Q_BLOCK)
        for B in batches:
            q = q_all[:B]
            first = bt.bin_max2_first_round(q, c_pad, L, N)
            runs = {
                1: (lambda: bt.bin_max2_first_round(q, c_pad, L, N), False, 4),
                2: (lambda: bt.bin_max2_round(q, c_pad, first[2], first[3],
                                              L, N), True, 4),
            }
            if 8 in kernels:
                inf_s = torch.full((B, L), float("inf"), device=dev)
                inf_i = torch.full((B, L), -1, dtype=torch.int32, device=dev)
                top1 = bt.bin_max_round(q, c_pad, inf_s, inf_i, L, N)
                runs[8] = (lambda: bt.bin_max_round(q, c_pad, *top1, L, N),
                           True, 2)
            for kernel in kernels:
                launch, thr, outputs = runs[kernel]
                bound, by = cs.pass_bound_ms(B, c_pad.shape[0], L, thr,
                                             outputs=outputs)
                yield {"kernel": kernel, "L": L, "B": B, **time_launch(launch),
                       "bound_ms": bound, "bound_by": by}, launch()


def int8_rows(qt, gen, dev, batches=TIMED):
    """Timings of kernels 6-7 at L8 and each B, with their bounds, each with
    the outputs of one launch."""
    N = cs.N_ARTICLES
    n_rows = -(-N // L8) * L8
    codes, scales, bias = cs.scaled_catalog(gen, dev, n_rows, cs.E, N)
    q_all = cs.random_rows(gen, dev, "normal", cs.Q_BLOCK)
    for B in batches:
        q = q_all[:B]
        first = qt.bin_max2_scaled_first_round(q, codes, scales, bias, L8, N)
        runs = {
            6: (lambda: qt.bin_max2_scaled_first_round(
                q, codes, scales, bias, L8, N), False),
            7: (lambda: qt.bin_max2_scaled_round(
                q, codes, scales, bias, first[2], first[3], L8, N), True),
        }
        for kernel, (launch, thr) in runs.items():
            bound, by = cs.single_pass_bound_ms(B, n_rows, L8, True, thr)
            yield {"kernel": kernel, "L": L8, "B": B, **time_launch(launch),
                   "bound_ms": bound, "bound_by": by}, launch()


def single_pass_rows(qt, gen, dev, plans=cs.QUANT_PLANS, kernels=(3, 4, 5)):
    """Timings of kernels 3-5 at each served (F, L, B), with their bounds,
    each with the outputs of one launch: kernel 3 at F = 1, kernel 4 at
    F > 1, kernel 5 over the full chunks of real rows at every plan."""
    number = dict(zip(cs.SINGLE_PASS_KERNELS, (3, 4, 5)))
    codes, scales, bias = cs.int8_catalog(gen, dev)
    for F, L, B in plans:
        q = cs.random_rows(gen, dev, "normal", B)
        for name, (c, args) in cs.plan_cases(codes, scales, bias, F,
                                             L).items():
            if number[name] not in kernels:
                continue
            bound, by = cs.single_pass_bound_ms(
                B, c.shape[0], L, name != cs.SINGLE_PASS_KERNELS[2])

            def launch():
                return getattr(qt, name)(q, c, *args)

            yield {"kernel": number[name], "F": F, "L": L, "B": B,
                   "rows": c.shape[0], **time_launch(launch),
                   "bound_ms": bound, "bound_by": by}, launch()


def wide_rows(bt, qt, gen, dev, width, kernels=(1, 2, 3, 4, 5, 6, 7, 8),
              batches=TIMED):
    """Timings of kernels 1-8 at E = ``width`` (past the whole-E instances:
    bin_max2.cu's K-sliced walks) at the sliced shapes of PERF.md, each
    with the outputs of one launch: kernels 1-2 and 6-7 at L = 2048 over the
    106,496 rows a pass streams at B = ``batches`` (kernels 2 and 7 on
    their own round 1's thresholds), kernel 8 at B = 128 on its own +inf
    round's, kernels 3-5 at the plans (1, 2048, 1024) and (2, 2048, 128)
    over the 131,072 padded rows (kernel 5 over the full chunks of real
    rows). Beside each row, ``matmul_ms``: ``torch.matmul`` of the same
    (B, E) x (E, rows) bf16 product alone, graph-replayed: a yardstick of
    the product, not a library version of the kernel (no PyTorch call
    computes a bin-max pass)."""
    L, N, n_pad = 2048, cs.N_ARTICLES, cs.N_PAD_EXACT

    def normal(n):
        return torch.randn(n, width, generator=gen,
                           device=dev).to(torch.bfloat16)

    def matmul_ms(q, c):
        return cs.graph_ms(lambda: torch.matmul(q, c.T), 50)

    def row(kernel, launch, bound, B, q, c, **shape):
        return {"kernel": kernel, "E": width, "L": L, "B": B, **shape,
                **time_launch(launch), "bound_ms": bound[0],
                "bound_by": bound[1], "matmul_ms": matmul_ms(q, c)}, launch()

    if {1, 2, 8} & set(kernels):
        c_pad = torch.zeros(n_pad, width, dtype=torch.bfloat16, device=dev)
        c_pad[:N] = normal(N)
        q_all = normal(cs.Q_BLOCK)
        for B in batches:
            q = q_all[:B]
            first = bt.bin_max2_first_round(q, c_pad, L, N)
            runs = {
                1: (lambda: bt.bin_max2_first_round(q, c_pad, L, N), (), 4),
                2: (lambda: bt.bin_max2_round(q, c_pad, *first[2:], L, N),
                    first[2:], 4),
            }
            if B == cs.Q_BLOCK:
                inf_s = torch.full((B, L), float("inf"), device=dev)
                inf_i = torch.full((B, L), -1, dtype=torch.int32, device=dev)
                top1 = bt.bin_max_round(q, c_pad, inf_s, inf_i, L, N)
                runs[8] = (lambda: bt.bin_max_round(q, c_pad, *top1, L, N),
                           top1, 2)
            for kernel, (launch, thr, outputs) in runs.items():
                if kernel in kernels:
                    yield row(kernel, launch, cs.pass_bound_ms(
                        B, n_pad, L, bool(thr), outputs, width), B, q, c_pad,
                        rows=n_pad)
        del c_pad
    if {6, 7} & set(kernels):
        codes, scales, bias = cs.scaled_catalog(gen, dev, n_pad, width, N)
        cb = codes.to(torch.bfloat16)
        q_all = normal(cs.Q_BLOCK)
        for B in batches:
            q = q_all[:B]
            first = qt.bin_max2_scaled_first_round(q, codes, scales, bias, L,
                                                   N)
            for kernel, thr in ((6, ()), (7, first[2:])):
                name = cs.ROUNDS_KERNELS[kernel - 6]
                if kernel in kernels:
                    yield row(kernel, lambda: getattr(qt, name)(
                        q, codes, scales, bias, *thr, L, N),
                        cs.single_pass_bound_ms(B, n_pad, L, True, bool(thr),
                                                width=width), B, q, cb,
                        rows=n_pad)
        del codes, cb
    if {3, 4, 5} & set(kernels):
        number = dict(zip(cs.SINGLE_PASS_KERNELS, (3, 4, 5)))
        codes = torch.zeros((cs.N_PAD_Q, width), dtype=torch.int8,
                            device=dev)
        codes[:N] = torch.randint(-127, 128, (N, width), generator=gen,
                                  device=dev, dtype=torch.int8)
        scales = torch.rand(cs.N_PAD_Q, generator=gen, device=dev) * 0.05 + 1e-3
        bias = torch.zeros(cs.N_PAD_Q, device=dev)
        bias[N:] = float("-inf")
        cb = codes.to(torch.bfloat16)
        for F, L_, B in ((1, 2048, 1024), (2, 2048, 128)):
            q = normal(B)
            for name, (c, args) in cs.plan_cases(codes, scales, bias, F,
                                                 L_).items():
                if number[name] not in kernels:
                    continue
                yield row(number[name],
                          lambda: cs.run_pass(name, q, c, args),
                          cs.single_pass_bound_ms(
                              B, c.shape[0], L_,
                              name != cs.SINGLE_PASS_KERNELS[2], width=width),
                          B, q, cb[:c.shape[0]], F=F, rows=c.shape[0])
        del codes, cb


def partial_reduce_rows(pr, gen, dev):
    """Timings of kernel 9 (``partial_reduce``, at the tree's own split) at
    every (n, L, r) of ``chip_smoke.partial_reduce_shapes()`` and B of
    ``chip_smoke.SERVE_BATCHES``, on normal scores, with their bounds, each
    with the outputs of one launch."""
    for site, n, k, L, r in cs.partial_reduce_shapes():
        for B in cs.SERVE_BATCHES:
            x = torch.randn(B, n, generator=gen, device=dev)

            def launch():
                return pr.partial_reduce(x, L, r)

            bound, by = cs.roofline_ms(B * n * 4 + B * L * 8, 0)
            yield {"kernel": 9, "site": site, "n": n, "k": k, "L": L, "r": r,
                   "B": B, **time_launch(launch), "bound_ms": bound,
                   "bound_by": by}, launch()


def split_sweep(seed):
    """Kernel 9 of this tree at every split it takes (1, 2, 4, ...,
    min(2^r, 32)) at every shape of phase 20 and B = 1, 16, 128, 1024, on
    normal scores: graph ms of each beside ``split_plan``'s choice, every
    split's outputs bit for bit equal to the unsplit walk's."""
    _, _, pr = import_tree(ROOT)
    from hm_retrieval_tpu_torch.ops import _build

    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for site, n, k, L, r in cs.partial_reduce_shapes():
        for B in cs.SERVE_BATCHES:
            x = torch.randn(B, n, generator=gen, device=dev)
            one = pr.partial_reduce(x, L, r, split=1)
            ms, same = {}, True
            for e in range(min(r, 5) + 1):
                got = pr.partial_reduce(x, L, r, split=1 << e)
                same &= cs.same_bits(got, one)
                ms[1 << e] = cs.graph_ms(
                    lambda e=e: pr.partial_reduce(x, L, r, split=1 << e), 50)
            bound, by = cs.roofline_ms(B * n * 4 + B * L * 8, 0)
            emit({"split_sweep": {
                "site": site, "n": n, "k": k, "L": L, "r": r, "B": B,
                "plan": pr.split_plan(B, L, r, sms),
                "fastest": min(ms, key=ms.get), "ms": ms,
                "bound_ms": bound, "bound_by": by,
                "bitwise_equal_to_unsplit": bool(same)}})
            if not same:
                raise SystemExit(f"kernel 9 at n={n} L={L} r={r} B={B}: a "
                                 "split answers otherwise")


def import_tree(tree):
    """(``bin_topk``, ``quantized_topk``, ``partial_reduce``) of the
    hm_retrieval_tpu_torch under ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import partial_reduce as pr
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    for module in (bt, qt, pr):
        where = Path(module.__file__).resolve()
        if Path(tree).resolve() not in where.parents:
            raise RuntimeError(f"imported {where}, not the tree {tree}")
    return bt, qt, pr


def timed_calls(fn, calls=10):
    """Per-call ms of ``calls`` calls after a warm-up, each by CUDA events
    (host syncs included), and the last call's outputs."""
    fn()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def time_tree(tree, seed, out, only=None, width=cs.E):
    """Kernels, exact_topk and quantized_topk of the hm_retrieval_tpu_torch
    under ``tree`` (with ``only="partial_reduce"``, kernel 9 alone; at a
    ``width`` other than 128, kernels 1-8 alone at ``wide_rows``' shapes);
    every output timed is saved to ``out``."""
    bt, qt, pr = import_tree(tree)
    from hm_retrieval_tpu_torch.ops import _build

    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    saved = {}

    def keep(key, outs):
        saved[key] = [t.cpu() if torch.is_tensor(t) else t for t in outs]

    if width != cs.E:
        for row, outs in wide_rows(bt, qt, gen, dev, width):
            emit({"tree": tree, **row})
            fold = f" F={row['F']}" if "F" in row else ""
            keep(f"kernel {row['kernel']}{fold} E={width} L={row['L']} "
                 f"B={row['B']}", outs)
        torch.save(saved, out)
        return
    for row, outs in partial_reduce_rows(pr, gen, dev):
        emit({"tree": tree, **row})
        keep(f"kernel 9 n={row['n']} L={row['L']} r={row['r']} "
             f"B={row['B']}", outs)
    if only == "partial_reduce":
        torch.save(saved, out)
        return
    rows = [*kernel_rows(bt, gen, dev, kernels=(1, 2)),
            *kernel_rows(bt, gen, dev, batches=(cs.Q_BLOCK,),
                         bins=(2048, 512), kernels=(8,)),
            *int8_rows(qt, gen, dev), *single_pass_rows(qt, gen, dev)]
    for row, outs in rows:
        emit({"tree": tree, **row})
        fold = f" F={row['F']}" if "F" in row else ""
        keep(f"kernel {row['kernel']}{fold} L={row['L']} B={row['B']}", outs)
    cand = cs.random_rows(gen, dev, "normal", cs.N_ARTICLES)
    codes, scales, _ = cs.int8_catalog(gen, dev)
    drivers = {
        "exact_topk": (K, lambda q: bt.exact_topk(q, cand, K)),
        "quantized_topk": (cs.SURVIVORS, lambda q: qt.quantized_topk(
            q, codes, scales, cs.SURVIVORS, n_valid=cs.N_ARTICLES,
            max_rounds=cs.MAX_ROUNDS)),
        "quantized_topk_one_pass": (cs.SURVIVORS, lambda q: qt.quantized_topk(
            q, codes, scales, cs.SURVIVORS, n_valid=cs.N_ARTICLES,
            max_rounds=1)),
        "quantized_topk_global": (cs.SURVIVORS, lambda q: (
            qt.quantized_topk_global(q, codes, GLOBAL_SCALE, cs.SURVIVORS,
                                     n_valid=cs.N_ARTICLES))),
    }
    for name, (k, driver) in drivers.items():
        for B in TOPK_BATCHES:
            q = cs.random_rows(gen, dev, "normal", B)
            times, outs = timed_calls(lambda: driver(q))
            keep(f"{name} B={B}", outs)
            emit({"tree": tree, name: {
                "B": B, "k": k, "rounds": outs[2],
                "median_ms": statistics.median(times), "ms": times}})
            emit({"tree": tree, "profile": {
                "driver": name, "B": B, **profile_calls(lambda: driver(q))}})
    torch.save(saved, out)


def profile_calls(fn, calls=5):
    """Device time a call of ``fn``'s kernels by torch.profiler: the bin-max
    kernels' (bin_max2.cu's template, and the kernels an earlier tree kept
    in other sources, by their names) and the others', and the share of the
    profiled window in which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {"bin_max": 0.0, "other": 0.0}
    for e in spans:
        key = ("bin_max" if any(k in e.name for k in (
            "bin_max_kernel", "int8_pass_kernel", "raw_fold_kernel"))
            else "other")
        busy[key] += e.time_range.elapsed_us() / 1e3
    return {
        "calls": calls, "device_events": len(spans),
        "wall_ms": wall_ms / calls,
        "device_ms": {key: ms / calls for key, ms in busy.items()},
        "idle_share": 1 - sum(busy.values()) / wall_ms if spans else None,
    }


def serve_tree(tree, seed):
    """chip_smoke.py's phase 3, the wide slice included, on the
    hm_retrieval_tpu_torch under ``tree``."""
    import_tree(tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="bench-") as d:
        dev = torch.device("cuda", 0)
        _, shared = cs.phase_serving(seed, 5, dev, Path(d))
        cs.serve_wide(seed, 5, dev, shared)


def alternate(mode, trees, seed, pairs, only=None, width=cs.E):
    """``mode`` on each tree in a process of its own, ``pairs`` pairs,
    alternating which tree runs first: OLD, NEW, NEW, OLD, ... Returns the
    (tree, output file) of each run."""
    out_dir = ROOT / "build" / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for pair in range(pairs):
        for tree in trees if pair % 2 == 0 else trees[::-1]:
            emit({"run": mode, "tree": tree, "pair": pair})
            out = out_dir / f"{mode}-{pair}-{len(runs)}.pt"
            proc = subprocess.run(
                [sys.executable, __file__, mode, "--tree", tree, "--seed",
                 str(seed), "--out", str(out), "--width", str(width)]
                + (["--only", only] if only else []), capture_output=True,
                text=True, timeout=900,
            )
            sys.stdout.write(proc.stdout)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr)
                raise SystemExit(f"{mode} of {tree} failed ({proc.returncode})")
            runs.append((tree, out))
    return runs


def same(a, b):
    """Bitwise equality of two saved outputs (tensors and plain values)."""
    return len(a) == len(b) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(a, b))


def compare_runs(runs):
    """Whether every saved output is bit-identical across all runs, both
    trees: one line per output, then a summary."""
    saved = [(tree, torch.load(out)) for tree, out in runs]
    first = saved[0][1]
    verdict = {}
    for key in first:
        verdict[key] = all(same(first[key], s[key]) for _, s in saved[1:])
        emit({"bitwise": {"output": key, "identical": verdict[key]}})
    emit({"bitwise_all": all(verdict.values()), "runs": len(saved)})


# ---------------------------------------------------------------------------
# Ablation: this tree's kernel source with one part replaced
# ---------------------------------------------------------------------------

# Each patched text is in the source once: the cascade, tournament and
# epilogue in the kernel's `finish`, the conversion in its `land` (both
# shared by the whole-E and sliced walks), the walk's compute in the
# whole-E walk (the E = 128 kernels timed here).
CASCADE = """    } else if (u * L + bin0 + BN <= n_valid) {
      cascade(acc, [u](int, int, int) { return u; }, std::false_type());
    } else {
      cascade(acc, [u](int, int, int) { return u; }, std::true_type());
    }
"""
FOLD_CASCADE = """      if (fslot == F - 1)
        cascade(fs, [&](int mm, int jj, int e) { return fu[mm][jj][e]; },
                std::false_type());
"""


def one_max(scores):
    """One max a cell of ``scores`` in place of the cascade."""
    return f"""#pragma unroll
      for (int mm = 0; mm < WM; ++mm)
#pragma unroll
        for (int jj = 0; jj < WN; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            m1[mm][jj][e] = fmaxf(m1[mm][jj][e], {scores}[mm][jj][e]);
"""


NO_CASCADE = [(CASCADE, "    } else {\n" + one_max("acc") + "    }\n"),
              (FOLD_CASCADE, "      if (fslot == F - 1) {\n"
               + one_max("fs") + "      }\n")]
TOURNAMENT = "      tournament(acc, u, fslot == 0);\n" + FOLD_CASCADE
NO_TOURNAMENT = """      if (fslot == F - 1)
        cascade(acc, [u](int, int, int) { return u; }, std::false_type());
"""
MMA = """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
"""
# no instruction: the operands stay loaded and the accumulators opaque
NO_MMA = """  asm volatile(""
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
"""
WALK = "      if (active) {\n        float acc[WM][WN][4];"
NO_WALK = "      if (active && steps < 0) {\n        float acc[WM][WN][4];"
SLICED_WALK = "      if (active) {\n        if (s == 0) {"
NO_SLICED_WALK = "      if (active && steps < 0) {\n        if (s == 0) {"
PICK = "  err = pick_cluster(kernel, s, tiles_of(B, L, s), &cluster);\n"
CONVERT = """      codes_to_bf16(sc + slot * stage, sconv, Ek, ld, gtid, gthreads);
      group_sync(1 + grp, gthreads);
"""
SLICE_COPY = "      if (i < steps * nsl) {\n"
BARRIER = """    group_sync(1 + grp, gthreads);  // ... for the group; slot i-1 is free
"""
EPILOGUE = "    if constexpr (kCat == Catalog::kScaled) scaled(acc, landed);\n"
GROUPS = "  for (s.groups = MAX_WARPS / s.wpg;; --s.groups) {\n"

VARIANTS = {
    "as_is": [],
    "no_cascade": NO_CASCADE,
    "no_mma": [(MMA, NO_MMA)],
    "neither": [*NO_CASCADE, (MMA, NO_MMA)],
    "ring_only": [(WALK, NO_WALK), (SLICED_WALK, NO_SLICED_WALK)],
    "no_convert": [(CONVERT, "")],
    "no_epilogue": [(EPILOGUE, "")],
    "no_tournament": [(TOURNAMENT, NO_TOURNAMENT)],
    **{f"c{c}": [(PICK, f"  cluster = {c};\n")] for c in (1, 2, 4, 8)},
    "no_barrier": [(BARRIER, "")],
    "no_copies": [(SLICE_COPY, "      if (i < steps * nsl && steps < 0) {\n")],
    **{f"g{g}": [(GROUPS, f"  for (s.groups = {g} < MAX_WARPS / s.wpg ? {g} "
                  ": MAX_WARPS / s.wpg;; --s.groups) {\n")] for g in (1, 2)},
}
FORCED = ("c1", "c2", "c4", "c8", "g1", "g2")
# the variants ``ablate --width`` times on the K-sliced walks; the forced
# ones among them must answer as the as-is build
WIDE_VARIANTS = ("as_is", "no_cascade", "no_mma", "neither", "ring_only",
                 "no_convert", "no_barrier", "no_copies", "g1", "g2")
WIDE_FORCED = ("g1", "g2")


def build_variants(names):
    """One nvcc per variant, all at once; returns {name: (lib, ptxas)}."""
    from hm_retrieval_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / "bin_max2.cu").read_text()
    out_dir = _build.BUILD_DIR / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patched text is not in the "
                                   "source once")
            text = text.replace(old, new)
        cu = out_dir / f"bin_max2_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libbin_max2_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        built[name] = (ctypes.CDLL(str(lib)), regs)
    return built


def use(lib, *modules):
    """Point the kernel wrappers of ``modules`` at the kernels of ``lib``."""
    for module in modules:
        def kernel(name, module=module):
            fn = getattr(lib, name)
            if fn.argtypes is None:
                fn.argtypes = module._ARGTYPES[name]
                fn.restype = ctypes.c_int
            return fn

        module._kernel = kernel


def ablate_wide(seed, width):
    """``WIDE_VARIANTS`` of this tree's bin_max2.cu on the K-sliced walk at
    E = ``width``: kernels 1-2 and 6-7 at B = 1, 16, 128, L = 2048 over the
    106,496 rows a pass streams (``wide_rows``). The forced groups must
    answer as the as-is build, bit for bit."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    built = build_variants(list(WIDE_VARIANTS))
    for name, (_, regs) in built.items():
        emit({"variant": name, "E": width, "ptxas": regs})
    dev = torch.device("cuda")
    want = None
    for name in WIDE_VARIANTS:
        use(built[name][0], bt, qt)
        outs = []
        for row, out in wide_rows(
                bt, qt, torch.Generator(device=dev).manual_seed(seed), dev,
                width, kernels=(1, 2, 6, 7)):
            emit({"variant": name, **row})
            outs += [x.cpu() for x in out]
        if name == "as_is":
            want = outs
        elif name in WIDE_FORCED:
            same_outs = all(torch.equal(g, w) for g, w in zip(outs, want))
            emit({"forced_check": {"variant": name, "E": width,
                                   "bitwise_equal": same_outs}})
            if not same_outs:
                raise RuntimeError(f"{name} E={width}: outputs differ from "
                                   "the as-is build")


def ablate(seed, width=cs.E):
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    if width != cs.E:
        ablate_wide(seed, width)
        return
    built = build_variants(list(VARIANTS))
    for name, (_, regs) in built.items():
        emit({"variant": name, "ptxas": regs})
    dev = torch.device("cuda")
    # the forced cluster sizes and groups must answer as the as-is build
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = cs.random_rows(gen, dev, "normal", 1024)
    N = cs.N_ARTICLES
    codes_q, scales_q, bias_q = cs.int8_catalog(gen, dev)
    for L in (2048, 1024, 512):
        c_pad = catalog(gen, dev, L)
        n8 = -(-N // L) * L
        codes, scales, bias = cs.scaled_catalog(gen, dev, n8, cs.E, N)
        want = {}
        for name in ("as_is", *FORCED):
            use(built[name][0], bt, qt)
            for B in (1, 37, 128, 1024):
                k3 = qt.bin_max2_scaled_single_pass(q[:B], codes_q, scales_q,
                                                    bias_q, L)
                k4 = [x for F in (2, 8) for x in qt.bin_max2_scaled_fold_pass(
                    q[:B], codes_q, scales_q, bias_q, L, F)]
                k5 = [x for F in (1, 2, 8) for x in qt.bin_max2_raw_fold_pass(
                    q[:B], codes_q[:N // (F * L) * F * L], L, F)]
                got = [x.clone() for x in (*k3, *k4, *k5)]
                if B <= cs.Q_BLOCK:
                    k1 = bt.bin_max2_first_round(q[:B], c_pad, L, N)
                    k2 = bt.bin_max2_round(q[:B], c_pad, k1[2], k1[3], L, N)
                    k6 = qt.bin_max2_scaled_first_round(q[:B], codes, scales,
                                                        bias, L, N)
                    k7 = qt.bin_max2_scaled_round(q[:B], codes, scales, bias,
                                                  k6[2], k6[3], L, N)
                    got += [x.clone() for x in k1 + k2 + k6 + k7]
                if name == "as_is":
                    want[B] = got
                elif not all(torch.equal(g, w) for g, w in zip(got, want[B])):
                    raise RuntimeError(f"{name} L={L} B={B}: outputs differ "
                                       "from the as-is build")
        emit({"cluster_check": {"L": L, "ok": True}})
    for name in VARIANTS:
        use(built[name][0], bt, qt)
        forced = name in FORCED
        rows = kernel_rows(
            bt, torch.Generator(device=dev).manual_seed(seed), dev,
            batches=(1, 128) if forced else TIMED,
            bins=(2048, 1024, 512) if forced else (2048,),
            kernels=(1,) if forced else (1, 2))
        if not forced:
            rows = [*rows, *int8_rows(
                qt, torch.Generator(device=dev).manual_seed(seed), dev)]
        rows = [*rows, *single_pass_rows(
            qt, torch.Generator(device=dev).manual_seed(seed), dev)]
        for row, _ in rows:
            emit({"variant": name, **row})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("ab", "serve", "ablate", "splits",
                                     "time", "serve-one"))
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", help="time: where to save the outputs timed")
    ap.add_argument("--only", choices=("partial_reduce",),
                    help="ab / time: kernel 9 alone")
    ap.add_argument("--width", type=int, default=cs.E,
                    help="ab / time / ablate: the padded E; 128 (the "
                    "whole-E instances), or a sliced width such as 1024 "
                    "or 2048")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bin_max_bench: CUDA is not available", file=sys.stderr)
        return 2
    if args.mode in ("ab", "serve"):
        if len(args.tree) != 2:
            ap.error(f"{args.mode} takes two --tree")
        if args.mode == "ab":
            compare_runs(alternate("time", args.tree, args.seed, 2,
                                   args.only, args.width))
        else:
            alternate("serve-one", args.tree, args.seed, args.pairs)
    elif args.mode == "time":
        time_tree(args.tree[0], args.seed, args.out, args.only,
                  args.width)
    elif args.mode == "serve-one":
        serve_tree(args.tree[0], args.seed)
    elif args.mode == "splits":
        split_sweep(args.seed)
    else:
        ablate(args.seed, args.width)
    return 0


if __name__ == "__main__":
    sys.exit(main())
