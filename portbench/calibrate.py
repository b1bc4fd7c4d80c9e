"""Readings that set a cell's limits: the numbers that decide ``correct``,
on many seeds, for the program (a short window at the cell's own load
and sizes) and for the controls and planted faults put in its place.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --sides program,control [--calls 6]

Sides of a retrieval cell: ``program``; ``control``, the reference's own
answers with the scoring operands in fp8 (e4m3), the precision below the
configuration's bf16; ``int8``, the program with its int8 index
(``QuantizedIndex``) in place of the configured one. Sides of a training
cell: ``program``; ``control``, the reference in TF32 (a card's matmul
setting; on the CPU it equals the reference); ``half_batch``, the
reference seeing half of each batch with the loss doubled. A state left
unchanged reads 1 on ``change_gap`` by construction and needs no run.
One JSON line a (side, seed) on standard output. Not run by the
benchmark's runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import compare
from portbench.registry import Registry
from portbench.window import Ctx, Recorder


def context(workload: str, seed: int, device, config_overrides=None,
            traffic_overrides=None) -> Ctx:
    reg = Registry()
    cell = reg.cell(workload)
    config = {**reg.config(cell["config"]), **(config_overrides or {})}
    traffic = {**reg.traffic(cell["traffic"]), **(traffic_overrides or {})}
    return Ctx(workload, cell, config, traffic, seed, torch.device(device),
               False)


def retrieval_side(ctx: Ctx, side: str, calls: int) -> dict:
    from portbench.kinds import retrieve_closed_loop as kind

    tr = ctx.traffic
    first = tr["warmup_calls"]
    if side == "control":
        from portbench import inputs

        w, catalog = kind.reference_side(ctx)
        operands = getattr(torch, ctx.config["score_operands"])
        batches = inputs.customer_batches(ctx.config["n_customers"],
                                          tr["batch"], ctx.seed)
        parts = []
        for i in range(first, first + calls):
            ids = batches[i % len(batches)]
            judge = kind.reference_scores(ctx, w, catalog, ids, operands)
            low = kind.reference_scores(ctx, w, catalog, ids,
                                        torch.float8_e4m3fn)
            top = low.topk(tr["k"], dim=1)
            parts.append(compare.retrieval_numbers(
                judge, top.indices + 1, top.values, tr["k"],
                ctx.config["n_articles"]))
            del judge, low
        return compare.merge_max(parts)
    if side == "int8":
        ctx.config = {**ctx.config, "index": {
            "class": "QuantizedIndex", "k": tr["k"], "method": "pallas"}}
    elif side != "program":
        raise ValueError(f"no side {side!r} of a retrieval cell")
    ctx.traffic = {**tr, "check_batches": calls}
    sut = kind.setup(ctx)
    rec = Recorder(ctx.device)
    for i in range(first, first + calls):
        kind.call(sut, i, rec)
    kept = kind.release(sut)
    del sut
    _free(ctx.device)
    return kind.check(ctx, kept, None)


def train_side(ctx: Ctx, side: str) -> dict:
    from portbench import inputs
    from portbench.kinds import train_steps as kind

    if side == "program":
        sut = kind.setup(ctx)
        kept = kind.release(sut)
        del sut
        _free(ctx.device)
        return kind.check(ctx, kept, None)
    tr = ctx.traffic
    pool = inputs.train_pool(ctx.config, tr,
                             inputs.article_probs(ctx.config, ctx.seed),
                             ctx.seed, ctx.device)
    batches = [{k: v[i] for k, v in pool.items()}
               for i in range(tr["checked_steps"])]
    if side not in ("control", "half_batch"):
        raise ValueError(f"no side {side!r} of a training cell")
    got = kind.reference_readings(ctx, batches, tf32=side == "control",
                                  half_batch=side == "half_batch")
    return compare.train_numbers(got, kind.reference_readings(ctx, batches))


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(workload: str, seed: int, side: str, calls: int, device,
             config_overrides=None, traffic_overrides=None) -> dict:
    ctx = context(workload, seed, device, config_overrides, traffic_overrides)
    if ctx.traffic["kind"] == "retrieve_closed_loop":
        return retrieval_side(ctx, side, calls)
    return train_side(ctx, side)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,control")
    ap.add_argument("--calls", type=int, default=6,
                    help="retrieval: checked calls a seed (a run keeps "
                         "check_batches)")
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for side in args.sides.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            nums = readings(args.workload, seed, side, args.calls, device)
            print(json.dumps({"workload": args.workload, "side": side,
                              "seed": seed, "numbers": nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
