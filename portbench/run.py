"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (everything up to the first timed call, warm-up and the checked
training steps included) is ``setup_s``. The window then runs the cell's
traffic for ``--seconds``; with ``--trace 1`` its first ``trace_seconds``
(from the traffic file) run under ``torch.profiler`` and the rest measures
the benchmark's host spans, and the line carries the cell's per-layer
metrics instead of its end-to-end ones. Once the window has closed and the
peak memory is read, the program's state is freed and the plain reference
judges what the window produced (``correct``). The last lines on standard
error, and the result's last key, give each compared number beside its
limit. A run without enough cards, or with JAX or the JAX package loaded,
prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
from pathlib import Path
from typing import List, Optional

from portbench.window import Ctx, process_age, stage

# Top-level module names no run may load: JAX, its libraries, the JAX
# package and the JAX package's benchmark scripts.
FORBIDDEN = ("jax", "jaxlib", "flax", "hm_retrieval_tpu", "bench",
             "benchmarks", "chip_smoke")


class NoCard(RuntimeError):
    """Fewer CUDA cards than the cell asks for."""


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``hm_retrieval_tpu_torch`` is not
    ``hm_retrieval_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def _device_info(ctx: Ctx, peak: int, trace) -> dict:
    import torch

    if ctx.device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(ctx.device),
                "count": int(ctx.cell["chips"]),
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    if ctx.traced and trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             device=None, config_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None,
             manifest: Optional[Path] = None) -> dict:
    """One run of ``workload``: the result object, with the compared
    numbers under ``checks``. ``device`` None takes the card and raises
    ``NoCard`` without enough of them; the overrides (tests, calibration)
    replace keys of the configuration and the traffic."""
    import torch

    stage("import torch")

    from portbench import compare
    from portbench.registry import Registry

    reg = Registry(manifest)
    cell = reg.cell(workload)
    config = {**reg.config(cell["config"]), **(config_overrides or {})}
    traffic = {**reg.traffic(cell["traffic"]), **(traffic_overrides or {})}
    limits = reg.limits(workload)
    kind = reg.kind(traffic["kind"])
    if device is None:
        need = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise NoCard(
                f"{workload} needs {need} CUDA card(s); "
                f"available: {torch.cuda.is_available()}, "
                f"count: {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    ctx = Ctx(workload, cell, config, traffic, seed, device, traced)
    stage("the card found")
    sut = kind.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age()
    stage("set-up done")
    win = kind.window(ctx, sut, seconds)
    stage("window closed")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    if traced:
        metrics = {}
        for m in reg.per_layer(workload):
            value = reg.reader(m["name"]).read(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **kind.end_to_end(ctx, win)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in reg.end_to_end(workload)}

    kept = kind.release(sut)
    del sut
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = kind.check(ctx, kept, win)
    correct = compare.judge(numbers, limits)
    result = {
        "correct": bool(correct),
        "attempted": win.calls,
        "failed": 0,
        "metrics": metrics,
        "device": _device_info(ctx, peak, win.trace),
    }
    if traced and win.trace is not None:
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = {name: {"value": _plain(numbers.get(name, math.nan)),
                               "limit": limit}
                        for name, limit in limits.items()}
    return result


def _plain(value: float):
    """A number as JSON holds it: a non-finite one as its name."""
    return value if math.isfinite(value) else str(value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
