"""The readers of the program's counters (``utils/tracing.py``) on
hand-built windows, a tiny traced run that reports them, the untraced run
that never turns the program's spans on, and, on a card, the program's
spans on the clock of the profiler's device intervals."""

import sys
import time

import pytest
import torch

from hm_retrieval_tpu_torch.utils import tracing
from portbench import run
from portbench.registry import Registry
from portbench.tests.sizes import overrides
from portbench.trace import Trace
from portbench.window import Ctx, Window

REG = Registry()
RETRIEVE = "hm_e128.retrieve_b1024"
CELLS = [c["name"] for c in REG.manifest["workloads"]]
SEED = 2**31 + 54321


@pytest.fixture
def counts(monkeypatch):
    """The program's counters, emptied for the test and put back after."""
    monkeypatch.setattr(tracing, "COUNTS", {})
    return tracing.COUNTS


def _window(calls=40, traced_calls=10, warmup=3):
    ctx = Ctx(RETRIEVE, REG.cell(RETRIEVE), {}, {"warmup_calls": warmup},
              0, torch.device("cpu"), True)
    return Window(calls=calls, seconds=1.0, ctx=ctx,
                  trace=Trace(window_s=0.5, calls=traced_calls))


def test_rounds_per_block_reads_rounds_over_blocks(counts):
    read = REG.reader("rounds_per_block.retrieve").read
    assert read(_window()) is None  # no block ran
    counts.update({"topk_rounds.blocks": 8, "topk_rounds.rounds": 30})
    assert read(_window()) == pytest.approx(3.75)


def test_host_syncs_per_batch_counts_every_call_of_the_run(counts):
    read = REG.reader("host_syncs_per_batch.retrieve").read
    assert read(_window()) is None
    counts["topk_rounds.host_syncs"] = 2650
    # 3 warm-up calls, 10 traced and 40 measured: 53 batches
    assert read(_window()) == pytest.approx(50.0)
    untraced = _window()
    untraced.trace = None
    assert read(untraced) == pytest.approx(2650 / 43)


@pytest.mark.parametrize("metric", ["rounds_per_block.retrieve",
                                    "host_syncs_per_batch.retrieve"])
def test_a_program_without_the_counters_reads_nothing(monkeypatch, metric):
    # a program from before the counters: no such module to import
    monkeypatch.setitem(sys.modules, "hm_retrieval_tpu_torch.utils.tracing",
                        None)
    assert REG.reader(metric).read(_window()) is None


def test_tiny_traced_retrieval_reports_the_counters():
    cfg, tr = overrides(RETRIEVE)
    tracing.reset_counts()
    res = run.run_cell(RETRIEVE, SEED, 1.0, True, device="cpu",
                       config_overrides=cfg, traffic_overrides=tr)
    assert res["correct"] is True
    m = res["metrics"]
    rounds = m["rounds_per_block.retrieve"]["value"]
    syncs = m["host_syncs_per_batch.retrieve"]["value"]
    assert m["rounds_per_block.retrieve"]["unit"] == "rounds"
    # a batch of 64 rows is one block: 1 + one or two reads a later round
    assert 1 <= rounds <= syncs <= 2 * rounds - 1


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_never_turns_spans_on(monkeypatch, cell):
    opened = []
    real = tracing.collect

    def watched():
        opened.append(cell)
        return real()

    monkeypatch.setattr(tracing, "collect", watched)
    monkeypatch.setattr(tracing, "_Timed", None)  # any recorded span raises
    tracing.reset_counts()
    cfg, tr = overrides(cell)
    res = run.run_cell(cell, SEED, 0.5, False, device="cpu",
                       config_overrides=cfg, traffic_overrides=tr)
    assert res["correct"] is True
    assert opened == [] and tracing._records is None
    if "retrieve" in cell:  # the exact top-k ran and counted
        assert tracing.COUNTS["topk_rounds.blocks"] > 0


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler's device intervals")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_program_spans_share_the_profilers_clock(gpu):
    """A program span around a ~5-ms sleep kernel and a synchronize holds
    the kernel's profiler interval, within 0.2 ms at each end."""
    from portbench import trace as tr

    torch.cuda._sleep(1_000_000)
    torch.cuda.synchronize(gpu)
    with tr.profiled(gpu) as prof:
        w0 = time.time_ns()
        torch.cuda._sleep(1_000_000)  # the profiler's first launch
        torch.cuda.synchronize(gpu)
        with tracing.collect() as spans:
            with tracing.span("sleep"):
                torch.cuda._sleep(10_000_000)
                torch.cuda.synchronize(gpu)
        w1 = time.time_ns()
    trace = tr.read_trace(prof, 1, w0, w1, [])
    (_, k0, kd) = max(trace.kernels, key=lambda op: op[2])
    (s,) = spans
    s0, s1 = (s.start_ns - w0) * 1e-9, (s.end_ns - w0) * 1e-9
    assert kd > 2e-3, trace.kernels
    assert 0 <= k0 - s0 <= 2e-4, (s0, k0)
    assert 0 <= s1 - (k0 + kd) <= 2e-4, (s1, k0 + kd)
