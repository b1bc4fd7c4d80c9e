"""Training steps of the port's single-device trainer, back to back, fed
from a pool of batches made on the card in set-up.

Set-up builds one trainer (``make_single_device_trainer``), copies the
seed's weights into it and drives it through ``checked_steps`` steps on
distinct batches of the pool, by the window's own call: their losses, the
first step's gradient norm a leaf (read from the Adagrad accumulators
after it) and the parameters' change a leaf after the last are kept; a
few more steps warm up; the same trainer then runs the window. After the
window the plain reference runs the checked steps from the same weights
and batches. The window ends in a synchronize.

Traffic keys: ``batch``, ``pool_batches``, ``optimizer`` ("adagrad"),
``learning_rate``, ``initial_accumulator_value``, ``eps``,
``use_logq_correction``, ``use_sparse_embedding_optimizer``,
``checked_steps``, ``warmup_steps``, ``trace_seconds``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from portbench import compare, inputs, system
from portbench.reference import two_tower as ref
from portbench.window import Recorder, stage, timed_loop

@dataclass
class Sut:
    state: object
    step: object
    pool: Dict[str, torch.Tensor]
    readings: dict
    loss: object = None

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        n = next(iter(self.pool.values())).shape[0]
        return {name: col[i % n] for name, col in self.pool.items()}


def accumulators(state) -> Dict[str, torch.Tensor]:
    """The Adagrad accumulators of a trainer's state by parameter name:
    the sparse step's tables and its dense optimizer's leaves, or the
    dense step's leaves."""
    if hasattr(state, "sparse_state"):
        return {**state.sparse_state.accumulators,
                **state.dense_opt_state.sum_of_squares}
    return dict(state.opt_state.sum_of_squares)


def setup(ctx) -> Sut:
    from hm_retrieval_tpu_torch.models.train_path import (
        make_single_device_trainer,
    )

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if tr["optimizer"] != "adagrad":
        raise ValueError("train_steps reads Adagrad's accumulators")
    probs = inputs.article_probs(cfg, ctx.seed)
    logq = inputs.logq_table(probs) if tr["use_logq_correction"] else None
    sch = system.schema(
        cfg, logq=logq, train_batch_size=tr["batch"],
        optimizer_name="adagrad",
        optimizer_kwargs={"learning_rate": tr["learning_rate"]},
        use_logq_correction=tr["use_logq_correction"],
        use_sparse_embedding_optimizer=tr["use_sparse_embedding_optimizer"],
        seed=ctx.seed % 2**63)
    mdl = system.model(sch, dev)
    stage("schema and model")
    state, step = make_single_device_trainer(mdl, sch.training_config)
    stage("trainer (its own initialisation)")
    w0 = inputs.make_weights(cfg, ctx.seed, dev)
    system.load_weights(mdl, w0)
    sut = Sut(state, step, inputs.train_pool(cfg, tr, probs, ctx.seed, dev), {})
    stage("weights and batches")
    rec = Recorder(dev)
    losses: List[float] = []
    for i in range(tr["checked_steps"]):
        call(sut, i, rec)
        losses.append(float(sut.loss))
        if i == 0:
            grad = compare.first_grad_norms(accumulators(sut.state),
                                            tr["initial_accumulator_value"])
    change = compare.change_norms(sut.state.params, w0)
    del w0
    stage("checked steps")
    sut.readings = {"losses": losses, "grad": grad, "change": change}
    for i in range(tr["checked_steps"], tr["checked_steps"] + tr["warmup_steps"]):
        call(sut, i, rec)
    _sync(dev)
    stage("warm-up steps")
    return sut


def call(sut: Sut, i: int, rec) -> None:
    with rec.span("step"):
        sut.state, out = sut.step(sut.state, sut.batch(i))
    sut.loss = out["loss"]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(ctx, sut: Sut, seconds: float):
    tr = ctx.traffic
    return timed_loop(ctx, seconds, lambda i, rec: call(sut, i, rec),
                      lambda: _sync(ctx.device),
                      first=tr["checked_steps"] + tr["warmup_steps"])


def end_to_end(ctx, win) -> Dict[str, float]:
    return {"train_examples_per_s":
            win.calls * ctx.traffic["batch"] / win.seconds}


def release(sut: Sut):
    """The program's readings and the checked steps' batches; the trainer
    is dropped."""
    n = len(sut.readings["losses"])
    kept = {"program": sut.readings,
            "batches": [{k: v.clone() for k, v in sut.batch(i).items()}
                        for i in range(n)]}
    sut.state = sut.step = sut.pool = None
    return kept


def reference_readings(ctx, batches, tf32: bool = False,
                       half_batch: bool = False) -> dict:
    """The reference's losses, first gradient norms and changes over
    ``batches`` from the seed's weights (``tf32`` and ``half_batch``: a
    control and a planted fault, put in the program's place)."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    probs = inputs.article_probs(cfg, ctx.seed)
    logq = (torch.as_tensor(inputs.logq_table(probs), device=dev)
            if tr["use_logq_correction"] else None)
    params = {n: p.clone() for n, p in
              inputs.make_weights(cfg, ctx.seed, dev).items()}
    losses, grad = ref.adagrad_steps(
        cfg, params, batches, logq, tr["learning_rate"],
        tr["initial_accumulator_value"], tr["eps"], tf32=tf32,
        half_batch=half_batch)
    change = compare.change_norms(params, inputs.make_weights(cfg, ctx.seed, dev))
    return {"losses": losses, "grad": grad, "change": change}


def check(ctx, kept, win) -> Dict[str, float]:
    return compare.train_numbers(kept["program"],
                                 reference_readings(ctx, kept["batches"]))
