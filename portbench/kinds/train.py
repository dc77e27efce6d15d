"""Training, one step after another, each on a fresh batch of ``batch`` x
``seq_len`` tokens, through the program's ``make_train_step``.

Set-up builds one train state, drives it from the seed through its first
``checked_steps`` steps by the window's own call, and hands that same
state to the window.  The configuration's reference follows those steps
from the same weights and batches (``reference/train.py``).
"""

from __future__ import annotations

import time

import torch

from portbench import checks, inputs, loops, tracing
from portbench.reference import train as ref_train


def rows(run: loops.Run) -> torch.Tensor:
    """(pool_steps, batch, seq_len + 1) token ids: step i's tokens are
    ``[i, :, :-1]`` and its labels ``[i, :, 1:]``."""
    tr = run.traffic
    cdf = inputs.zipf_cdf(run.model["vocab_size"], tr["zipf_a"], run.device)
    return inputs.zipf_tokens(
        cdf, (tr["pool_steps"], tr["batch"], tr["seq_len"] + 1),
        inputs.generator(run.seed, "tokens", run.device))


def _opt(opt: dict) -> dict:
    return {**opt, "betas": tuple(opt["betas"])}


def run(run: loops.Run, spans_needed: dict, hooks: loops.Hooks) -> None:
    from repro_torch.models.params import ParamTree
    from repro_torch.train import (
        OptimizerConfig,
        TrainConfig,
        make_train_step,
    )
    from repro_torch.train.optimizer import init_opt_state

    tr, model, dev, ref = run.traffic, run.model, run.device, run.ref
    run.work = "train"                  # the items are steps
    cfg = loops.model_config(model)
    run.mark("imported")
    b, s = tr["batch"], tr["seq_len"]
    pool = tr["pool_steps"]
    toks = rows(run)

    def batch(i):
        row = toks[i % pool]
        return {"tokens": row[:, :-1], "labels": row[:, 1:]}

    params = ParamTree(ref.make_weights(model, run.seed, dev),
                       requires_grad=True)
    state = {"params": params, "opt": init_opt_state(params)}
    del params
    step = hooks(make_train_step(cfg, OptimizerConfig(**_opt(tr["optimizer"])),
                                 TrainConfig(**tr["train"])))
    checked = tr["checked_steps"]
    b1 = tr["optimizer"]["betas"][0]
    loops.sync(dev)
    run.mark("inputs")
    prog = {"losses": []}
    for i in range(checked):            # the first steps: set-up and check
        state, metrics = step(state, batch(i))
        prog["losses"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad"] = {k: float(m.norm()) / (1 - b1) for k, m in
                            inputs.leaves(state["opt"]["m"]).items()}
    start_w = inputs.leaves(ref.make_weights(model, run.seed, dev))
    prog["change"] = {k: float((p.detach() - start_w[k]).norm())
                      for k, p in state["params"].named_parameters()}
    del start_w
    seconds = run.seconds()
    metrics = None
    with loops.window(run, spans_needed) as (spans, prof):
        if prof is not None:                     # the profiler's own start
            with tracing.profiler():
                torch.zeros(1, device=dev).add_(1)
                loops.sync(dev)
        loops.sync(dev)
        run.setup_s = time.perf_counter() - run.t0
        with loops.traced(prof, spans, dev):
            start = time.perf_counter()
            i = checked
            while time.perf_counter() - start < seconds:
                t = time.perf_counter()
                state, metrics = step(state, batch(i))
                loops.sync(dev)
                run.items.append({"b": b, "s": s, "issue": t - start,
                                  "done": time.perf_counter() - start})
                i += 1
            run.window_s = time.perf_counter() - start
        loops.finish_trace(run, prof, spans)
    run.memory_peak_bytes = loops.peak(dev)
    del state, metrics, step
    loops.free(dev)

    run.mark("window")
    weights = inputs.leaves(ref.make_weights(model, run.seed, dev))
    with loops.exact_f32():
        losses, grad, change = ref_train.train(
            ref.loss, model, _opt(tr["optimizer"]), weights,
            [(batch(i)["tokens"], batch(i)["labels"])
             for i in range(checked)],
            aux_weight=tr["train"].get("aux_weight", 0.0))
    run.numbers = checks.train_numbers(
        prog, {"losses": losses, "grad": grad, "change": change})
    run.notes.update(losses=prog["losses"], reference_losses=losses)
    run.mark("checked")


# The stand-ins (``loops.hooks``, ``control_numbers``): the benchmark's own
# runs use none.

def _unchanged(step):
    """The step returns the state it was given."""
    def run(state, batch):
        return state, step(state, batch)[1]
    return run


def _half_batch(step):
    """The step sees the first half of the batch: the mean is over those
    rows."""
    def run(state, batch):
        return step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    return run


def _loss_altered(step):
    """The step's loss 1% off, where it is produced."""
    def run(state, batch):
        state, metrics = step(state, batch)
        return state, {**metrics, "loss": metrics["loss"] * 1.01}
    return run


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "answer_altered": _loss_altered}


def control_numbers(run: loops.Run) -> dict:
    """The numbers with the fp8 reference in the program's place: its
    first steps against the f32 reference's, from the same weights and
    batches as a run of ``run``'s seed.  It needs no window."""
    from portbench import precision

    tr, model, dev, ref = run.traffic, run.model, run.device, run.ref
    toks = rows(run)
    batches = [(toks[i, :, :-1], toks[i, :, 1:])
               for i in range(tr["checked_steps"])]
    weights = inputs.leaves(ref.make_weights(model, run.seed, dev))
    aux = tr["train"].get("aux_weight", 0.0)
    out = {}
    with loops.exact_f32():
        for side, rnd in (("ref", ref.same), ("control", precision.fp8)):
            losses, grad, change = ref_train.train(
                ref.loss, model, _opt(tr["optimizer"]), weights, batches,
                aux_weight=aux, rnd=rnd)
            out[side] = {"losses": losses, "grad": grad, "change": change}
    return checks.train_numbers(out["control"], out["ref"])
