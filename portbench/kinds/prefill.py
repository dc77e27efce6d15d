"""Prefill, one client in a closed loop: the next request is issued when
the last one's logits are on the host.  A request is b prompts of one
length L (``traffic.prefill_shapes``) through the program's
``make_prefill_step``; the configuration's reference recomputes the
last-position logits of a sample of the window's requests.

Every request's logits reach the host through a ring of
``keep_requests`` pinned slots, so no request allocates host memory while
timed, and every request does the same host work; the check draws its
``check_requests`` from the window's last ``keep_requests`` requests, one
of the longest among them.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import checks, inputs, loops, precision, tracing
from portbench import traffic as gen


def run(run: loops.Run, spans_needed: dict, hooks: loops.Hooks) -> None:
    from repro_torch.models.params import ParamTree
    from repro_torch.serve import make_prefill_step

    tr, model, dev, ref = run.traffic, run.model, run.device, run.ref
    run.work = "prefill"                # the items are requests
    cfg = loops.model_config(model)
    run.mark("imported")
    params = ParamTree(ref.make_weights(model, run.seed, dev))
    step = hooks(make_prefill_step(cfg, **tr["prefill"]))
    pool = tr["pool_requests"]
    shapes = gen.prefill_shapes(tr, run.seed, pool)
    cdf = inputs.zipf_cdf(model["vocab_size"], tr["zipf_a"], dev)
    tokens = inputs.zipf_tokens(cdf, (pool, tr["tokens_per_request"]),
                                inputs.generator(run.seed, "tokens", dev))

    def request(i):
        b, s = shapes[i % pool]
        return tokens[i % pool].view(b, s)

    seconds = run.seconds()
    slots = tr["keep_requests"]
    loops.sync(dev)
    run.mark("inputs")
    with loops.window(run, spans_needed) as (spans, prof):
        for length in gen.lengths(tr):          # every shape, twice
            i = next(j for j, (_, s) in enumerate(shapes) if s == length)
            for _ in range(2):
                out = step(params, {"tokens": request(i)})[:, -1]
        ring = torch.empty((slots, max(b for b, _ in shapes), out.shape[-1]),
                           dtype=out.dtype, pin_memory=dev.type == "cuda")
        if prof is not None:                     # the profiler's own start
            with tracing.profiler():
                ring[0, :1].copy_(step(params, {"tokens": request(0)})[:1, -1])
        loops.sync(dev)
        # What set-up left on the heap is kept out of the window's
        # collections, as a serving process does once it is warm.
        gc.collect()
        gc.freeze()
        run.setup_s = time.perf_counter() - run.t0
        with loops.GcClock() as clock, loops.traced(prof, spans, dev):
            start = time.perf_counter()
            i = 0
            while time.perf_counter() - start < seconds:
                x = request(i)
                b = x.shape[0]
                issue = time.perf_counter()
                ring[i % slots, :b].copy_(step(params, {"tokens": x})[:, -1])
                done = time.perf_counter()
                run.items.append({"b": b, "s": x.shape[1],
                                  "issue": issue - start,
                                  "done": done - start})
                i += 1
            run.window_s = time.perf_counter() - start
        gc.unfreeze()
        loops.finish_trace(run, prof, spans)
    run.notes.update(gc_collections=clock.count, gc_seconds=clock.seconds)
    run.memory_peak_bytes = loops.peak(dev)
    del params, step, out
    loops.free(dev)

    run.mark("window")
    n = len(run.items)
    rng = np.random.default_rng(inputs.sub_seed(run.seed, "sample"))
    picked = checks.sample(list(range(max(0, n - slots), n)),
                           [it["s"] for it in run.items],
                           tr["check_requests"], rng)
    weights = ref.make_weights(model, run.seed, dev)
    got, want = [], []
    with torch.no_grad(), loops.exact_f32():
        for i in picked:
            got.append(ring[i % slots, :run.items[i]["b"]].float())
            want.append(ref.last_logits(model, weights, request(i)).cpu())
    run.numbers = checks.prefill_numbers(torch.cat(got), torch.cat(want))
    run.mark("checked")


# The stand-ins (``loops.hooks``): the benchmark's own runs use none.

def control(run: loops.Run):
    """The plain reference, every product input rounded to fp8, in the
    program's place: one step below the bf16 the configurations state."""
    model, ref = run.model, run.ref

    def wrap(step):
        def stand_in(params, batch):
            with torch.no_grad(), loops.exact_f32():
                out = ref.last_logits(model, params.to_dict(),
                                      batch["tokens"], precision.fp8)
            return out[:, None, :]
        return stand_in
    return wrap


def _answer_altered(step):
    """Row 0's logits replaced by row 1's, where they are produced."""
    def run(params, batch):
        out = step(params, batch).clone()
        out[0] = out[1]
        return out
    return run


def _half_batch(step):
    """The first half of the prompts computed, their logits served for
    the rest too."""
    def run(params, batch):
        tokens = batch["tokens"]
        half = step(params, {**batch, "tokens": tokens[:tokens.shape[0] // 2]})
        return torch.cat([half, half])
    return run


FAULTS = {"answer_altered": _answer_altered, "half_batch": _half_batch}
