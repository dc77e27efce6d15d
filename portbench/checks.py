"""The numbers that decide ``correct``, each against a limit of its own.

Prefill (a served model): for a sample of the window's requests, drawn
from the seed with one of the longest in it, the plain reference's
float32 logits at each prompt's last position are compared with the
program's:

* ``served_gap``: the widest gap by which the greedy token the program
  serves (its argmax) lies below the reference's best logit;
* ``logit_err``: the widest |program - reference| logit, over the
  reference's standard deviation of that row; ``logit_err_p90`` and
  ``logit_err_median`` the rows' 90th percentile and median of it.

Training: the reference follows the program's first three steps from the
same weights and batches:

* ``loss1_gap``: |program - reference| loss of the first step, and
  ``loss_gap`` the widest of the three;
* ``grad_gap``: the first step's clipped gradient as the optimizer got it,
  by the worst leaf: |norm(program) - norm(reference)| over the larger of
  the reference leaf's norm and the median leaf's;
* ``change_gap``: the same of the parameters' change over the three
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (round-off moves them under Adam).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

#: Reference gradient below this share of the median leaf's: no change
#: is compared for the leaf.
NEGLIGIBLE_GRAD = 1e-3


def sample(candidates: list[int], lengths: list[int], k: int, rng
           ) -> list[int]:
    """``k`` of the finished requests ``candidates`` (indices into
    ``lengths``), drawn by ``rng``, one of them of the longest length
    among the candidates."""
    chosen = [int(i) for i in rng.choice(candidates, size=min(
        k, len(candidates)), replace=False)]
    longest = max(lengths[i] for i in candidates)
    if not any(lengths[i] == longest for i in chosen):
        chosen[-1] = int(rng.choice([i for i in candidates
                                     if lengths[i] == longest]))
    return sorted(chosen)


def prefill_numbers(served: torch.Tensor, ref: torch.Tensor) -> dict:
    """``served``: (n, >= vocab) logits the program produced, ``ref``:
    (n, vocab) f32 reference logits of the same rows."""
    vocab = ref.shape[-1]
    got = served[:, :vocab].float()
    token = got.argmax(-1)
    gap = ref.max(-1).values - ref.gather(-1, token[:, None])[:, 0]
    err = (got - ref).abs().max(-1).values / ref.std(-1)
    return {"served_gap": float(gap.max()), "logit_err": float(err.max()),
            "logit_err_p90": float(err.quantile(0.9)),
            "logit_err_median": float(err.median()),
            "rows_over_twice_median": int((err > 2 * err.median()).sum()),
            "checked_rows": int(ref.shape[0])}


def leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """Worst leaf's |norm gap| over max(its reference norm, the median
    leaf's reference norm)."""
    median = statistics.median(ref.values())
    keys = ref if leaves is None else leaves
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in keys)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    median = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items()
             if g >= NEGLIGIBLE_GRAD * median]
    gaps = np.abs(np.subtract(prog["losses"], ref["losses"]))
    return {"loss1_gap": float(gaps[0]), "loss_gap": float(gaps.max()),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], moved)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the limits name is there, finite and within its
    limit, {name: {value, limit}} of those); no limits is not correct."""
    out, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit}
        if not np.isfinite(value) or value > limit:
            ok = False
    return ok, out
