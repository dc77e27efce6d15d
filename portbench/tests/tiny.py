"""A checkout-like root for the CPU tests: the repository's
``BENCHMARK.json`` and the benchmark's files found by name, plus tiny
cells added only as files and entries, as a later change would add them:
one of them names a reference module and a loop kind of its own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = ("configs", "traffic", "cells", "metrics", "kinds", "reference")

TINY = {
    "dense": {"name": "tiny-dense", "family": "dense", "num_layers": 2,
              "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
              "head_dim": 32, "d_ff": 128, "vocab_size": 256,
              "act": "silu_glu", "norm": "layernorm", "norm_eps": 1e-05,
              "non_parametric_norm": True, "tie_embeddings": True,
              "rope_theta": 10000.0, "dtype": "bfloat16",
              "param_dtype": "float32"},
    "moe": {"name": "tiny-moe", "family": "moe", "num_layers": 2,
            "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 32,
            "d_ff": 64, "vocab_size": 250, "vocab_pad": 6, "act": "silu_glu",
            "norm": "rmsnorm", "norm_eps": 1e-05, "num_experts": 4,
            "top_k": 2, "expert_d_ff": 64, "capacity_factor": 1.25,
            "moe_groups": 1, "tie_embeddings": True, "rope_theta": 10000.0,
            "dtype": "bfloat16", "param_dtype": "float32"},
}
PREFILL = {"kind": "prefill", "why": "tiny", "tokens_per_request": 128,
           "length_block": {"32": 1, "64": 1}, "zipf_a": 1.2,
           "prefill": {"use_flash": True, "last_token_only": True},
           "pool_requests": 16, "check_requests": 10, "keep_requests": 12,
           "trace_seconds": 1}
TRAIN = {"kind": "train", "why": "tiny", "batch": 4, "seq_len": 32,
         "zipf_a": 1.2,
         "optimizer": {"lr": 0.001, "betas": [0.9, 0.95], "eps": 1e-08,
                       "weight_decay": 0.1, "grad_clip": 1.0,
                       "warmup_steps": 2, "total_steps": 10000,
                       "schedule": "cosine", "min_lr_ratio": 0.1},
         "train": {"microbatches": 1, "remat": "block", "aux_weight": 0.01},
         "pool_steps": 6, "checked_steps": 3, "trace_seconds": 1}
#: Limits of the tiny cells, set as the real cells' are, from CPU
#: readings over six to eight seeds (bf16 activations).  The program read
#: logit_err <= 0.067 (dense), logit_err_p90 <= 0.13 (moe),
#: logit_err_median <= 0.042, loss1_gap <= 5.6e-4, grad_gap <= 1.8e-3,
#: change_gap <= 1.0e-3; the fp8 control logit_err >= 0.386, p90 >= 0.34,
#: median >= 0.27, grad_gap >= 0.0106, change_gap >= 0.0071; the faults
#: logit_err and p90 >= 2.6, loss1_gap 0.055 (the altered loss) or
#: grad_gap >= 0.07.  A routing flip swings the MoE cell's widest
#: logit_err to 1.66, as on the card, so that cell compares its p90.
LIMITS = {"tiny-dense.prefill": {"logit_err": 0.2, "logit_err_median": 0.15},
          "tiny-moe.prefill": {"logit_err_p90": 0.25,
                               "logit_err_median": 0.15},
          "tiny-dense.train": {"loss1_gap": 0.01, "grad_gap": 0.005,
                               "change_gap": 0.003}}
LIMITS["tiny-own.prefill"] = LIMITS["tiny-dense.prefill"]


#: A model family's reference module added as a file: the attention
#: families' reference, counting its calls.
OWN_REFERENCE = '''
from portbench.reference.transformer import (  # noqa: F401
    last_logits as _last_logits, loss, make_weights, prefill_flops, same)

CALLS = []


def last_logits(model, params, tokens, rnd=same):
    CALLS.append(tuple(tokens.shape))
    return _last_logits(model, params, tokens, rnd)
'''
#: A loop kind added as a file: the prefill loop, counting its runs.
OWN_KIND = '''
from pathlib import Path

from portbench import cellspec

_base = cellspec.load_kind(Path(__file__).resolve().parents[2], "prefill")
FAULTS, control = _base.FAULTS, _base.control
RUNS = []


def run(run, spans, hooks):
    RUNS.append(run.seed)
    _base.run(run, spans, hooks)
'''


def make_root(tmp: Path) -> Path:
    """A root holding a copy of the benchmark's files found by name and
    ``BENCHMARK.json`` with four tiny cells added by files and entries;
    ``tiny-own.prefill`` names its own reference module and loop kind."""
    (tmp / "portbench").mkdir(parents=True)
    for d in DATA:
        shutil.copytree(REPO / "portbench" / d, tmp / "portbench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "portbench/reference/tiny_own.py").write_text(OWN_REFERENCE)
    (tmp / "portbench/kinds/tiny_own.py").write_text(OWN_KIND)
    own = {**TINY["dense"], "name": "tiny-own"}
    for model, ref in ((TINY["dense"], "transformer"),
                       (TINY["moe"], "transformer"), (own, "tiny_own")):
        path = f"portbench/configs/{model['name']}.json"
        (tmp / path).write_text(json.dumps({
            "model": model, "reduced": [],
            "reference": f"portbench/reference/{ref}.py"}))
        bench["configs"].append({"name": model["name"], "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
    (tmp / "portbench/traffic/tiny.prefill.json").write_text(
        json.dumps(PREFILL))
    (tmp / "portbench/traffic/tiny.own.json").write_text(
        json.dumps({**PREFILL, "kind": "tiny_own"}))
    (tmp / "portbench/traffic/tiny.train.json").write_text(json.dumps(TRAIN))
    cells = {"tiny-dense.prefill": ("tiny-dense", "tiny.prefill"),
             "tiny-moe.prefill": ("tiny-moe", "tiny.prefill"),
             "tiny-dense.train": ("tiny-dense", "tiny.train"),
             "tiny-own.prefill": ("tiny-own", "tiny.own")}
    for name, (config, traffic) in cells.items():
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        (tmp / f"portbench/cells/{name}.json").write_text(
            json.dumps({"limits": LIMITS[name]}))
    like = {"olmo-1b.prefill.mixed": ["tiny-dense.prefill",
                                      "tiny-own.prefill"],
            "granite-moe-3b-a800m.prefill.mixed": ["tiny-moe.prefill"],
            "olmo-1b.train.4x4096": ["tiny-dense.train"]}
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] += sorted({t for cell in metric["workloads"]
                                           for t in like.get(cell, [])})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
