"""The plain references held to the port on the CPU at SMOKE sizes, in
float32, from the benchmark's own weights and tokens: the last-position
logits of a prefill (dense, and the MoE layer with and without capacity
drops) and three AdamW train steps."""

import dataclasses

import pytest
import torch

from portbench import checks, inputs
from portbench.reference import train as ref_train
from portbench.reference import transformer as ref
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models.params import ParamTree
from repro_torch.serve import make_prefill_step
from repro_torch.train import OptimizerConfig, TrainConfig, make_train_step
from repro_torch.train.optimizer import init_opt_state

OPT = {"lr": 1e-3, "betas": (0.9, 0.95), "eps": 1e-8, "weight_decay": 0.1,
       "grad_clip": 1.0, "warmup_steps": 2, "total_steps": 10000,
       "schedule": "cosine", "min_lr_ratio": 0.1}


def smoke(arch: str, **changes) -> tuple:
    """The port's SMOKE size of ``arch`` in float32, and its fields."""
    cfg = reduced(get_config(arch), dtype="float32", **changes)
    return cfg, dataclasses.asdict(cfg)


def tokens(model, shape, seed):
    cdf = inputs.zipf_cdf(model["vocab_size"], 1.2, "cpu")
    return inputs.zipf_tokens(cdf, shape,
                              inputs.generator(seed, "tokens", "cpu"))


@pytest.mark.parametrize("arch, changes", [
    ("olmo_1b", {}),
    ("granite_moe_3b", {}),
    ("granite_moe_3b", {"capacity_factor": 0.5}),   # many choices dropped
    # The benchmark's granite: the source's norm epsilon and score scale.
    ("granite_moe_3b", {"norm_eps": 1e-6, "query_scale": 0.015625}),
])
def test_prefill_last_logits_match_the_port(arch, changes):
    cfg, model = smoke(arch, **changes)
    x = tokens(model, (3, 24), seed=11)
    weights = ref.make_weights(model, 5, "cpu")
    step = make_prefill_step(cfg, use_flash=True, last_token_only=True)
    got = step(ParamTree(weights), {"tokens": x})[:, -1]
    with torch.no_grad():
        want = ref.last_logits(model, ref.make_weights(model, 5, "cpu"), x)
    assert got.shape[-1] == cfg.padded_vocab
    torch.testing.assert_close(got[:, :cfg.vocab_size], want, rtol=1e-4,
                               atol=1e-4)
    numbers = checks.prefill_numbers(got, want)
    assert numbers["served_gap"] == 0.0 and numbers["logit_err"] < 1e-3


def test_the_moe_reference_drops_choices_past_capacity():
    _, model = smoke("granite_moe_3b", capacity_factor=0.5)
    w = ref.make_weights(model, 5, "cpu")
    x = torch.randn(2, 16, model["d_model"])
    p = ref.layer_params(w["layers"], 0)["moe"]
    full, _ = ref.moe({**model, "capacity_factor": 100.0}, p, x)
    cut, _ = ref.moe(model, p, x)
    assert not torch.allclose(full, cut)
    # The first token's choices are the first in every expert: never cut.
    torch.testing.assert_close(full[0, 0], cut[0, 0])


def test_three_train_steps_match_the_port():
    cfg, model = smoke("olmo_1b")
    rows = tokens(model, (3, 2, 17), seed=3)
    batches = [(r[:, :-1], r[:, 1:]) for r in rows]
    params = ParamTree(ref.make_weights(model, 9, "cpu"),
                       requires_grad=True)
    state = {"params": params, "opt": init_opt_state(params)}
    step = make_train_step(cfg, OptimizerConfig(**OPT), TrainConfig())
    prog = {"losses": []}
    for i, (t, lab) in enumerate(batches):
        state, metrics = step(state, {"tokens": t, "labels": lab})
        prog["losses"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad"] = {k: float(m.norm()) / 0.1 for k, m in
                            inputs.leaves(state["opt"]["m"]).items()}
    start = inputs.leaves(ref.make_weights(model, 9, "cpu"))
    prog["change"] = {k: float((p.detach() - start[k]).norm())
                      for k, p in state["params"].named_parameters()}
    losses, grad, change = ref_train.train(ref.loss, model, OPT, start,
                                           batches, aux_weight=0.01)
    numbers = checks.train_numbers(
        prog, {"losses": losses, "grad": grad, "change": change})
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-4
    assert set(grad) == set(prog["grad"]) and len(grad) >= 5


def test_the_schedule_matches_the_port():
    from repro_torch.train.optimizer import lr_at
    for step in (1, 2, 3, 50, 9999):
        assert ref_train.lr_at(OPT, step) == pytest.approx(
            float(lr_at(OptimizerConfig(**OPT), torch.tensor(step))),
            rel=1e-6)
