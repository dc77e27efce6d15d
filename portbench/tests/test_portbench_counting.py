"""The benchmark's counts, pinned at olmo-1b's 4 x 4096 shapes."""

import json
from pathlib import Path

import pytest

from portbench import counting

ROOT = Path(__file__).resolve().parents[2]


def model(name):
    return json.loads((ROOT / "portbench/configs" / f"{name}.json")
                      .read_text())["model"]


def test_olmo_prefill_request_is_39_6_tflop():
    # 2 x 1.074e9 layer weights x 16384 tokens + 4.40e12 of causal
    # attention + the last positions' unembedding.
    flops = counting.prefill_flops(model("olmo-1b"), 4, 4096)
    assert flops == pytest.approx(39.6e12, rel=2e-3)
    assert counting.attention_flops(model("olmo-1b"), 4, 4096) == \
        16 * 4 * 4 * 16 * 128 * 4096 * 4097 // 2


def test_olmo_train_step_is_129_tflop_without_recompute():
    flops = counting.train_flops(model("olmo-1b"), 4, 4096)
    assert flops == pytest.approx(128.9e12, rel=2e-3)


def test_granite_counts_only_the_routed_experts():
    g = model("granite-moe-3b-a800m")
    active = counting.layer_matmul_params(g)
    every = counting.layer_matmul_params(g, active=False)
    assert every - active == (40 - 8) * 3 * 1536 * 512
    assert counting.prefill_flops(g, 4, 4096) == pytest.approx(
        2 * 32 * active * 16384 + 32 * 4 * 4 * 24 * 64 * 4096 * 4097 // 2
        + 2 * 1536 * 49168 * 4)


def test_flash_bound_at_olmo_shape_is_bound_by_operations():
    peak = counting.peaks("NVIDIA H100 80GB HBM3")
    seconds, by = counting.flash_bound(4, 16, 16, 4096, 128, 2, peak)
    assert by == "operations"
    assert seconds == pytest.approx(4 * 4 * 16 * 128 * 4096 * 4097 / 2
                                    / 989e12)
    # A short call moves more bytes than it computes.
    assert counting.flash_bound(128, 16, 16, 16, 128, 2, peak)[1] == "bytes"


def test_an_unknown_card_has_no_peaks():
    assert counting.peaks("some other card") is None
