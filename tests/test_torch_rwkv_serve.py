"""The port's rwkv6 serving path (repro_torch.models.rwkv, the ssm family
of .transformer, .serve) against the JAX reference.

The rwkv6 SMOKE config (2 layers, d_model 64, 4 heads of 16) runs in f32.
The reference's parameters from ``repro.models.init_model`` are carried
across by ``from_reference``, after ``bonus_u`` and both ``mu`` leaves are
set to seeded random values in the numpy tree that both packages get (the
reference's init has u = 0 and mu = 0.5, which would leave the bonus term
and the token-shift mix untested).  Held to the reference:

* the configs (fields, ``param_count``) and the parameter tree (names,
  shapes) of the port's own ``init_model``;
* prefill logits over 70 tokens (two scan chunks, the second ragged) with
  ``use_scan_kernel`` False (``rwkv_scan_chunked``) and True (the WKV
  scan's plain version on the CPU) against ``repro.models.forward``, at
  atol 1e-4 (f32 sums in another order over two layers);
* ``decode_step`` logits and the recurrent state over several steps, at
  1e-4;
* ``greedy_generate`` tokens, exactly.

And in the port alone: the last prompt position's prefill logits against
the decode route's, which carries the state token by token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.serve as ref_serve
from repro_torch import configs
from repro_torch.models import from_reference, init_cache, init_model
from repro_torch.serve import greedy_generate, make_decode_step, make_prefill_step

NAME = "rwkv6_1b6"


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params)."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke(NAME), dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke(NAME), dtype="float32")
    tree = jax.tree.map(np.asarray, ref_models.init_model(
        ref_cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(13)
    layers = tree["layers"]
    layers["tmix"]["bonus_u"] = 0.5 * rng.standard_normal(
        layers["tmix"]["bonus_u"].shape).astype(np.float32)
    for block in ("tmix", "cmix"):
        layers[block]["mu"] = rng.uniform(
            0.0, 1.0, layers[block]["mu"].shape).astype(np.float32)
    ref_params = jax.tree.map(jnp.asarray, tree)
    return ref_cfg, ref_params, cfg, from_reference(cfg, tree, "cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_config_and_param_tree_equal_reference():
    for getter in ("get_config", "get_smoke"):
        ref = getattr(ref_configs, getter)(NAME)
        port = getattr(configs, getter)("rwkv6-1.6b")
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    ref_cfg, cfg = ref_configs.get_smoke(NAME), configs.get_smoke(NAME)
    ref_params = jax.eval_shape(
        lambda k: ref_models.init_model(ref_cfg, k), jax.random.PRNGKey(0))
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(v.shape) for k, v in params.state_dict().items()}
    assert got == _flat_shapes(ref_params)
    assert all(v.dtype == torch.float32 and not v.requires_grad
               for v in params.parameters())
    tmix = params["layers"]["tmix"]
    assert bool((tmix["wd_bias"] == -6.0).all())
    assert bool((tmix["mu"] == 0.5).all()) and bool((tmix["bonus_u"] == 0).all())


@pytest.mark.parametrize("use_scan_kernel", [False, True])
def test_prefill_logits_match_reference(model, use_scan_kernel):
    ref_cfg, ref_params, cfg, params = model
    tok = _tokens(1, 2, 70, cfg.vocab_size)
    want, _ = ref_models.forward(ref_cfg, ref_params, {"tokens": tok})
    got = make_prefill_step(cfg, use_scan_kernel=use_scan_kernel)(
        params, {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    last = make_prefill_step(cfg, use_scan_kernel=use_scan_kernel,
                             last_token_only=True)(
        params, {"tokens": torch.from_numpy(tok).long()})
    assert last.shape == (2, 1, cfg.vocab_size)
    torch.testing.assert_close(last, got[:, -1:], atol=1e-6, rtol=1e-6)


def test_decode_steps_match_reference(model):
    ref_cfg, ref_params, cfg, params = model
    b, steps = 2, 6
    tok = _tokens(3, b, steps, cfg.vocab_size)
    ref_cache = ref_models.init_cache(ref_cfg, b, 16)
    cache = init_cache(cfg, b, 16, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in ref_cache.items()}
    ref_step = jax.jit(ref_serve.make_decode_step(ref_cfg))
    step = make_decode_step(cfg)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        want, ref_cache = ref_step(ref_params, tok[:, t:t + 1], pos, ref_cache)
        got, cache = step(params, torch.from_numpy(tok[:, t:t + 1]).long(),
                          torch.from_numpy(pos).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for key in ("S", "shift", "cmix_shift"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), atol=1e-4)


def test_greedy_generate_matches_reference(model):
    ref_cfg, ref_params, cfg, params = model
    prompt = _tokens(5, 2, 5, cfg.vocab_size)
    want = ref_serve.greedy_generate(ref_cfg, ref_params, jnp.asarray(prompt), 6)
    got = greedy_generate(cfg, params, prompt, 6)
    assert got.shape == (2, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_last_logits_match_decode_route(model):
    _, _, cfg, params = model
    s = 70
    tok = torch.from_numpy(_tokens(4, 2, s, cfg.vocab_size)).long()
    pre = make_prefill_step(cfg, use_scan_kernel=True, last_token_only=True)(
        params, {"tokens": tok})
    cache = init_cache(cfg, 2, s, device="cpu")
    step = make_decode_step(cfg)
    for t in range(s):
        logits, cache = step(params, tok[:, t:t + 1],
                             torch.full((2,), t, dtype=torch.long), cache)
    torch.testing.assert_close(pre, logits, atol=1e-4, rtol=0)
