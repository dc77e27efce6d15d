"""The port's zamba2 serving path (repro_torch.models.ssd, the hybrid
family of .transformer, .serve) against the JAX reference.

The zamba2 SMOKE config (4 mamba layers, d_model 64, a shared attention
block of 4 heads (2 KV heads) of 16 after every 2nd layer, ssm_state 8,
ssm_head_dim 16) runs in f32.  The reference's parameters from
``repro.models.init_model`` are carried across by ``from_reference``,
after ``A_log``, ``dt_bias``, ``D``, the three conv biases and
``norm_scale`` are set to seeded random values in the numpy tree that
both packages get (the reference's init has 0, 0, 1, 0 and 1, which
would leave those terms untested).  Held to the reference:

* the configs (fields, ``param_count``) and the parameter tree (names,
  shapes, the top-level ``"shared"`` block) of the port's own
  ``init_model``;
* prefill logits over 70 tokens (two scan chunks, the second ragged) on
  the reference's route (``ssd_scan_chunked``, plain attention) and on
  the kernel routes (``use_scan_kernel`` and ``use_flash``: K4's and K2's
  plain versions on the CPU) against ``repro.models.forward``, at atol
  1e-4 (f32 sums in another order over four layers);
* ``ssd_block(use_kernel=True)`` in bf16 against the reference's
  ``ssd_block(use_pallas=True, interpret=True)`` at 2e-2 of the output's
  scale (see the test);
* ``decode_step`` logits, the SSD and conv states and the shared block's
  KV caches over several steps, at 1e-4;
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
from repro.models import ssd as ref_ssd
from repro_torch import configs
from repro_torch.models import from_reference, init_cache, init_model
from repro_torch.models import ssd as M
from repro_torch.serve import greedy_generate, make_decode_step, make_prefill_step

NAME = "zamba2_2b7"
CACHE_KEYS = ("ssm", "conv_x", "conv_B", "conv_C", "shared_k", "shared_v")


def _flat(tree, prefix=""):
    """Leaves of a nested dict under their dotted paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _randomize_ssd_leaves(tree, seed):
    """Seeded random values for the leaves the reference initialises to
    constants, in place in the numpy tree."""
    rng = np.random.default_rng(seed)
    ssd = tree["layers"]["ssd"]
    draw = {
        "A_log": lambda s: rng.uniform(-1.5, 0.5, s),
        "dt_bias": lambda s: rng.uniform(-1.0, 1.0, s),
        "D": lambda s: rng.uniform(0.5, 1.5, s),
        "conv_x_b": lambda s: 0.1 * rng.standard_normal(s),
        "conv_B_b": lambda s: 0.1 * rng.standard_normal(s),
        "conv_C_b": lambda s: 0.1 * rng.standard_normal(s),
        "norm_scale": lambda s: rng.uniform(0.5, 1.5, s),
    }
    for name, fn in draw.items():
        ssd[name] = fn(ssd[name].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params)."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke(NAME), dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke(NAME), dtype="float32")
    tree = _randomize_ssd_leaves(jax.tree.map(np.asarray, ref_models.init_model(
        ref_cfg, jax.random.PRNGKey(0))), 17)
    ref_params = jax.tree.map(jnp.asarray, tree)
    return ref_cfg, ref_params, cfg, from_reference(cfg, tree, "cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_config_and_param_tree_equal_reference(model):
    for getter in ("get_config", "get_smoke"):
        ref = getattr(ref_configs, getter)(NAME)
        port = getattr(configs, getter)("zamba2-2.7b")
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    smoke = configs.get_smoke(NAME)
    assert (smoke.num_layers, smoke.d_model, smoke.num_heads, smoke.kv_heads,
            smoke.head_size, smoke.ssm_state, smoke.ssm_head_dim,
            smoke.shared_attn_period) == (4, 64, 4, 2, 16, 8, 16, 2)
    ref_cfg, cfg = ref_configs.get_smoke(NAME), configs.get_smoke(NAME)
    ref_params = jax.eval_shape(
        lambda k: ref_models.init_model(ref_cfg, k), jax.random.PRNGKey(0))
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(v.shape) for k, v in params.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in _flat(ref_params).items()}
    assert "shared" in params and "attn" in params["shared"]
    assert all(v.dtype == torch.float32 and not v.requires_grad
               for v in params.parameters())
    ssd = params["layers"]["ssd"]
    assert bool((ssd["A_log"] == 0).all()) and bool((ssd["D"] == 1).all())
    # from_reference carried the randomized tree across unchanged.
    _, ref_p, _, port_p = model
    flat = {k: v.numpy() for k, v in port_p.state_dict().items()}
    ref_flat = _flat(ref_p)
    assert flat.keys() == ref_flat.keys()
    assert all(np.array_equal(flat[k], np.asarray(ref_flat[k])) for k in flat)


@pytest.mark.parametrize("kernels", [False, True])
def test_prefill_logits_match_reference(model, kernels):
    ref_cfg, ref_params, cfg, params = model
    tok = _tokens(1, 2, 70, cfg.vocab_size)
    want, _ = ref_models.forward(ref_cfg, ref_params, {"tokens": tok})
    got = make_prefill_step(cfg, use_flash=kernels, use_scan_kernel=kernels)(
        params, {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    last = make_prefill_step(cfg, use_flash=kernels, use_scan_kernel=kernels,
                             last_token_only=True)(
        params, {"tokens": torch.from_numpy(tok).long()})
    assert last.shape == (2, 1, cfg.vocab_size)
    torch.testing.assert_close(last, got[:, -1:], atol=1e-6, rtol=1e-6)


def test_ssd_block_kernel_route_bf16_matches_reference(model):
    ref_cfg, ref_params, cfg, params = model
    ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    ref_p = jax.tree.map(lambda v: v[0], ref_params["layers"]["ssd"])
    p = {k: v[0] for k, v in params["layers"]["ssd"].items()}
    rng = np.random.default_rng(8)
    b, t = 2, 70
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    state = {k: np.asarray(v[0], np.float32)
             for k, v in ref_models.init_cache(ref_cfg, b, 8).items()
             if k in ("ssm", "conv_x", "conv_B", "conv_C")}
    for k in state:
        state[k] = (0.1 * rng.standard_normal(state[k].shape)).astype(np.float32)
    bf = lambda v: jnp.asarray(v, jnp.bfloat16)
    ref_state = {k: (v if k == "ssm" else bf(v)) for k, v in state.items()}
    want, want_st = ref_ssd.ssd_block(ref_cfg, ref_p, bf(x), ref_state,
                                      use_pallas=True, interpret=True)
    tb = lambda v: torch.from_numpy(v).to(torch.bfloat16)
    port_state = {k: (torch.from_numpy(v) if k == "ssm" else tb(v))
                  for k, v in state.items()}
    got, got_st = M.ssd_block(cfg, p, tb(x), port_state, use_kernel=True)
    assert got.dtype == torch.bfloat16 and got_st["ssm"].dtype == torch.float32
    f32 = lambda v: np.asarray(jnp.asarray(v, jnp.float32))
    # Both round y to bf16 before the D skip.  The two frameworks round
    # bf16 elementwise work differently (a third of bf16 sigmoids differ by
    # one ulp between XLA and ATen, and the bf16 products accumulate in
    # another order), and that noise runs through the conv, the gated norm
    # and w_out: a few of the 8960 outputs near 0.3 land ~1e-3 past
    # 2e-2 + 2e-2 |want|.  So the output and the SSD state are held at
    # 2e-2 of their own scale: in RMS, and per element against the largest
    # magnitude.  The conv tails are the block's bf16 inputs, exactly.
    for g, w in ((got, want), (got_st["ssm"], want_st["ssm"])):
        g, w = g.float().numpy(), f32(w)
        err = np.abs(g - w)
        assert np.sqrt((err ** 2).mean()) <= 2e-2 * np.sqrt((w ** 2).mean())
        assert err.max() <= 2e-2 * np.abs(w).max()
    for k in ("conv_x", "conv_B", "conv_C"):
        np.testing.assert_array_equal(got_st[k].float().numpy(),
                                      f32(want_st[k]))


def test_decode_steps_match_reference(model):
    ref_cfg, ref_params, cfg, params = model
    b, steps = 2, 6
    tok = _tokens(3, b, steps, cfg.vocab_size)
    ref_cache = ref_models.init_cache(ref_cfg, b, 16)
    cache = init_cache(cfg, b, 16, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in ref_cache.items()}
    assert set(cache) == set(CACHE_KEYS)
    ref_step = jax.jit(ref_serve.make_decode_step(ref_cfg))
    step = make_decode_step(cfg)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        want, ref_cache = ref_step(ref_params, tok[:, t:t + 1], pos, ref_cache)
        got, cache = step(params, torch.from_numpy(tok[:, t:t + 1]).long(),
                          torch.from_numpy(pos).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for key in CACHE_KEYS:
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
    pre = make_prefill_step(cfg, use_flash=True, use_scan_kernel=True,
                            last_token_only=True)(params, {"tokens": tok})
    cache = init_cache(cfg, 2, s, device="cpu")
    step = make_decode_step(cfg)
    for t in range(s):
        logits, cache = step(params, tok[:, t:t + 1],
                             torch.full((2,), t, dtype=torch.long), cache)
    torch.testing.assert_close(pre, logits, atol=1e-4, rtol=0)
