"""The port's dense serving path (repro_torch.configs, .models, .serve)
against the JAX reference (repro.configs, repro.models, repro.serve).

The olmo-1b and starcoder2-3b SMOKE configs (starcoder2 adds GQA, biases
and the plain tanh-GELU MLP) run in f32; the reference's parameters from
``repro.models.init_model`` are carried across by ``from_reference``, and
the inputs are drawn from numpy seeds.  Held to the reference:

* the configs (fields, parameter counts) and the parameter tree (names,
  shapes) of the port's own ``init_model``;
* prefill logits with ``use_flash`` False and True and through the
  q-chunked path, at atol 1e-4 (f32 sums in another order over two
  layers);
* ``decode_step`` logits and cache over several positions, at 1e-4;
* ``greedy_generate`` tokens and a ``BatchingQueue`` run with slot reuse
  (examples/serve_decode.py), exactly.

And in the port alone: the last-position prefill logits against the
decode route's, the device rule, and every name of the reference's
registry resolving to its config.
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
from repro_torch.models import forward, from_reference, init_cache, init_model
from repro_torch.serve import (
    BatchingQueue,
    greedy_generate,
    make_decode_step,
    make_prefill_step,
)

ARCHS = ("olmo_1b", "starcoder2_3b")


def _f32(mod, name, **extra):
    return dataclasses.replace(mod.get_smoke(name), dtype="float32", **extra)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, reference cfg, reference params, port cfg, port params)."""
    name = request.param
    ref_cfg, cfg = _f32(ref_configs, name), _f32(configs, name)
    ref_params = ref_models.init_model(ref_cfg, jax.random.PRNGKey(0))
    if name == "starcoder2_3b":
        # Non-zero biases, so the bias branches are held too.
        leaves, tree = jax.tree.flatten(ref_params)
        rng = np.random.default_rng(11)
        ref_params = jax.tree.unflatten(tree, [
            jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
            if np.all(np.asarray(x) == 0) else x for x in leaves])
    params = from_reference(cfg, jax.tree.map(np.asarray, ref_params), "cpu")
    return name, ref_cfg, ref_params, cfg, params


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_configs_equal_reference(name):
    for getter in ("get_config", "get_smoke"):
        ref = getattr(ref_configs, getter)(name)
        port = getattr(configs, getter)(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    assert configs.get_config(name.replace("_", "-")) is configs.get_config(name)
    assert configs.get_smoke(name).activation_dtype() == torch.bfloat16


def test_unported_architectures_and_families_raise():
    """None is left: every name and dashed alias of the reference
    resolves in the port to the reference's config, every family builds
    its cache, and an unknown name still raises ``KeyError``."""
    for name in [*ref_configs.ARCHS, *ref_configs._ALIASES]:
        for getter in ("get_config", "get_smoke"):
            got = getattr(configs, getter)(name)
            want = getattr(ref_configs, getter)(name)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    keys = {"dense": {"k", "v"}, "vlm": {"k", "v"}, "moe": {"k", "v"},
            "encdec": {"k", "v", "xk", "xv"},
            "ssm": {"S", "shift", "cmix_shift"},
            "hybrid": {"ssm", "conv_x", "conv_B", "conv_C", "shared_k",
                       "shared_v"}}
    for name in configs.ARCHS:
        cfg = configs.get_smoke(name)
        assert set(init_cache(cfg, 1, 8, device="cpu")) == keys[cfg.family]
    with pytest.raises(KeyError):
        configs.get_config("nope")
    with pytest.raises(KeyError):
        configs.get_smoke("nope")


def test_device_rule():
    cfg = configs.get_smoke("olmo_1b")
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a host without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)


@pytest.mark.parametrize("name", ARCHS)
def test_init_model_tree_matches_reference(name):
    ref_cfg, cfg = ref_configs.get_smoke(name), configs.get_smoke(name)
    ref_params = jax.eval_shape(
        lambda k: ref_models.init_model(ref_cfg, k), jax.random.PRNGKey(0))
    ref_params = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), ref_params)
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(v.shape) for k, v in params.state_dict().items()}
    want = {k: v for k, v in _flat_shapes(ref_params).items()}
    assert got == want
    assert all(v.dtype == torch.float32 and not v.requires_grad
               for v in params.parameters())
    again = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(params.parameters(), again.parameters()))


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_logits_match_reference(arch, use_flash):
    _, ref_cfg, ref_params, cfg, params = arch
    tok = _tokens(1, 2, 40, cfg.vocab_size)
    want, _ = ref_models.forward(ref_cfg, ref_params, {"tokens": tok},
                                 use_flash=use_flash, interpret=True)
    got = make_prefill_step(cfg, use_flash=use_flash)(
        params, {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    last = make_prefill_step(cfg, use_flash=use_flash, last_token_only=True)(
        params, {"tokens": torch.from_numpy(tok).long()})
    assert last.shape == (2, 1, cfg.vocab_size)
    torch.testing.assert_close(last, got[:, -1:], atol=1e-6, rtol=1e-6)


def test_prefill_chunked_path_matches_reference(arch):
    """attn_chunk 8 on 32 tokens: four q-chunks (the reference scans them)."""
    _, ref_cfg, ref_params, cfg, params = arch
    ref_cfg = dataclasses.replace(ref_cfg, attn_chunk=8)
    cfg = dataclasses.replace(cfg, attn_chunk=8)
    tok = _tokens(2, 2, 32, cfg.vocab_size)
    want, _ = ref_models.forward(ref_cfg, ref_params, {"tokens": tok})
    got, aux = forward(cfg, params, {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(aux) == 0.0


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def test_decode_steps_match_reference(arch):
    _, ref_cfg, ref_params, cfg, params = arch
    b, max_seq, steps = 2, 12, 6
    tok = _tokens(3, b, steps, cfg.vocab_size)
    ref_cache = ref_models.init_cache(ref_cfg, b, max_seq)
    cache = init_cache(cfg, b, max_seq, device="cpu")
    ref_step = jax.jit(ref_serve.make_decode_step(ref_cfg))
    step = make_decode_step(cfg)
    for t in range(steps):
        # Rows at different positions, as continuous batching makes them.
        pos = np.array([t, t + 3], np.int32)
        want, ref_cache = ref_step(ref_params, tok[:, t:t + 1], pos, ref_cache)
        got, cache = step(params, torch.from_numpy(tok[:, t:t + 1]).long(),
                          torch.from_numpy(pos).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), atol=1e-4)


def test_prefill_last_logits_match_decode_route(arch):
    _, _, _, cfg, params = arch
    tok = torch.from_numpy(_tokens(4, 2, 24, cfg.vocab_size)).long()
    pre = make_prefill_step(cfg, use_flash=True, last_token_only=True)(
        params, {"tokens": tok})
    cache = init_cache(cfg, 2, 24, device="cpu")
    step = make_decode_step(cfg)
    for t in range(24):
        logits, cache = step(params, tok[:, t:t + 1],
                             torch.full((2,), t, dtype=torch.long), cache)
    torch.testing.assert_close(pre, logits, atol=1e-4, rtol=0)


def test_greedy_generate_matches_reference(arch):
    _, ref_cfg, ref_params, cfg, params = arch
    prompt = _tokens(5, 2, 5, cfg.vocab_size)
    want = ref_serve.greedy_generate(ref_cfg, ref_params, jnp.asarray(prompt), 6)
    got = greedy_generate(cfg, params, prompt, 6)
    assert got.shape == (2, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _run_queue(mod_step, queue, slots, cache, params, as_tensor, argmax):
    while not queue.idle or queue.active:
        queue.admit()
        if not queue.active:
            break
        tok_list, pos_list = [], []
        for s in range(slots):
            req = queue.active.get(s)
            if req is None:
                tok_list.append(0)
                pos_list.append(0)
            else:
                p = req["pos"]
                tok_list.append(req["prompt"][p] if p < len(req["prompt"])
                                else req["generated"][-1])
                pos_list.append(p)
        tokens, positions = as_tensor(tok_list, pos_list)
        logits, cache = mod_step(params, tokens, positions, cache)
        nxt = argmax(logits)
        for s in list(queue.active):
            queue.step_done(s, int(nxt[s]))
    return [(r["id"], r["prompt"], r["generated"]) for r in queue.finished]


def test_batching_queue_with_slot_reuse_matches_reference(arch):
    """examples/serve_decode.py's loop: 4 requests through 2 slots, so
    slots are reused and the one-hot insert adds onto stale entries."""
    _, ref_cfg, ref_params, cfg, params = arch
    slots, max_seq = 2, 16
    reqs = [{"id": i, "prompt": [1 + i, 2 + i, 3 * i], "max_new_tokens": 3 + i}
            for i in range(4)]

    ref_q = ref_serve.BatchingQueue(ref_cfg, batch_slots=slots, max_seq=max_seq)
    q = BatchingQueue(cfg, batch_slots=slots, max_seq=max_seq)
    for r in reqs:
        ref_q.submit(dict(r))
        q.submit(dict(r))
    want = _run_queue(
        jax.jit(ref_serve.make_decode_step(ref_cfg)), ref_q, slots,
        ref_models.init_cache(ref_cfg, slots, max_seq), ref_params,
        lambda t, p: (jnp.asarray(t, jnp.int32)[:, None],
                      jnp.asarray(p, jnp.int32)),
        lambda lg: jnp.argmax(lg[:, -1], axis=-1))
    got = _run_queue(
        make_decode_step(cfg), q, slots,
        init_cache(cfg, slots, max_seq, device="cpu"), params,
        lambda t, p: (torch.tensor(t)[:, None], torch.tensor(p)),
        lambda lg: lg[:, -1].argmax(dim=-1))
    assert len(got) == 4
    assert got == want


def test_chip_smoke_imports_neither_jax_nor_repro():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parents[1] / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(names)
