"""The port's training path (repro_torch.train, models.loss_fn and
common.cross_entropy, remat) against the JAX reference (repro.train,
repro.models).

The olmo_1b, rwkv6_1b6 and zamba2_2b7 SMOKE configs run in f32.  The
reference's parameters from ``repro.models.init_model`` are carried across
by ``from_reference``, after every leaf the reference initialises to a
constant (norm scales, biases, rwkv6's ``mu`` and ``bonus_u``, zamba2's
``A_log``, ``dt_bias``, ``D``, conv biases and ``norm_scale``) is moved to
seeded random values near it in the numpy tree both packages get, so
those terms' gradients are held too.  Batches are ``SyntheticLM``'s (the
same in both packages, tests/test_torch_substrates.py), 4 x 72 tokens:
two scan chunks of 64, the second ragged.  Held to the reference:

* ``lr_at`` at every step 0..120 of each schedule, to 1e-7;
* ``clip_by_global_norm``, ``compress_int8``/``decompress_int8`` and
  ``adamw_update`` on a tree of decayed and non-decayed names, to 1e-6;
* ``cross_entropy`` and ``loss_fn``, to 1e-5;
* autograd's grads against ``jax.grad`` of the reference's loss, rtol
  1e-4 and atol 1e-5 (or 2e-5 of the leaf's largest grad, if more: see
  the test);
* ``make_train_step`` for 3 steps with remat ``none`` and ``block``,
  ``microbatches=2`` and ``grad_compression="int8"``: params, m and v
  within 1e-4 (with int8, 1% of a leaf, or one element, may land a
  quantization bucket away: see the test).

And in the port alone: a step leaves its input state bitwise as it was,
a state it returns is freed as soon as it is dropped (no reference
cycle),
``TrainConfig(use_flash=True)`` is refused, the kernel wrappers refuse
inputs that require grad, and a bf16 run's loss falls over 8 steps on a
fixed batch (tests/test_models_smoke.py's check of the reference).
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.train as ref_train
from repro.models.common import cross_entropy as ref_cross_entropy
from repro.train import optimizer as ref_opt
from repro_torch import KernelInputError, configs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import from_reference, loss_fn
from repro_torch.models.common import cross_entropy
from repro_torch.models.params import tree_flatten
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    init_opt_state,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from repro_torch.train import optimizer as opt

ARCHS = ("olmo_1b", "rwkv6_1b6", "zamba2_2b7")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _f32(mod, name):
    return dataclasses.replace(mod.get_smoke(name), dtype="float32")


def _randomize_constants(tree, seed):
    """Seeded random values near each constant leaf, in the numpy tree."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif v.size and np.all(v == v.flat[0]):
                node[k] = (v + 0.1 * rng.standard_normal(v.shape)
                           ).astype(v.dtype)

    walk(tree)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, reference cfg, reference params (jnp), port cfg, numpy tree,
    batch (numpy))."""
    name = request.param
    ref_cfg, cfg = _f32(ref_configs, name), _f32(configs, name)
    init = jax.jit(lambda key: ref_models.init_model(ref_cfg, key))
    tree = _randomize_constants(jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(0))), 5)
    batch = SyntheticLM(cfg, DataConfig(seq_len=72, global_batch=4)).batch(0)
    return name, ref_cfg, jax.tree.map(jnp.asarray, tree), cfg, tree, batch


def _port_state(cfg, tree):
    params = from_reference(cfg, tree, "cpu").requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got_tree, want_tree, atol, what="", flips=0.0):
    """Every leaf within ``atol``; with ``flips``, that share of each
    leaf's elements (at least one) may lie outside it, within 100 x
    ``atol``."""
    paths, got = tree_flatten(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want), what
    for path, g, w in zip(paths, got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        name = f"{what} {'.'.join(path)}"
        if not flips:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)
            continue
        off = np.abs(g - w) > atol
        assert off.sum() <= max(1.0, flips * off.size), (name, off.sum())
        np.testing.assert_allclose(g, w, atol=100 * atol, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Optimizer pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ("cosine", "linear", "constant"))
def test_lr_at_every_step(schedule):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule)
    cfg, ref_cfg = OptimizerConfig(**kw), ref_opt.OptimizerConfig(**kw)
    steps = np.arange(121, dtype=np.int32)
    got = np.array([float(opt.lr_at(cfg, torch.tensor(s))) for s in steps])
    want = np.asarray(jax.vmap(lambda s: ref_opt.lr_at(ref_cfg, s))(steps))
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    assert got[10] == pytest.approx(1.0)


def _opt_tree(seed):
    """Decayed and non-decayed names, nested as a model's tree nests."""
    rng = np.random.default_rng(seed)

    def a(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    return {"embed": {"embedding": a(16, 8)},
            "layers": {"attn": {"wq": a(2, 8, 4), "bq": a(2, 4)},
                       "ln1": {"scale": a(2, 8), "bias": a(2, 8)},
                       "tmix": {"mu": a(2, 5, 8), "bonus_u": a(2, 4, 2),
                                "wd_bias": a(2, 8), "ln_x_scale": a(2, 8)},
                       "ssd": {"A_log": a(2, 4), "D": a(2, 4),
                               "dt_bias": a(2, 4), "norm_scale": a(2, 8),
                               "wz": a(2, 8, 8)}}}


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_clip_and_int8_match_reference():
    g = jax.tree.map(lambda x: 3 * x, _opt_tree(1))
    got, gnorm = opt.clip_by_global_norm(_torch_tree(g), 1.0)
    want, want_norm = ref_opt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    assert float(gnorm) == pytest.approx(float(want_norm), rel=1e-6)
    _close(got, want, 1e-6, "clip")
    for leaf in jax.tree.leaves(g):
        q, scale = opt.compress_int8(torch.from_numpy(leaf))
        rq, rscale = ref_opt.compress_int8(jnp.asarray(leaf))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(scale) == pytest.approx(float(rscale), rel=1e-6)
        np.testing.assert_allclose(
            opt.decompress_int8(q, scale).numpy(),
            np.asarray(ref_opt.decompress_int8(rq, rscale)), atol=1e-6)


def test_adamw_update_matches_reference_and_is_pure():
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1,
              grad_clip=0.5)
    cfg, ref_cfg = OptimizerConfig(**kw), ref_opt.OptimizerConfig(**kw)
    params, ref_params = _torch_tree(_opt_tree(2)), jax.tree.map(
        jnp.asarray, _opt_tree(2))
    state, ref_state = opt.init_opt_state(params), ref_opt.init_opt_state(
        ref_params)
    for i in range(3):
        g = _opt_tree(10 + i)
        before = [x.clone() for x in tree_flatten(params)[1]
                  + tree_flatten(state)[1]]
        new_p, new_s, m = opt.adamw_update(cfg, params, _torch_tree(g), state)
        after = tree_flatten(params)[1] + tree_flatten(state)[1]
        assert all(torch.equal(x, y) for x, y in zip(before, after))
        ref_params, ref_state, rm = ref_opt.adamw_update(
            ref_cfg, ref_params, jax.tree.map(jnp.asarray, g), ref_state)
        params, state = new_p, new_s
        _close(params, ref_params, 1e-6, f"params {i}")
        _close(state["m"], ref_state["m"], 1e-6, f"m {i}")
        _close(state["v"], ref_state["v"], 1e-6, f"v {i}")
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
        assert state["step"].dtype == torch.int32
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), abs=1e-9)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                      rel=1e-6)
    # Norms, biases, decays and bonus terms are not decayed ("bq" is, as
    # in the reference: the rule reads the name, not the role).
    decayed = {p[-1] for p in tree_flatten(params)[0] if opt._is_decayed(p)}
    assert decayed == {"embedding", "wq", "bq", "wz"}


# ---------------------------------------------------------------------------
# Loss and grads
# ---------------------------------------------------------------------------
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), abs=1e-5)


def test_loss_and_grads_match_reference(arch):
    _, ref_cfg, ref_params, cfg, tree, batch = arch
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_models.loss_fn(ref_cfg, p, jax.tree.map(
            jnp.asarray, batch)), has_aux=True))(ref_params)
    params = from_reference(cfg, tree, "cpu").requires_grad_(True)
    total, metrics = loss_fn(cfg, params, _tb(batch))
    assert set(metrics) == set(want_m) == {"loss", "ce", "aux"}
    for k in metrics:
        assert float(metrics[k].detach()) == pytest.approx(float(want_m[k]), abs=1e-5)
    paths, leaves = tree_flatten(params)
    grads = torch.autograd.grad(total, leaves)
    for path, g, w in zip(paths, grads, jax.tree.leaves(want_g)):
        w = np.asarray(w)
        # atol 1e-5, and no less than 2e-5 of the leaf's largest grad: the
        # f32 floor of a long accumulation.  rwkv6's embedding grad (max
        # 1.41) lies 8.6e-6 from an f64 computation of the same loss in
        # the reference and 1.7e-5 in the port (the same math in another
        # order); every other leaf agrees to ~1e-6.
        atol = max(1e-5, 2e-5 * float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=atol,
                                   err_msg=".".join(path))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
#: (port remat, microbatches, grad compression): the reference runs once
#: per (microbatches, compression); its remat does not change the math,
#: so both of the port's are held to the same run.
STEP_CASES = (("none", 1, None), ("block", 1, None), ("block", 2, None),
              ("block", 1, "int8"))


@pytest.fixture(scope="module")
def ref_runs(arch):
    """The reference's 3 steps per (microbatches, compression)."""
    _, ref_cfg, ref_params, _, _, batch = arch
    out = {}
    for mb, comp in {(mb, comp) for _, mb, comp in STEP_CASES}:
        step = jax.jit(ref_train.make_train_step(
            ref_cfg, ref_opt.OptimizerConfig(**OPT, grad_compression=comp),
            ref_train.TrainConfig(remat="none", microbatches=mb)))
        state = {"params": ref_params,
                 "opt": ref_opt.init_opt_state(ref_params)}
        for _ in range(3):
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
        out[mb, comp] = (state, metrics)
    return out


@pytest.mark.parametrize("remat,mb,comp", STEP_CASES)
def test_train_step_matches_reference(arch, ref_runs, remat, mb, comp):
    _, _, _, cfg, tree, batch = arch
    step = make_train_step(cfg, OptimizerConfig(**OPT, grad_compression=comp),
                           TrainConfig(remat=remat, microbatches=mb))
    state = _port_state(cfg, tree)
    for _ in range(3):
        state, metrics = step(state, _tb(batch))
    want, want_m = ref_runs[mb, comp]
    # int8: a grad that lies within f32 noise of a rounding boundary of
    # its quantization lands in the neighbouring bucket in one package and
    # not in the other, a step of max|g| / 127 in that element, and the
    # next steps' grads move with it; 1% of a leaf's elements (at least
    # one) may differ so.  Without the int8 round trip most elements of
    # every leaf would differ.
    flips = 1e-2 if comp == "int8" else 0.0
    _close(state["params"], want["params"], 1e-4, "params", flips)
    _close(state["opt"]["m"], want["opt"]["m"], 1e-4, "m", flips)
    _close(state["opt"]["v"], want["opt"]["v"], 1e-4, "v", flips)
    assert int(state["opt"]["step"]) == 3
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert float(metrics[k]) == pytest.approx(float(want_m[k]), rel=1e-4)


def test_train_step_leaves_its_input_state_as_it_was(arch):
    _, _, _, cfg, tree, batch = arch
    step = make_train_step(cfg, OptimizerConfig(**OPT), TrainConfig())
    state = _port_state(cfg, tree)
    state, _ = step(state, _tb(batch))  # non-zero moments
    before = [x.detach().clone() for x in tree_flatten(state)[1]]
    new, _ = step(state, _tb(batch))
    after = tree_flatten(state)[1]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert not any(torch.equal(x, y) for x, y in zip(
        tree_flatten(new["params"])[1], tree_flatten(state["params"])[1]))
    assert all(p.requires_grad for p in new["params"].parameters())
    assert all(p.grad is None for p in state["params"].parameters())


def test_a_dropped_state_is_freed_without_garbage_collection(arch):
    """No reference cycle holds a state: the runtime's EAGER offload
    frees the device memory under it as soon as it drops the state."""
    _, _, _, cfg, tree, batch = arch
    step = make_train_step(cfg, OptimizerConfig(**OPT), TrainConfig())
    gc.disable()
    try:
        state, _ = step(_port_state(cfg, tree), _tb(batch))
        refs = [weakref.ref(x) for x in tree_flatten(state)[1]]
        state = None
        assert not any(r() is not None for r in refs)
    finally:
        gc.enable()


def test_train_step_refuses_flash():
    cfg = _f32(configs, "olmo_1b")
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, OptimizerConfig(), TrainConfig(use_flash=True))


def test_eval_step_takes_flash_without_grad(arch):
    _, ref_cfg, ref_params, cfg, tree, batch = arch
    params = from_reference(cfg, tree, "cpu").requires_grad_(True)
    want = ref_models.loss_fn(ref_cfg, ref_params,
                              jax.tree.map(jnp.asarray, batch))[1]
    for flash in (False, True):
        got = make_eval_step(cfg, TrainConfig(use_flash=flash))(
            params, _tb(batch))
        assert not got["loss"].requires_grad
        assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                                   abs=1e-5)


@pytest.mark.parametrize("kernel", ("flash_attention", "rwkv6", "ssd"))
def test_kernel_wrappers_refuse_grad(kernel):
    """The check comes before any other, so it shows on CPU tensors."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda
    from repro_torch.kernels.ssd.kernel import ssd_cuda

    x = torch.zeros(1, 2, 16, 16, requires_grad=True)
    s = torch.zeros(1, 2, 16, 16)
    call = {"flash_attention": lambda: flash_attention_cuda(x, x, x,
                                                            scale=0.25),
            "rwkv6": lambda: rwkv6_cuda(x, x, x, x, s[0, :, 0], s),
            "ssd": lambda: ssd_cuda(x, s[..., 0], s[..., 0], x, x, s)}[kernel]
    with pytest.raises(KernelInputError, match="no backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        call()  # past the check: the device's


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_loss_decreases_on_a_fixed_batch(name):
    cfg = configs.get_smoke(name)
    assert cfg.dtype == "bfloat16"
    step = make_train_step(cfg, OptimizerConfig(**OPT), TrainConfig())
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _tb(SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=2))
                .batch(0))
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]
