"""The port's remaining model families (moe, vlm, encdec, and the dense
flavours of gemma2 and command-r) against the JAX reference.

The six configs that came with them (granite-moe-3b, llama4-scout-17b,
llava-next-34b, whisper-base, gemma2-2b, command-r-35b) run at their
SMOKE widths in f32.  The reference's parameters from
``repro.models.init_model`` are carried across by ``from_reference``,
after every leaf the reference initialises to a constant (norm scales,
biases) is moved to seeded random values near it in the numpy tree both
packages get; the inputs come from numpy seeds.  Held to the reference:

* the configs (fields, parameter counts, SMOKE and published), ``ARCHS``,
  and the port's own parameter tree (paths and shapes) for each family;
* ``moe_ffn`` alone: output, aux loss, the experts chosen and the kept
  set, for granite's routing (40 experts, top-8), llama4's (top-1 with a
  shared expert), a capacity factor of 0.25 (choices drop) and two
  groups;
* prefill logits with ``use_flash`` False and True (K2's plain version on
  the CPU) at atol 1e-4, for moe, vlm, gemma2 (softcaps, window 8 binding
  at s = 32) and command-r (parallel residual), and whisper's
  ``encdec_forward``, also in bf16 from f32 frame embeddings (the
  reference's dtype promotion, as its unrolled stack has it);
* decode steps (logits and caches) for moe, vlm and whisper;
* ``loss_fn`` and autograd's grads against ``jax.grad`` for granite and
  whisper, at tests/test_torch_train.py's tolerances.

And in the port: a gang runtime under HFSP trains a granite-moe, a
whisper-base and a llama4 SMOKE job (one suspended and restored) to the
states of straight ``make_train_step`` runs, and the standing records of
ROADMAP Queue 3: whisper's decode ignores the audio, a decode step drops
MoE choices past a capacity of 1, and ``torch.topk``'s order on ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.models.moe as ref_moe
import repro.serve as ref_serve
from repro_torch import configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import ClusterSpec, HFSPConfig, HFSPScheduler
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import (
    decode_step,
    forward,
    from_reference,
    init_cache,
    init_model,
    loss_fn,
)
from repro_torch.models.encdec import encdec_cache_specs
from repro_torch.models.moe import moe_ffn, route
from repro_torch.models.params import tree_flatten
from repro_torch.runtime import GangRuntime, MLJob
from repro_torch.serve import make_prefill_step
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    init_train_state,
    make_train_step,
)
from test_torch_train import _randomize_constants

NEW = ("command_r_35b", "gemma2_2b", "granite_moe_3b", "llama4_scout_17b",
       "llava_next_34b", "whisper_base")
#: The decoder-only configs whose prefill and decode are held here.
LMS = ("granite_moe_3b", "llama4_scout_17b", "llava_next_34b", "gemma2_2b",
       "command_r_35b")


def _f32(mod, name, **extra):
    return dataclasses.replace(mod.get_smoke(name), dtype="float32", **extra)


_TREES: dict = {}


def _model(name, **extra):
    """(reference cfg, reference params (jnp), port cfg, port params,
    numpy tree) of ``name``'s f32 SMOKE config."""
    key = (name, tuple(sorted(extra.items())))
    if key not in _TREES:
        ref_cfg, cfg = _f32(ref_configs, name, **extra), _f32(configs, name,
                                                              **extra)
        init = jax.jit(lambda k: ref_models.init_model(ref_cfg, k))
        tree = _randomize_constants(
            jax.tree.map(np.asarray, init(jax.random.PRNGKey(3))), 7)
        _TREES[key] = (ref_cfg, jax.tree.map(jnp.asarray, tree), cfg,
                       from_reference(cfg, tree, "cpu"), tree)
    return _TREES[key]


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batch(cfg, seed, b, s):
    """(numpy batch, torch batch) of s tokens per row, plus the family's
    patch or frame embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frame_embeds"] = rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in out.items()}
    tb["tokens"] = tb["tokens"].long()
    return out, tb


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


# ---------------------------------------------------------------------------
# Configs and parameter trees
# ---------------------------------------------------------------------------
def test_archs_equal_reference():
    assert configs.ARCHS == ref_configs.ARCHS


@pytest.mark.parametrize("name", NEW)
def test_configs_equal_reference(name):
    for getter in ("get_config", "get_smoke"):
        ref = getattr(ref_configs, getter)(name)
        port = getattr(configs, getter)(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.param_count(active_only=True) == \
            ref.param_count(active_only=True)


@pytest.mark.parametrize("name", NEW)
def test_param_tree_matches_reference(name):
    cfg = configs.get_smoke(name)
    ref = jax.eval_shape(lambda k: ref_models.init_model(
        ref_configs.get_smoke(name), k), jax.random.PRNGKey(0))
    got = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(got.to_dict()) == _shapes(ref)
    assert all(p.dtype == torch.float32 for p in got.parameters())


def test_encdec_cache_matches_reference():
    cfg = configs.get_smoke("whisper_base")
    want = jax.eval_shape(lambda: ref_models.init_cache(
        ref_configs.get_smoke("whisper_base"), 3, 10))
    for got in (init_cache(cfg, 3, 10, device="cpu"),
                encdec_cache_specs(cfg, 3, 10)):
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


# ---------------------------------------------------------------------------
# The MoE layer alone
# ---------------------------------------------------------------------------
class _VmapSpy:
    """Stands in for ``jax`` in ``repro.models.moe``: records the inputs of
    every ``jax.vmap``-ed call (the first is the dispatch scatter, of
    (flat_e, safe_pos, contrib))."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kw):
        mapped = jax.vmap(fn, *args, **kw)

        def run(*xs):
            self.calls.append([np.asarray(x) for x in xs])
            return mapped(*xs)

        return run


#: (case, SMOKE config, overrides, (b, s)).
MOE_CASES = (
    ("granite-top8", "granite_moe_3b", dict(num_experts=40, top_k=8), (2, 24)),
    ("llama4-top1-shared", "llama4_scout_17b", {}, (2, 24)),
    ("granite-cf0.25", "granite_moe_3b",
     dict(num_experts=8, top_k=2, capacity_factor=0.25), (2, 24)),
    ("granite-groups2", "granite_moe_3b", dict(top_k=2, moe_groups=2),
     (2, 24)),
)


def _moe_inputs(name, extra, seed):
    ref_cfg, cfg = _f32(ref_configs, name, **extra), _f32(configs, name,
                                                          **extra)
    tree = jax.tree.map(np.asarray, ref_moe.init_moe(
        ref_cfg, jax.random.PRNGKey(seed)))
    return ref_cfg, cfg, tree, from_reference(cfg, tree, "cpu")


def _ref_moe(monkeypatch, ref_cfg, tree, x):
    """The reference's (out, aux) and its (flat_e, keep) from the
    dispatch's inputs."""
    spy = _VmapSpy()
    monkeypatch.setattr(ref_moe, "jax", spy)
    out, aux = ref_moe.moe_ffn(ref_cfg, jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x))
    monkeypatch.undo()
    flat_e, _, contrib = spy.calls[0]
    return np.asarray(out), float(aux), flat_e, np.any(contrib != 0, axis=-1)


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_ffn_matches_reference(monkeypatch, case):
    _, name, extra, (b, s) = case
    ref_cfg, cfg, tree, params = _moe_inputs(name, extra, 5)
    x = np.random.default_rng(6).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    want, want_aux, want_e, want_keep = _ref_moe(monkeypatch, ref_cfg, tree,
                                                 x)
    xt = torch.from_numpy(x)
    r = route(cfg, params, xt)
    got, aux = moe_ffn(cfg, params, xt)
    np.testing.assert_array_equal(
        r.idx.reshape(r.groups, -1).numpy(), want_e)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert float(aux) == pytest.approx(want_aux, abs=1e-6)
    assert r.groups == cfg.moe_groups
    if cfg.capacity_factor < 1:
        assert 0 < int((~r.keep).sum()) < r.keep.numel()


def test_moe_group_axis_needs_a_mesh():
    _, cfg, _, params = _moe_inputs("granite_moe_3b", {}, 5)
    cfg = dataclasses.replace(cfg, moe_group_axis=("data",))
    with pytest.raises(RuntimeError, match="there is no mesh"):
        moe_ffn(cfg, params, torch.zeros(1, 4, cfg.d_model))


# ---------------------------------------------------------------------------
# Prefill and decode of the decoder-only configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", LMS)
def test_prefill_logits_match_reference(name, use_flash):
    ref_cfg, ref_params, cfg, params, _ = _model(name)
    nb, tb = _batch(cfg, 1, 2, 32)
    want, want_aux = jax.jit(lambda p, bt: ref_models.forward(
        ref_cfg, p, bt))(ref_params, nb)
    got, aux = forward(cfg, params, tb, use_flash=use_flash)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-5)
    if cfg.family == "moe":
        assert float(aux) > 0
    last = make_prefill_step(cfg, use_flash=use_flash, last_token_only=True)(
        params, tb)
    torch.testing.assert_close(last, got[:, -1:], atol=1e-6, rtol=1e-6)


def test_gemma2_window_binds():
    """At s = 32 the local layers' window of 8 changes the logits."""
    _, _, cfg, params, _ = _model("gemma2_2b")
    _, tb = _batch(cfg, 1, 2, 32)
    wide = dataclasses.replace(cfg, sliding_window=64)
    got, _ = forward(cfg, params, tb)
    full, _ = forward(wide, params, tb)
    assert not torch.allclose(got[:, 8:], full[:, 8:], atol=1e-3)
    torch.testing.assert_close(got[:, :8], full[:, :8], atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ("granite_moe_3b", "llama4_scout_17b",
                                  "llava_next_34b"))
def test_decode_steps_match_reference(name):
    ref_cfg, ref_params, cfg, params, _ = _model(name)
    b, max_seq, steps = 2, 10, 3
    tok = _tokens(3, b, steps, cfg.vocab_size)
    ref_cache = ref_models.init_cache(ref_cfg, b, max_seq)
    cache = init_cache(cfg, b, max_seq, device="cpu")
    ref_step = jax.jit(ref_serve.make_decode_step(ref_cfg))
    for t in range(steps):
        pos = np.array([t, t + 3], np.int32)
        want, ref_cache = ref_step(ref_params, tok[:, t:t + 1], pos,
                                   ref_cache)
        with torch.no_grad():
            got, cache = decode_step(cfg, params,
                                     torch.from_numpy(tok[:, t:t + 1]).long(),
                                     torch.from_numpy(pos).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), atol=1e-4)


# ---------------------------------------------------------------------------
# whisper (encdec)
# ---------------------------------------------------------------------------
def test_encdec_forward_matches_reference():
    ref_cfg, ref_params, cfg, params, _ = _model("whisper_base")
    nb, tb = _batch(cfg, 2, 2, 12)
    want, _ = jax.jit(lambda p, bt: ref_models.forward(ref_cfg, p, bt))(
        ref_params, nb)
    with torch.no_grad():
        got, aux = forward(cfg, params, tb, use_flash=True)
        last, _ = forward(cfg, params, tb, unembed_last_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(aux) == 0.0
    torch.testing.assert_close(last, got[:, -1:], atol=1e-6, rtol=1e-6)


def test_encdec_tiles_decoder_positions():
    """A decoder prefill past the 4096 learned positions reuses them, as
    the reference tiles its table (a table of 8 rows here)."""
    ref_cfg, ref_params, cfg, params, tree = _model("whisper_base")
    nb, tb = _batch(cfg, 2, 1, 12)
    short = {**tree, "dec_pos": tree["dec_pos"][:8]}
    want, _ = ref_models.forward(ref_cfg, jax.tree.map(jnp.asarray, short),
                                 nb)
    with torch.no_grad():
        got, _ = forward(cfg, from_reference(cfg, short, "cpu"), tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_encdec_bf16_promotion_matches_reference():
    """bf16 activations with f32 frame embeddings (SyntheticLM's): the
    encoder runs in f32 and the decoder turns f32 at its first
    cross-attention, as in the reference's unrolled stack
    (``scan_layers=False``).  The reference's scanned decoder refuses
    these inputs (its carry would change dtype), a standing record of
    ROADMAP Queue 3; the port runs them as the unrolled stack does."""
    ref_cfg, ref_params, cfg, params, _ = _model("whisper_base")
    ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    nb, tb = _batch(cfg, 4, 2, 12)
    with pytest.raises(TypeError, match="carry"):
        ref_models.forward(ref_cfg, ref_params, nb)
    ref_cfg = dataclasses.replace(ref_cfg, scan_layers=False)
    want, _ = jax.jit(lambda p, bt: ref_models.forward(ref_cfg, p, bt))(
        ref_params, nb)
    with torch.no_grad():
        got, _ = forward(cfg, params, tb)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-2 * np.abs(want).max())


def test_encdec_decode_matches_reference():
    ref_cfg, ref_params, cfg, params, _ = _model("whisper_base")
    b, max_seq = 2, 8
    tok = _tokens(5, b, 3, cfg.vocab_size)
    ref_cache = ref_models.init_cache(ref_cfg, b, max_seq)
    cache = init_cache(cfg, b, max_seq, device="cpu")
    ref_step = jax.jit(ref_serve.make_decode_step(ref_cfg))
    for t in range(3):
        pos = np.array([t, t + 2], np.int32)
        want, ref_cache = ref_step(ref_params, tok[:, t:t + 1], pos,
                                   ref_cache)
        with torch.no_grad():
            got, cache = decode_step(cfg, params,
                                     torch.from_numpy(tok[:, t:t + 1]).long(),
                                     torch.from_numpy(pos).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for key in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), atol=1e-4)


# ---------------------------------------------------------------------------
# Loss and grads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ("granite_moe_3b", "whisper_base"))
def test_loss_and_grads_match_reference(name):
    ref_cfg, ref_params, cfg, _, tree = _model(name)
    batch = SyntheticLM(cfg, DataConfig(seq_len=24, global_batch=4)).batch(0)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_models.loss_fn(ref_cfg, p, jax.tree.map(
            jnp.asarray, batch)), has_aux=True))(ref_params)
    params = from_reference(cfg, tree, "cpu").requires_grad_(True)
    total, metrics = loss_fn(cfg, params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    assert set(metrics) == set(want_m) == {"loss", "ce", "aux"}
    for k in metrics:
        assert float(metrics[k].detach()) == pytest.approx(
            float(want_m[k]), abs=1e-5)
    if cfg.family == "moe":
        assert float(metrics["aux"].detach()) > 0
    paths, leaves = tree_flatten(params)
    grads = torch.autograd.grad(total, leaves)
    for path, g, w in zip(paths, grads, jax.tree.leaves(want_g), strict=True):
        w = np.asarray(w)
        # tests/test_torch_train.py's bound: atol 1e-5, and no less than
        # 2e-5 of the leaf's largest grad (the f32 floor of a long sum).
        atol = max(1e-5, 2e-5 * float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=atol,
                                   err_msg=".".join(path))


# ---------------------------------------------------------------------------
# The gang runtime
# ---------------------------------------------------------------------------
def test_gang_trains_moe_and_encdec_jobs(tmp_path):
    """HFSP on one machine with two map slots (a granted quantum waits in
    its slot until the next pass, so a later arrival can make HFSP suspend
    it): each job's final state equals the same steps run straight."""
    cluster = ClusterSpec(num_machines=1, map_slots_per_machine=2,
                          reduce_slots_per_machine=0)
    jobs = [MLJob(i, _f32(configs, name), total_steps=steps,
                  steps_per_quantum=2, arrival_time=0.02 * i, seq_len=16,
                  global_batch=4, seed=i, name=name)
            for i, (name, steps) in enumerate((
                ("granite_moe_3b", 8), ("whisper_base", 4),
                ("llama4_scout_17b", 2)))]
    sch = HFSPScheduler(cluster, HFSPConfig(sample_set_size=1,
                                            vc_backend="torch",
                                            vc_device="cpu"))
    rtm = GangRuntime(cluster, sch, jobs, CheckpointStore(str(tmp_path)),
                      device="cpu")
    rep = rtm.run(max_wall_s=300)
    assert sorted(rep["sojourn"]) == [0, 1, 2]
    assert rep["stats"]["offloads"] >= 1 and rep["stats"]["restores"] >= 1
    for job in jobs:
        step = make_train_step(job.cfg, OptimizerConfig(
            warmup_steps=5, total_steps=job.total_steps),
            TrainConfig(remat="none"))
        state = init_train_state(job.cfg,
                                 torch.Generator().manual_seed(job.seed),
                                 "cpu")
        data = SyntheticLM(job.cfg, DataConfig(seq_len=job.seq_len,
                                               global_batch=job.global_batch,
                                               seed=job.seed))
        for s in range(job.total_steps):
            state, _ = step(state, {k: torch.from_numpy(v)
                                    for k, v in data.batch(s).items()})
        got = rtm.rt[job.job_id].state
        for a, b in zip(tree_flatten(got)[1], tree_flatten(state)[1],
                        strict=True):
            assert torch.equal(a, b), job.name


# ---------------------------------------------------------------------------
# Standing records (ROADMAP Queue 3)
# ---------------------------------------------------------------------------
def test_whisper_decode_ignores_the_audio():
    """(a) Nothing fills the cross K/V, in either package: decode attends
    to zeros, so its logits are the same whatever the frames, while the
    prefill's depend on them."""
    ref_cfg, ref_params, cfg, params, _ = _model("whisper_base")
    _, tb = _batch(cfg, 6, 2, 4)
    _, other = _batch(cfg, 7, 2, 4)
    with torch.no_grad():
        a, _ = forward(cfg, params, tb)
        b, _ = forward(cfg, params, {**tb,
                                     "frame_embeds": other["frame_embeds"]})
    assert not torch.allclose(a, b, atol=1e-3)
    cache = init_cache(cfg, 2, 4, device="cpu")
    ref_cache = ref_models.init_cache(ref_cfg, 2, 4)
    for t in range(4):
        pos = np.full((2,), t, np.int32)
        tok = tb["tokens"][:, t:t + 1]
        with torch.no_grad():
            logits, cache = decode_step(cfg, params, tok,
                                        torch.from_numpy(pos).long(), cache)
        _, ref_cache = ref_models.decode_step(
            ref_cfg, ref_params, jnp.asarray(tok.numpy()), pos, ref_cache)
    for key in ("xk", "xv"):
        assert not cache[key].any()
        assert not np.asarray(ref_cache[key]).any()
    assert not torch.allclose(logits, a[:, -1:], atol=1e-3)
    assert not torch.allclose(logits, b[:, -1:], atol=1e-3)


def test_decode_step_drops_moe_choices(monkeypatch):
    """(b) A decode step of b = 4 tokens with granite's routing (40
    experts, top-8, capacity factor 1.25) gets capacity ceil(4 * 8 / 40 *
    1.25) = 1 per expert: a choice survives only as the first to its
    expert, so the kept count is the number of distinct experts among the
    32 choices, and the rest drop, in both packages."""
    ref_cfg, cfg, tree, params = _moe_inputs(
        "granite_moe_3b", dict(num_experts=40, top_k=8), 8)
    x = np.random.default_rng(9).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32)
    _, _, _, want_keep = _ref_moe(monkeypatch, ref_cfg, tree, x)
    r = route(cfg, params, torch.from_numpy(x))
    assert r.capacity == 1
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    kept = int(r.keep.sum())
    # One choice per expert chosen: the kept count is the number of
    # distinct experts among the 32 choices.
    assert kept == len(set(r.idx.flatten().tolist())) < 32


def test_top_k_ties_follow_lax_top_k(monkeypatch):
    """(c) A zero router gives every expert probability 1/E.  jax.lax.top_k
    takes experts 0..k-1; torch.topk on the CPU took others (for E = 40,
    k = 8: [25, 29, 28, 27, 26, 23, 21, 22] with torch 2.x), so the port
    takes the top k by a stable sort and picks what the reference picks."""
    ref_cfg, cfg, tree, params = _moe_inputs(
        "granite_moe_3b", dict(num_experts=40, top_k=8), 8)
    tree = {**tree, "router": np.zeros_like(tree["router"])}
    params = from_reference(cfg, tree, "cpu")
    x = np.random.default_rng(10).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    want, _, want_e, want_keep = _ref_moe(monkeypatch, ref_cfg, tree, x)
    r = route(cfg, params, torch.from_numpy(x))
    assert (want_e.reshape(6, 8) == np.arange(8)).all()
    np.testing.assert_array_equal(r.idx.reshape(1, -1).numpy(), want_e)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    got, _ = moe_ffn(cfg, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
