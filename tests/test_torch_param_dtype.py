"""Weights stored in bf16 (``ModelConfig.param_dtype``), the storage that
lets command-r-35b and llava-next-34b run at their published depth on one
80 GB card, held to the JAX reference and to f32 storage.

At SMOKE widths, for command-r-35b, llava-next-34b and starcoder2-3b:

* (a) the port at ``param_dtype="bfloat16"`` with f32 activations against
  the reference at the same settings, the reference's bf16 tree carried
  across by ``from_reference``: prefill logits at atol 1e-4, with and
  without ``use_flash`` (K2's plain version on the CPU);
* (b) with bf16 activations, the serving dtype, a bf16-stored tree gives
  the logits of the f32-stored tree it was cast from, bitwise, in the
  port and in the reference: every product casts its weight to the
  activation dtype at use, and the cast of a bf16 weight is the weight;
* (c) the port's bf16 init (``dense_init`` draws a leaf one slice of its
  leading axis at a time) gives the shapes, dtypes and bytes of
  ``init_model_shapes``, the same tree twice from one seed, values
  within the truncated normal's bound, and never draws more than one
  slice in f32; at published widths the bf16 trees hold the parameter
  counts the card's serving phases print;
* (d) the f32-stored SMOKE tree of every config still has the digest it
  had before bf16 storage drew by slices: the f32 stream is unchanged.
  The digests are of torch's CPU generator (taken with torch 2.13).
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
from repro_torch import configs
from repro_torch.models import (
    forward,
    from_reference,
    init_model,
    init_model_shapes,
)
from repro_torch.models.params import tree_flatten
from test_torch_train import _randomize_constants

NAMES = ("command_r_35b", "llava_next_34b", "starcoder2_3b")
#: Parameters of the published configs (``init_model_shapes``).
PUBLISHED_PARAMS = {"command_r_35b": 30_283_538_432,
                    "llava_next_34b": 33_930_165_248,
                    "starcoder2_3b": 3_030_371_328}
#: sha256 of each f32-stored SMOKE tree from ``torch.Generator`` seed 0 on
#: the CPU (``_digest``), as the whole-leaf draw gives it.
F32_DIGESTS = {
    "olmo_1b":
        "35cf097ad6a87a758100d4f261767e934b232675694af3f9f761ac6e14f48aa3",
    "command_r_35b":
        "0970825ce20c913a0febd9d97fbe253db4eabb7506320e559959be1ecd80adf3",
    "gemma2_2b":
        "e1b9cbc31cf58d16358a2cf8fa8178f314982acca77006a868af64e169d92b24",
    "starcoder2_3b":
        "6a4e0e6466400d9e97b7f5f2cd895e074adc3b76e7f92dfc806c4e795af7ae0c",
    "llava_next_34b":
        "0970825ce20c913a0febd9d97fbe253db4eabb7506320e559959be1ecd80adf3",
    "rwkv6_1b6":
        "caf89ba336879cfe229c23698e2b7b5b702c0de3bbd51868664f210d951901f0",
    "granite_moe_3b":
        "dddfff41b82583f9798aed9b4208c6378a9ffcb7283afe3827bc4cf2c4c9ce2a",
    "llama4_scout_17b":
        "bbe76393e854bc3d579f8864a428ff9b93b672e3baf35c4c8fd3eca1206dcae0",
    "whisper_base":
        "da13fef94de4dafc834465e52e7fa5648ab9b08411563d59aa3e2f9c44e2d021",
    "zamba2_2b7":
        "1c480181b0917b363a7c682266a5691414eb3739d52ef9478221b77d69f29c46",
}


def _batch(cfg, seed, b=2, s=24):
    """(numpy batch, torch batch): tokens, plus patch embeddings for vlm."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in out.items()}
    tb["tokens"] = tb["tokens"].long()
    return out, tb


def _ref_forward(ref_cfg, tree, batch):
    logits, _ = jax.jit(lambda p, bt: ref_models.forward(ref_cfg, p, bt))(
        jax.tree.map(jnp.asarray, tree), batch)
    return np.asarray(logits.astype(jnp.float32))


def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, leaf in zip(*tree_flatten(tree)):
        h.update(".".join(path).encode())
        h.update(str(leaf.dtype).encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(leaf.detach().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# (a) bf16 storage, f32 activations: the port against the reference
# ---------------------------------------------------------------------------
_BF16: dict = {}


def _bf16_model(name):
    """(port cfg, port params, the reference's f32 logits) of ``name``'s
    SMOKE config at bf16 storage and f32 activations, the reference's tree
    carried across."""
    if name not in _BF16:
        settings = dict(param_dtype="bfloat16", dtype="float32")
        ref_cfg = dataclasses.replace(ref_configs.get_smoke(name), **settings)
        cfg = dataclasses.replace(configs.get_smoke(name), **settings)
        init = jax.jit(lambda k: ref_models.init_model(ref_cfg, k))
        tree = _randomize_constants(
            jax.tree.map(np.asarray, init(jax.random.PRNGKey(4))), 9)
        assert {leaf.dtype for leaf in jax.tree.leaves(tree)} == \
            {np.dtype(jnp.bfloat16)}
        nb, _ = _batch(cfg, 2)
        _BF16[name] = (cfg, from_reference(cfg, tree, "cpu"),
                       _ref_forward(ref_cfg, tree, nb))
    return _BF16[name]


@pytest.mark.parametrize("use_flash", (False, True))
@pytest.mark.parametrize("name", NAMES)
def test_bf16_storage_matches_reference(name, use_flash):
    cfg, params, want = _bf16_model(name)
    assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
    _, tb = _batch(cfg, 2)
    with torch.no_grad():
        got, _ = forward(cfg, params, tb, use_flash=use_flash)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# ---------------------------------------------------------------------------
# (b) bf16 activations: bf16 storage is bitwise f32 storage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_flash", (False, True))
@pytest.mark.parametrize("name", NAMES)
def test_bf16_storage_bitwise_port(name, use_flash):
    cfg32 = configs.get_smoke(name)
    assert (cfg32.dtype, cfg32.param_dtype) == ("bfloat16", "float32")
    cfg16 = dataclasses.replace(cfg32, param_dtype="bfloat16")
    params = init_model(cfg32, torch.Generator().manual_seed(6),
                        device="cpu")
    _, tb = _batch(cfg32, 3)
    with torch.no_grad():
        want, _ = forward(cfg32, params, tb, use_flash=use_flash)
        params.to(torch.bfloat16)  # in place: the same tree, bf16-stored
        assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
        got, _ = forward(cfg16, params, tb, use_flash=use_flash)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_storage_bitwise_reference(name):
    ref32 = ref_configs.get_smoke(name)
    ref16 = dataclasses.replace(ref32, param_dtype="bfloat16")
    tree32 = jax.tree.map(np.asarray, jax.jit(
        lambda k: ref_models.init_model(ref32, k))(jax.random.PRNGKey(5)))
    tree16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), tree32)
    nb, _ = _batch(ref32, 4)
    np.testing.assert_array_equal(_ref_forward(ref16, tree16, nb),
                                  _ref_forward(ref32, tree32, nb))


# ---------------------------------------------------------------------------
# (c) the bf16 init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_bf16_init_shapes_and_stream(name, monkeypatch):
    cfg = dataclasses.replace(configs.get_smoke(name), param_dtype="bfloat16")
    want_paths, want_leaves = tree_flatten(init_model_shapes(cfg))
    draws = []
    trunc_normal = torch.nn.init.trunc_normal_

    def spy(t, *args, **kw):
        draws.append(t.numel())
        return trunc_normal(t, *args, **kw)

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", spy)
    a = init_model(cfg, torch.Generator().manual_seed(7), device="cpu")
    monkeypatch.undo()
    b = init_model(cfg, torch.Generator().manual_seed(7), device="cpu")
    paths, leaves = tree_flatten(a)
    assert paths == want_paths
    assert [(x.shape, x.dtype) for x in leaves] == \
        [(x.shape, x.dtype) for x in want_leaves]
    assert sum(x.numel() * x.element_size() for x in leaves) == \
        sum(x.numel() * x.element_size() for x in want_leaves)
    assert all(torch.equal(x, y) for x, y in zip(leaves, tree_flatten(b)[1]))

    # Each stacked leaf was drawn a layer at a time: no f32 draw is larger
    # than one layer's slice, and its layers are different draws.
    layers = a["layers"]["mlp"]["wi"]
    assert max(draws) == max(x[0].numel() for x in leaves if x.dim() >= 2
                             and x.shape[0] == cfg.num_layers)
    assert not torch.equal(layers[0], layers[1])
    # Truncated at two standard deviations of the fan-in scale.
    bound = 2.0 / cfg.d_model ** 0.5
    assert layers.float().abs().max().item() <= bound * (1 + 2 ** -8)
    assert 0.5 * bound / 2 < layers.float().std().item() < bound / 2


@pytest.mark.parametrize("name", NAMES)
def test_bf16_published_tree_size(name):
    """The published-width bf16 tree (meta, nothing drawn) holds the
    published parameters at two bytes each."""
    cfg = dataclasses.replace(configs.get_config(name),
                              param_dtype="bfloat16")
    leaves = tree_flatten(init_model_shapes(cfg))[1]
    assert {x.dtype for x in leaves} == {torch.bfloat16}
    n = sum(x.numel() for x in leaves)
    assert n == PUBLISHED_PARAMS[name]
    assert sum(x.numel() * x.element_size() for x in leaves) == 2 * n


# ---------------------------------------------------------------------------
# (d) the f32 stream is unchanged
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", configs.ARCHS)
def test_f32_tree_digest_unchanged(name):
    cfg = configs.get_smoke(name)
    assert cfg.param_dtype == "float32"
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert _digest(params) == F32_DIGESTS[name]
