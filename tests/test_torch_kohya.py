"""The port's conv LoRA pairs and kohya export against the JAX package.

On the fixture of ``tests/test_peft_interop.py`` (a ``to_q`` linear and a
3×3 conv, adapted by the real peft library with random B):

- ``init_lora``'s shapes and scale, dense and conv, against JAX's;
- ``from_peft`` of peft's own state dict equals JAX's tree, ``to_peft`` gives
  JAX's keys and values, ``merge_lora`` gives JAX's merged weights (HWIO →
  OIHW) and peft's ``merge_and_unload``'s;
- ``to_kohya``/``from_kohya`` against JAX's (keys exact, values to 1e-6,
  the alpha), a kohya file written by the port read by JAX's
  ``from_kohya``, the underscore disambiguation and the collision error of
  ``test_peft_interop.py``.

And over the tiny SDXL UNet: ``lora_from_jax``/``lora_to_jax`` for conv
pairs on every resnet, sampler and in/out convolution, and
``FlashPipeline.load_lora`` merging a conv pair.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

from flash_diffusion_tpu_torch.lora import (
    DEFAULT_TARGETS,
    from_kohya,
    from_peft,
    init_lora,
    lora_delta,
    lora_is_dense_only,
    lora_paths,
    merge_lora,
    save_kohya_safetensors,
    to_kohya,
    to_peft,
)
from flash_diffusion_tpu_torch.models import UNet2DCondition, UNetConfig
from flash_diffusion_tpu_torch.utils import lora_from_jax, lora_to_jax
from flash_diffusion_tpu_torch.utils.convert import lora_path_to_port
from test_torch_pipeline import SDXL_UNET_KW, tiny_sdxl_port_pipeline

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu import models as jm
except ImportError:
    jax = None

peft = pytest.importorskip("peft")

RANK, ALPHA = 4, 8
TOL = 1e-6


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


class TinyDenoiser(tnn.Module):
    """diffusers-flavoured names: an attention projection and a 3×3 conv."""

    def __init__(self):
        super().__init__()
        self.to_q = tnn.Linear(8, 8, bias=False)
        self.conv = tnn.Conv2d(4, 8, 3, padding=1, bias=False)


@pytest.fixture(scope="module")
def adapted():
    """peft's LoRA (r 4, alpha 8, random B) over ``TinyDenoiser``: its state
    dict as diffusers publishes a UNet adapter (``unet.`` names), the base
    module and its flax params (HWIO conv kernel)."""
    torch.manual_seed(0)
    cfg = peft.LoraConfig(r=RANK, lora_alpha=ALPHA, target_modules=["to_q", "conv"], init_lora_weights=False)
    model = peft.get_peft_model(TinyDenoiser(), cfg)
    tensors = {f"unet.{k.replace('base_model.model.', '').replace('.default', '')}": v.detach().clone()
               for k, v in peft.get_peft_model_state_dict(model).items()}
    base = model.get_base_model()
    state = {"to_q.weight": base.to_q.base_layer.weight.detach().clone(),
             "conv.weight": base.conv.base_layer.weight.detach().clone()}
    return model, tensors, state


def flax_params(state):
    return {"to_q": {"kernel": jnp.asarray(state["to_q.weight"].numpy().T)},
            "conv": {"kernel": jnp.asarray(state["conv.weight"].numpy().transpose(2, 3, 1, 0))}}


def jax_tree_as_port(tree):
    """A JAX LoRA tree of the fixture ({module: {"kernel": {a, b}}}) keyed as
    the port's ({module: {a, b}})."""
    return {m: {k: torch.from_numpy(np.array(v)) for k, v in sub["kernel"].items()} for m, sub in tree.items()}


def assert_same_tree(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for name in want:
        for k in ("a", "b"):
            assert got[name][k].shape == want[name][k].shape, (name, k)
            np.testing.assert_allclose(got[name][k].numpy(), want[name][k].numpy(), atol=tol, rtol=0,
                                       err_msg=f"{name}.{k}")


def test_init_lora_conv_pairs_match_jax_layouts(jax_ref, adapted):
    """``init_lora`` over a linear and a 3×3 conv: A [in, r] and
    [kh, kw, in, r] with std 1/√fan-in, B [r, out] zero, as JAX's; the tree
    is not dense-only."""
    _, _, state = adapted
    net = TinyDenoiser()
    net.load_state_dict(state)
    got = init_lora(net, RANK, torch.Generator().manual_seed(0), targets=(r"to_q$", r"conv$"))
    want = jlora.init_lora(flax_params(state), RANK, jax.random.PRNGKey(0), targets=(r"to_q/kernel$", r"conv/kernel$"))
    assert lora_paths(net, (r"to_q$", r"conv$")) == sorted(want) == ["conv", "to_q"]
    for name in want:
        for k in ("a", "b"):
            assert tuple(got[name][k].shape) == tuple(want[name]["kernel"][k].shape)
        assert not got[name]["b"].any()
    assert got["conv"]["a"].shape == (3, 3, 4, RANK)
    big = init_lora(tnn.Sequential(tnn.Conv2d(64, 8, 3)), 64, torch.Generator().manual_seed(1), targets=(r"0$",))
    assert abs(big["0"]["a"].std().item() * (9 * 64) ** 0.5 - 1.0) < 0.05
    assert lora_is_dense_only({"to_q": got["to_q"]}) and not lora_is_dense_only(got)


def test_peft_layouts_and_merge_match_jax_and_peft(jax_ref, adapted):
    """peft's state dict through ``from_peft`` equals JAX's ``from_peft``
    tree (conv A [kh, kw, in, r], B [r, out]) and scaling; ``to_peft`` gives
    JAX's keys and values ([r, in, kh, kw], [out, r, 1, 1]) and peft's own;
    ``merge_lora`` gives JAX's merged weights and peft's
    ``merge_and_unload``'s."""
    model, tensors, state = adapted
    lora, scaling = from_peft(tensors, alpha=ALPHA)
    jtree, jscaling = jlora.from_peft({k: v.numpy() for k, v in tensors.items()}, flax_params(state), alpha=ALPHA)
    assert scaling == jscaling == ALPHA / RANK
    assert_same_tree(lora, jax_tree_as_port(jtree))
    back, jback = to_peft(lora), jlora.to_peft(jtree)
    assert back.keys() == jback.keys() == tensors.keys()
    assert back["unet.conv.lora_A.weight"].shape == (RANK, 4, 3, 3)
    assert back["unet.conv.lora_B.weight"].shape == (8, RANK, 1, 1)
    for k in back:
        np.testing.assert_allclose(back[k].numpy(), jback[k], atol=TOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(back[k].numpy(), tensors[k].numpy(), atol=TOL, rtol=0, err_msg=k)
    merged = merge_lora(state, lora, scaling)
    jmerged = jlora.merge_lora(flax_params(state), jtree, jscaling)
    np.testing.assert_allclose(merged["to_q.weight"].numpy(), np.asarray(jmerged["to_q"]["kernel"]).T, atol=TOL)
    np.testing.assert_allclose(merged["conv.weight"].numpy(),
                               np.asarray(jmerged["conv"]["kernel"]).transpose(3, 2, 0, 1), atol=TOL)
    ref = model.merge_and_unload()
    np.testing.assert_allclose(merged["conv.weight"].numpy(), ref.conv.weight.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(merged["to_q.weight"].numpy(), ref.to_q.weight.detach().numpy(), atol=1e-5)
    assert not torch.equal(merged["conv.weight"], state["conv.weight"])


def test_kohya_matches_jax_both_ways(jax_ref, adapted, tmp_path):
    """``to_kohya`` gives JAX's keys exactly (``lora_unet_<module>.lora_down/
    lora_up.weight`` and ``.alpha``) and values; ``from_kohya`` of JAX's
    file gives the tree and scaling back; the port's file, written with
    ``save_kohya_safetensors``, is read by JAX's ``from_kohya`` as the same
    tree; alpha defaults to the rank (scaling 1)."""
    from safetensors.numpy import load_file

    _, tensors, state = adapted
    lora, scaling = from_peft(tensors, alpha=ALPHA)
    jtree, _ = jlora.from_peft({k: v.numpy() for k, v in tensors.items()}, flax_params(state), alpha=ALPHA)
    got, want = to_kohya(lora, alpha=ALPHA), jlora.to_kohya(jtree, alpha=ALPHA)
    assert got.keys() == want.keys()
    assert set(got) == {f"lora_unet_{m}.{leaf}" for m in ("to_q", "conv")
                        for leaf in ("lora_down.weight", "lora_up.weight", "alpha")}
    for k in got:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=TOL, rtol=0, err_msg=k)
    assert got["lora_unet_conv.lora_up.weight"].shape == (8, RANK, 1, 1)
    back, back_scaling = from_kohya({k: torch.as_tensor(np.asarray(v)) for k, v in want.items()}, TinyDenoiser())
    assert back_scaling == scaling
    assert_same_tree(back, lora)
    path = str(tmp_path / "FlashSDXL.safetensors")
    save_kohya_safetensors(path, lora)
    file = load_file(path)
    assert float(file["lora_unet_conv.alpha"]) == RANK
    jback, jscaling = jlora.from_kohya(file, flax_params(state))
    assert jscaling == 1.0
    assert_same_tree(jax_tree_as_port(jback), lora)


def test_kohya_underscore_module_disambiguation_and_collision(jax_ref):
    """kohya flattens "." and "_" alike: ``from_kohya`` resolves
    ``down_blocks_0_to_q`` against the model's module ``down_blocks_0.to_q``
    (as ``test_peft_interop.py:173``), raises ValueError when two modules
    flatten alike (``down.blocks_0.to_q`` and ``down_blocks.0.to_q``, as
    ``:189``) and KeyError on a name no module has."""
    lora = {"down_blocks_0.to_q": {"a": torch.ones(8, 4), "b": torch.ones(4, 8)}}
    kohya = to_kohya(lora)
    assert set(kohya) == set(jlora.to_kohya({"down_blocks_0": {"to_q": {"kernel": {
        "a": jnp.ones((8, 4)), "b": jnp.ones((4, 8))}}}}))
    back, scaling = from_kohya(kohya, ["down_blocks_0.to_q", "other"])
    assert scaling == 1.0 and back["down_blocks_0.to_q"]["a"].shape == (8, 4)
    tensors = {"lora_unet_down_blocks_0_to_q.lora_down.weight": torch.ones(4, 8),
               "lora_unet_down_blocks_0_to_q.lora_up.weight": torch.ones(8, 4)}
    with pytest.raises(ValueError, match="ambiguous kohya flattening"):
        from_kohya(tensors, ["down.blocks_0.to_q", "down_blocks.0.to_q"])
    with pytest.raises(ValueError, match="ambiguous kohya flattening"):
        jlora.from_kohya({k: v.numpy() for k, v in tensors.items()}, {
            "down": {"blocks_0": {"to_q": {"kernel": jnp.zeros((8, 8))}}},
            "down_blocks": {"0": {"to_q": {"kernel": jnp.zeros((8, 8))}}}})
    with pytest.raises(KeyError):
        from_kohya(tensors, ["up_blocks.0.to_q"])


JAX_CONVS = r".*/(conv1|conv2|conv_shortcut|conv|conv_in|conv_out)/kernel$"
PORT_CONVS = r"(.*\.(conv1|conv2|conv_shortcut|conv)|conv_in|conv_out)$"


def test_conv_pairs_map_between_jax_and_port_unet(jax_ref):
    """Over the tiny SDXL UNet, JAX ``lora_paths`` of every resnet, sampler
    and in/out convolution map one to one (``lora_path_to_port``) onto the
    port's conv layers, the transformers' dense targets beside them; a
    seeded JAX tree of those pairs goes through ``lora_from_jax`` (conv A
    [kh, kw, in, r]) and ``lora_to_jax`` back unchanged."""
    net = jm.UNet2DCondition(jm.UNetConfig(**SDXL_UNET_KW))
    cond = {"cond": {"crossattn": jnp.zeros((1, 4, 64)), "vector": jnp.zeros((1, 72))}}
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)), cond)
    targets = (*jlora.DEFAULT_TARGETS, JAX_CONVS)
    paths = jlora.lora_paths(shapes, targets)
    config = UNetConfig(**SDXL_UNET_KW, use_linear_projection=True)
    unet = UNet2DCondition(config)
    port = lora_paths(unet, (*DEFAULT_TARGETS, PORT_CONVS))
    mapped = [lora_path_to_port(p, config) for p in paths]
    assert sorted(mapped) == port and len(set(mapped)) == len(paths)
    assert {"conv_in", "conv_out", "down_blocks.0.downsamplers.0.conv", "up_blocks.0.upsamplers.0.conv",
            "mid_block.resnets.1.conv2", "up_blocks.1.resnets.1.conv1"} <= set(mapped)
    flat = traverse_util.flatten_dict(shapes, sep="/")
    rng = np.random.default_rng(0)
    tree = traverse_util.unflatten_dict({f"{p}/{k}": rng.standard_normal(
        (*flat[p].shape[:-1], 2) if k == "a" else (2, flat[p].shape[-1])).astype(np.float32)
        for p in paths for k in ("a", "b")}, sep="/")
    lora = lora_from_jax(tree, config)
    for name, ab in lora.items():
        w = unet.get_submodule(name).weight
        assert lora_delta(ab["a"], ab["b"], w.shape).shape == w.shape, name
    assert lora["down_blocks.0.resnets.0.conv1"]["a"].shape == (3, 3, 32, 2)
    back = traverse_util.flatten_dict(lora_to_jax(lora, config, paths), sep="/")
    want = traverse_util.flatten_dict(tree, sep="/")
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_pipeline_load_lora_merges_a_conv_pair():
    """``FlashPipeline.load_lora`` of a tree with a conv pair on a resnet's
    3×3 conv beside the dense targets serves W + scaling·Δ on both, in the
    layouts of ``merge_lora`` (OIHW for the conv), and unloads back to the
    base weights."""
    pipe = tiny_sdxl_port_pipeline()
    unet = pipe.denoiser
    conv = "down_blocks.0.resnets.0.conv1"
    lora = init_lora(unet, 2, torch.Generator().manual_seed(0), targets=(r".*\.to_q$", rf"{conv}$"))
    for ab in lora.values():
        ab["b"].normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    base = {k: v.clone() for k, v in unet.state_dict().items()}
    pipe.load_lora(lora, 0.5)
    for name, ab in lora.items():
        w = base[f"{name}.weight"]
        want = (w.float() + 0.5 * lora_delta(ab["a"], ab["b"], w.shape)).to(w.dtype)
        assert torch.equal(unet.get_submodule(name).weight, want), name
    assert unet.get_submodule(conv).weight.shape == (32, 32, 3, 3)
    pipe.unload_lora()
    assert torch.equal(unet.get_submodule(conv).weight, base[f"{conv}.weight"])
