"""The weights-free toy quality proofs of the port against the JAX package, on the CPU.

- the toy ``UNetConfig`` (an ``AttnDownBlock2D`` level, no
  cross-attention, a conditioning of None) through ``unet_from_jax``:
  forward and ``return_features`` against JAX in fp32 (1e-4), at integer
  (DDPM) and float (flow-matching) timesteps;
- the random-CNN features and ``fd`` against JAX's ``_features``/``fd`` on
  the same arrays and the same weights (1e-5 of max|feature|, FD 1e-4
  relative); the port's blobs are in [-1, 1] and vary;
- the port's LayerNorm and GroupNorm in fp32 under ``torch.autocast``;
- a 3-step run of each proof (ε and rectified flow) with finite FDs: the
  whole recipe on the toy UNet, the RF one reading the UNet's own feature
  tap (its mid block) through ``FlashDiffusionSD3``;
- the calibrated runs (600 teacher and 200 distill steps, batch 48,
  n_eval 256, seed 0) held to ``tests/test_toy_quality.py``'s assertions,
  ``slow``-marked: on the card when there is one, else on the CPU.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch import toy_quality, toy_quality_rf
from flash_diffusion_tpu_torch.models import UNet2DCondition, UNetConfig
from flash_diffusion_tpu_torch.utils import unet_from_jax
from test_torch_adapters import close, flax_params

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from examples import toy_quality as jtoy
    from flash_diffusion_tpu import models as jm
except ImportError:
    jax = None

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def test_toy_unet_config_is_jaxs():
    cfg = toy_quality.unet_config()
    assert cfg.down_block_types == ["DownBlock2D", "AttnDownBlock2D"] and cfg.cross_attention_dim is None
    net = UNet2DCondition(cfg)
    block = net.down_blocks[1].attentions[0].transformer_blocks[0]
    assert not hasattr(block, "attn2") and not hasattr(block, "norm2")
    assert not hasattr(net.mid_block.attentions[0].transformer_blocks[0], "attn2")
    assert net.down_blocks[0].attentions is None
    with pytest.raises(ValueError, match="cross_attention_dim"):
        UNetConfig(down_block_types=["CrossAttnDownBlock2D"] * 4, cross_attention_dim=None)


@pytest.mark.parametrize("t", [np.array([3, 999, 500]), np.array([12.5, 977.25, 500.0], np.float32)])
def test_toy_unet_matches_jax(jax_ref, t):
    """Forward and the mid-block features (the GAN's tap) at 1e-4 in fp32."""
    jnet = jm.UNet2DCondition(jm.UNetConfig(**{**jtoy.unet_config().__dict__}))
    params = flax_params(jnet, 0, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)), None)
    port = UNet2DCondition(toy_quality.unet_config())
    port.load_state_dict(unet_from_jax(params, port.config))
    x = np.random.default_rng(1).standard_normal((3, 16, 16, 3)).astype(np.float32)
    want, want_f = jnet.apply(params, jnp.asarray(x), jnp.asarray(t), None, return_features=True)
    with torch.no_grad():
        got, got_f = port(torch.from_numpy(x), torch.from_numpy(t), None, return_features=True)
    assert got_f.shape == (3, 8, 8, 64)
    close(got, want, 1e-4)
    close(got_f, want_f, 1e-4)


def test_random_cnn_fd_matches_jax(jax_ref):
    """JAX's feature weights (HWIO → OIHW) on the same images: features and
    FD equal; the "SAME" stride-2 padding is one row and column after."""
    jparams = jtoy._feature_params(jax.random.PRNGKey(1234))
    params = [torch.from_numpy(np.asarray(w).transpose(3, 2, 0, 1).copy()) for w in jparams]
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (40, 16, 16, 3)).astype(np.float32)
    b = np.tanh(a * 1.3 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
    close(toy_quality.features(params, torch.from_numpy(a)), jtoy._features(jparams, jnp.asarray(a)), 1e-5)
    got = toy_quality.fd(params, torch.from_numpy(a), torch.from_numpy(b))
    want = jtoy.fd(jparams, jnp.asarray(a), jnp.asarray(b))
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


@pytest.mark.parametrize("act", [None, "silu"])
def test_norms_run_in_fp32_under_autocast(act):
    """Under ``torch.autocast`` the port's LayerNorm and GroupNorm take and
    return fp32, as autocast's own normalizations: the toy proofs' norms on
    the card; gradients reach a bf16 input in bf16."""
    from flash_diffusion_tpu_torch.ops import group_norm, layer_norm

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 4, 4, generator=g).to(torch.bfloat16).requires_grad_()
    w, b = 1 + 0.1 * torch.randn(32, generator=g), 0.1 * torch.randn(32, generator=g)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y, z = group_norm(x, 8, w, b, act=act), layer_norm(x.reshape(2, 32, 16), w[:16], b[:16])
    assert y.dtype == z.dtype == torch.float32
    assert torch.equal(y, group_norm(x.float(), 8, w, b, act=act))
    assert torch.equal(z, layer_norm(x.float().reshape(2, 32, 16), w[:16], b[:16]))
    y.sum().backward()
    assert x.grad.dtype == torch.bfloat16


def test_blobs():
    x = toy_quality.make_batch(torch.Generator().manual_seed(0), 8)
    assert x.shape == (8, 16, 16, 3) and x.min() >= -1.0 and x.max() <= 1.0
    assert x.std(dim=0).mean() > 0.05  # the blobs move and change colour
    assert torch.equal(x, toy_quality.make_batch(torch.Generator().manual_seed(0), 8))


@pytest.mark.parametrize("proof", [toy_quality, toy_quality_rf], ids=["eps", "rf"])
def test_toy_proof_runs(proof):
    """3 teacher and 3 distill steps at batch 4 (the RF proof reaches its
    GAN stage), n_eval 16: three finite FDs."""
    out, (model, lora) = proof.run(3, 3, 4, 16, seed=0, device="cpu", verbose=False)
    fds = [out[k] for k in ("fd_teacher_32nfe", "fd_student_4nfe", "fd_undistilled_4nfe")]
    assert np.isfinite(fds).all() and min(fds) >= 0
    assert any(float(ab["b"].abs().max()) > 0 for ab in lora.values())  # the LoRA trained


def _device():
    return "cuda" if torch.cuda.is_available() else "cpu"


@pytest.mark.slow
def test_distilled_student_beats_undistilled_and_matches_teacher():
    """The ε proof at the JAX test's calibrated scale and assertions."""
    out, _ = toy_quality.run(600, 200, 48, 256, seed=0, device=_device(), verbose=False)
    fd_t, fd_s, fd_u = out["fd_teacher_32nfe"], out["fd_student_4nfe"], out["fd_undistilled_4nfe"]
    assert np.isfinite([fd_t, fd_s, fd_u]).all()
    assert fd_s < 0.5 * fd_u, f"student {fd_s:.3f} vs undistilled {fd_u:.3f}"
    assert fd_s < fd_t, f"student {fd_s:.3f} vs teacher {fd_t:.3f}"


@pytest.mark.slow
def test_toy_rf_quality():
    """The rectified-flow proof at the JAX test's calibrated scale and
    assertions."""
    out, _ = toy_quality_rf.run(600, 200, 48, 256, seed=0, device=_device(), verbose=False)
    fd_t, fd_s, fd_u = out["fd_teacher_32nfe"], out["fd_student_4nfe"], out["fd_undistilled_4nfe"]
    assert np.isfinite([fd_t, fd_s, fd_u]).all()
    assert fd_s < 0.6 * fd_u, f"student {fd_s:.3f} vs undistilled {fd_u:.3f}"
    assert fd_s < 3.0 * fd_t, f"student {fd_s:.3f} vs teacher {fd_t:.3f}"
