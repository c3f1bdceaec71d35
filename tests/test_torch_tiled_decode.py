"""The port's ``models.vae.tiled_decode`` against the JAX ``tiled_decode``.

A tiny VAE (``VAE_KW`` of ``test_torch_pipeline``: two levels, so a latent
pixel is 2 × 2 image pixels) with the same weights on both sides, made
with numpy from a seed (``flax_params``, no init compiled; ``vae_from_jax``),
decodes the same latents, made with numpy from a seed, in fp32. Tiles of 8 × 8 latents overlapping by 2 (a step of 6): a latent of 8
fits one tile (the untiled branch), 13 × 13 takes a 2 × 2 grid whose last
row and column are clamped to the edge (origin 5, not 6), 19 × 13 a 3 × 2
grid (rows at 0, 6 and 11, clamped). Also SD3's 16-channel VAE with its
shift, and the config's own ``tiling_size``/``tiling_overlap``. Tolerance:
1e-4 absolute on images of magnitude ~1, the decoder's fp32 differences
between the frameworks (the blend itself is the same sums in the same
order). On the card (``cuda`` marker), the bf16 tiled decode against its
fp32 CPU copy within 0.1 relative L2, as ``chip_smoke.py`` holds the VAE.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.models import AutoencoderKL, sd3_vae_config
from flash_diffusion_tpu_torch.models import AutoencoderKLConfig as TVAEConfig
from flash_diffusion_tpu_torch.models.vae import tiled_decode
from flash_diffusion_tpu_torch.utils import vae_from_jax
from test_torch_adapters import flax_params
from test_torch_pipeline import VAE_KW

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu.models.vae import tiled_decode as jtiled_decode
except ImportError:
    jax = None

torch.set_num_threads(2)

TILE, OVERLAP = (8, 8), (2, 2)
TOL = 1e-4


@pytest.fixture(scope="module")
def vaes():
    """(JAX VAE, its params, the port's VAE with the same weights) for the
    SD VAE and SD3's 16-channel one."""
    if jax is None:
        pytest.skip("needs the JAX reference package")
    out = {}
    for name, jcfg, cfg in (("sd", jm.AutoencoderKLConfig(**VAE_KW), TVAEConfig(**VAE_KW)),
                            ("sd3", jm.sd3_vae_config(**VAE_KW), sd3_vae_config(**VAE_KW))):
        vae = jm.AutoencoderKL(jcfg)
        params = flax_params(vae, 11, jnp.zeros((1, 16, 16, 3)))
        port = AutoencoderKL(cfg)
        port.load_state_dict(vae_from_jax(params, cfg))
        out[name] = (vae, params, port.eval())
    return out


def latents(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("vae_name,shape", [
    ("sd", (2, 8, 8, 4)),  # fits one tile: the untiled decode_latents
    ("sd", (2, 13, 13, 4)),  # 2 × 2 tiles, the last row and column clamped
    ("sd", (1, 19, 13, 4)),  # 3 × 2 tiles, both clamped
    ("sd3", (1, 13, 19, 16)),  # 2 × 3, SD3's 16 channels and shift
])
def test_tiled_decode_matches_jax(vaes, vae_name, shape):
    vae, params, port = vaes[vae_name]
    z = latents(shape, seed=shape[1] * shape[2])
    want = np.asarray(jtiled_decode(vae, params, jnp.asarray(z), TILE, OVERLAP))
    with torch.no_grad():
        got = tiled_decode(port, torch.from_numpy(z), TILE, OVERLAP)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 3) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    if shape[1] <= TILE[0] and shape[2] <= TILE[1]:  # the untiled branch is decode_latents itself
        with torch.no_grad():
            assert torch.equal(got, port.decode_latents(torch.from_numpy(z)))


def test_tiled_decode_reads_the_config_and_blends_with_pyramid_weights(vaes):
    """The config's ``tiling_size``/``tiling_overlap`` (the defaults, 64 and
    8, and the ``downsampling_factor`` 2^(levels − 1), as JAX's), and the
    blend: a decoder that returns each tile's index everywhere shows the
    weights. With the pyramid over the whole tile, a pixel inside the
    overlap of tiles 0 and 1 gets (i0·w0 + i1·w1) / (w0 + w1) with each w
    its distance to its tile's edge, + 1."""
    _, _, port = vaes["sd"]
    assert (port.config.tiling_size, port.config.tiling_overlap, port.config.downsampling_factor) == (
        (64, 64), (8, 8), 2)
    cfg = TVAEConfig(**VAE_KW, tiling_size=(8, 8), tiling_overlap=(2, 2))

    class Index(torch.nn.Module):  # a tile's decode: its stack index, 2× upsampled
        config = cfg

        def decode_latents(self, z):
            return torch.arange(z.shape[0], dtype=torch.float32)[:, None, None, None].expand(
                z.shape[0], 2 * z.shape[1], 2 * z.shape[2], 3)

    out = tiled_decode(Index(), torch.zeros(1, 8, 14, 4))  # 1 × 2 tiles: columns at 0 and 6
    row = out[0, 5, :, 0]
    assert torch.equal(row[:12], torch.zeros(12)) and torch.equal(row[16:], torch.ones(12))
    for p in range(12, 16):  # tile 0 covers pixels 0-15, tile 1 12-27
        w0, w1 = 16 - p, p - 12 + 1
        assert abs(row[p].item() - w1 / (w0 + w1)) < 1e-6
    assert torch.equal(out[0, :, 5, 0], torch.zeros(16))


@pytest.mark.cuda
def test_tiled_decode_on_card_matches_the_cpu_copy():
    """bf16 on the card (the VAE's attention and GroupNorms on the kernels)
    against the same weights in fp32 on the CPU: a 3 × 2 grid with clamped
    tiles, within 0.1 relative L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    torch.manual_seed(0)
    cpu = AutoencoderKL(TVAEConfig(**VAE_KW)).eval()
    card = AutoencoderKL(TVAEConfig(**VAE_KW)).eval()
    card.load_state_dict(cpu.state_dict())
    card = card.to("cuda", torch.bfloat16)
    z = torch.from_numpy(latents((2, 19, 13, 4), 3))
    with torch.no_grad():
        want = tiled_decode(cpu, z, TILE, OVERLAP)
        got = tiled_decode(card, z.cuda(), TILE, OVERLAP).cpu()
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= 0.1
