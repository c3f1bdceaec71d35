"""Weights-free end-to-end quality proof of the distillation recipe (PyTorch port).

    python -m flash_diffusion_tpu_torch.toy_quality [--teacher-steps N] [--distill-steps N] [--device cpu]

The port of ``examples/toy_quality.py``, with no external checkpoint:

1. trains a small ε-prediction DDPM **teacher** from scratch on synthetic
   images (coloured Gaussian blobs at random positions, 16², drawn from a
   ``torch.Generator``),
2. **distills** it with the port's ``FlashDiffusion``: K = 4 teacher
   rollout, DMD and the hinge GAN on the teacher's mid-block features (a
   1-stage discriminator), a rank-8 LoRA student,
3. reports the Fréchet distance (``eval.frechet_distance``) in the
   features of a fixed random CNN between held-out data and (a) the
   teacher's 32-step samples, (b) the student's 4-NFE samples, (c) the
   undistilled student (a zero LoRA: the base at 4 NFE), pixel-space
   samples (``decode=False``).

"Distillation works" == FD(student 4-NFE) far below FD(undistilled 4-NFE)
and near FD(teacher 32-step), at 8× fewer NFEs. The UNet has an
``AttnDownBlock2D`` level and no cross-attention: its attention (2 heads
of D = 32 over 8² tokens) runs the flash kernels forward and backward on
the card, its LayerNorms and GroupNorms (8 groups) the norm kernels. On
the card the UNet runs under bf16 autocast (fp32 master weights, bf16
activations: the attention kernels take bf16; the norms in fp32, as
autocast runs normalizations); on the CPU in fp32.
Prints one JSON line per metric.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .distill import FlashDiffusion, FlashDiffusionConfig
from .distill.discriminator import ConvDiscriminator, DiscriminatorConfig
from .eval.metrics import frechet_distance
from .lora import init_lora, lora_scaling
from .models import UNet2DCondition, UNetConfig
from .schedulers import SchedulerConfig, training_tables

SIZE = 16  # image side
C = 3
PALETTE = ((1.0, 0.2, 0.2), (0.2, 1.0, 0.3), (0.25, 0.4, 1.0), (1.0, 0.9, 0.2))
LORA_RANK = 8

# ---------------------------------------------------------------- data


def make_batch(generator: torch.Generator, n: int) -> torch.Tensor:
    """Coloured Gaussian blobs on the generator's device: centre ~ U(3, 13)²,
    radius ~ U(1.5, 3.5), colour one of 4 hues. [-1, 1], NHWC fp32."""
    dev = generator.device
    center = 3.0 + (SIZE - 6.0) * torch.rand((n, 2), generator=generator, device=dev)
    radius = 1.5 + 2.0 * torch.rand((n, 1, 1), generator=generator, device=dev)
    color = torch.tensor(PALETTE, device=dev)[torch.randint(0, 4, (n,), generator=generator, device=dev)]
    yy, xx = torch.meshgrid(torch.arange(SIZE, device=dev, dtype=torch.float32),
                            torch.arange(SIZE, device=dev, dtype=torch.float32), indexing="ij")
    d2 = (yy[None] - center[:, 0, None, None]) ** 2 + (xx[None] - center[:, 1, None, None]) ** 2
    blob = torch.exp(-d2 / (2.0 * radius ** 2))  # [n, H, W]
    return 2.0 * blob[..., None] * color[:, None, None, :] - 1.0


# ------------------------------------------------------- feature net / FD


def feature_params(generator: torch.Generator, dim: int = 64) -> List[torch.Tensor]:
    """A fixed random 3-layer conv feature extractor ([O, I, 3, 3] weights,
    He-scaled): random-projection features are a standard basis for toy
    Fréchet distances."""
    shapes = [(32, C), (64, 32), (dim, 64)]
    return [torch.randn((o, i, 3, 3), generator=generator, device=generator.device) * (2.0 / (9 * i)) ** 0.5
            for o, i in shapes]


def features(params: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """[B, dim] fp32: stride-2 3×3 convs padded as XLA's "SAME" (one row and
    column after, none before), tanh-gelu between, then the spatial mean."""
    h = x.float().permute(0, 3, 1, 2)
    for i, w in enumerate(params):
        h = F.conv2d(F.pad(h, (0, 1, 0, 1)), w.to(h.device), stride=2)
        if i < len(params) - 1:
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h.mean(dim=(2, 3))


def fd(params: Sequence[torch.Tensor], a: torch.Tensor, b: torch.Tensor) -> float:
    """Fréchet distance between the features of two image sets (float64)."""
    with torch.no_grad():
        fa = features(params, a).double().cpu().numpy()
        fb = features(params, b).double().cpu().numpy()
    return frechet_distance(fa.mean(0), np.cov(fa, rowvar=False), fb.mean(0), np.cov(fb, rowvar=False))


# ------------------------------------------------------------- teacher


def unet_config() -> UNetConfig:
    """A 2-level UNet (32 and 64 channels, the second with self-attention),
    no cross-attention, 8 groups."""
    return UNetConfig(
        in_channels=C, out_channels=C, block_out_channels=[32, 64],
        down_block_types=["DownBlock2D", "AttnDownBlock2D"], layers_per_block=1,
        transformer_layers_per_block=[1, 1], num_heads=[2, 2],
        cross_attention_dim=None, norm_num_groups=8,
    )


def autocast(device: torch.device):
    """bf16 autocast on the card (the attention kernels take bf16), none on
    the CPU."""
    if device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


def make_unet(seed: int, device: torch.device) -> UNet2DCondition:
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with device:
            return UNet2DCondition(unet_config())


def log(msg: str, verbose: bool) -> None:
    if verbose:
        print(msg, file=sys.stderr)


def train_teacher(unet, steps: int, batch: int, lr: float, seed: int = 0, verbose: bool = True):
    """Standard DDPM ε-prediction pretraining (the part the recipe takes from
    a pretrained checkpoint). Returns the losses."""
    dev = next(unet.parameters()).device
    _, sqrt_acp, sqrt_1macp = training_tables(SchedulerConfig())
    sqrt_acp = torch.as_tensor(np.asarray(sqrt_acp), dtype=torch.float32, device=dev)
    sqrt_1macp = torch.as_tensor(np.asarray(sqrt_1macp), dtype=torch.float32, device=dev)
    opt = torch.optim.Adam(unet.parameters(), lr=lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    losses = []
    for i in range(steps):
        x0 = make_batch(gen, batch)
        t = torch.randint(0, len(sqrt_acp), (batch,), generator=gen, device=dev)
        eps = torch.randn(x0.shape, generator=gen, device=dev)
        noisy = sqrt_acp[t][:, None, None, None] * x0 + sqrt_1macp[t][:, None, None, None] * eps
        with autocast(dev):
            loss = torch.mean((unet(noisy, t, None) - eps) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i % max(1, steps // 5) == 0:
            log(f"  teacher step {i}: loss {losses[-1]:.4f}", verbose)
    return losses


# ------------------------------------------------------------- distill


def make_discriminator(unet, seed: int):
    """The GAN's discriminator over the teacher's mid features (64 channels
    at 8²: one stride-2 stage, then the 4×4 head), on the UNet's device."""
    dev = next(unet.parameters()).device
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed + 3)
        with dev:
            return ConvDiscriminator(DiscriminatorConfig(feature_dim=32, num_stages=1),
                                     in_channels=unet.config.block_out_channels[-1])


def build_flash(unet, seed: int = 0):
    """The ε recipe: K = 4, DMD, the hinge GAN at 0.3."""
    disc = make_discriminator(unet, seed)
    model = FlashDiffusion(
        FlashDiffusionConfig(
            K=[4], num_iterations_per_K=[10 ** 9],
            guidance_scale_min=1.0, guidance_scale_max=1.0,
            timestep_distribution="uniform", distill_loss_type="l2",
            use_dmd_loss=True, dmd_loss_scale=[1.0],
            adversarial_loss_scale=[0.3],
        ),
        teacher_module=unet, discriminator=disc, lora_scaling=lora_scaling(LORA_RANK),
    )
    return model, disc


def distill(model, steps: int, batch: int, lr: float, seed: int = 0, verbose: bool = True, tag: str = ""):
    """Adam over the LoRA and the discriminator, one backward of loss_G +
    loss_D a step, at the stage of each iteration. Returns the LoRA tree."""
    unet = model.teacher_module
    dev = next(unet.parameters()).device
    unet.requires_grad_(False)
    lora = init_lora(unet, LORA_RANK, torch.Generator(device=dev).manual_seed(seed + 2), device=dev)
    for ab in lora.values():
        for t in ab.values():
            t.requires_grad_()
    model.attach_lora(lora)
    params = [t for ab in lora.values() for t in ab.values()] + list(model.discriminator.parameters())
    opt = torch.optim.Adam(params, lr=lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    for i in range(steps):
        stage = model.stage_for_iteration(i + 1)
        batch_d = {"image": make_batch(gen, batch)}
        draws = model.draw(gen, stage, batch_d["image"])
        with autocast(dev):
            total, aux = model.losses(batch_d, draws, stage)
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        if i % max(1, steps // 5) == 0:
            log(f"  {tag}distill step {i} (stage {stage}): G {aux['loss/generator'].item():.4f} "
                f"distill {aux['loss/distill'].item():.4f}", verbose)
    return {name: {k: t.detach() for k, t in ab.items()} for name, ab in lora.items()}


# ------------------------------------------------------------- evaluate


def evaluate(model, lora, n_eval: int, seed: int = 0) -> Dict[str, float]:
    """FD against held-out data of the teacher's 32 steps, the student's 4
    NFE and the undistilled (zero-LoRA) student's 4 NFE, from one set of
    latents; each student sampler's noise from one generator seed."""
    dev = next(model.teacher_module.parameters()).device
    feat = feature_params(torch.Generator(device=dev).manual_seed(1234))
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    data = make_batch(gen, n_eval)
    z = torch.randn((n_eval, SIZE, SIZE, C), generator=gen, device=dev)
    batch = {"image": data}
    noise = lambda: torch.Generator(device=dev).manual_seed(seed + 8)
    zero = {name: {k: torch.zeros_like(t) for k, t in ab.items()} for name, ab in lora.items()}
    with autocast(dev):
        teacher_s = model.sample(None, z, batch, num_steps=32, use_teacher=True, teacher_guidance_scale=1.0,
                                 decode=False)
        student_s = model.sample(lora, z, batch, num_steps=4, guidance_scale=1.0, decode=False, generator=noise())
        undistilled_s = model.sample(zero, z, batch, num_steps=4, guidance_scale=1.0, decode=False,
                                     generator=noise())
    return {
        "fd_teacher_32nfe": fd(feat, data, teacher_s),
        "fd_student_4nfe": fd(feat, data, student_s),
        "fd_undistilled_4nfe": fd(feat, data, undistilled_s),
    }


def run(teacher_steps: int, distill_steps: int, batch: int, n_eval: int, seed: int = 0, device="cuda",
        verbose: bool = True):
    """The whole proof; returns ({the three FDs, wall_s}, (model, lora))."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 feature net and losses
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    unet = make_unet(seed, dev)
    train_teacher(unet, teacher_steps, batch, 2e-3, seed, verbose)
    model, _ = build_flash(unet, seed)
    lora = distill(model, distill_steps, batch, 1e-3, seed, verbose)
    out = evaluate(model, lora, n_eval, seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["wall_s"] = round(time.time() - t0, 1)
    return out, (model, lora)


def parse_args(argv: Optional[Sequence[str]] = None, **extra):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--teacher-steps", type=int, default=3000)
    ap.add_argument("--distill-steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--n-eval", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    for flag, kw in extra.items():
        ap.add_argument(flag, **kw)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    return args


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    out, _ = run(args.teacher_steps, args.distill_steps, args.batch, args.n_eval, args.seed, args.device)
    for k, v in out.items():
        print(json.dumps({"metric": f"toy_quality/{k}", "value": round(float(v), 4)}))
    return out


if __name__ == "__main__":
    main()
