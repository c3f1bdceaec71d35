"""Weights-free end-to-end quality proof of the rectified-flow recipe (PyTorch port).

    python -m flash_diffusion_tpu_torch.toy_quality_rf [--teacher-steps N] [--distill-steps N] [--device cpu]

The port of ``examples/toy_quality_rf.py``, the ε proof of
``toy_quality.py`` for the SD3 family:

1. trains a small v-prediction flow-matching **teacher** from scratch on
   the same blobs (loss ‖v̂ − (noise − x₀)‖² at σ-interpolated samples, the
   shifted SD3 schedule),
2. **distills** it with the port's ``FlashDiffusionSD3``: K-step flow-Euler
   teacher rollout, unweighted DMD and the hinge GAN on the teacher's own
   feature tap (this UNet's mid block, where the MMDiT's is its post-mid
   stream), the GAN staged in after 80% of the steps at ``--gan-scale``,
3. reports the Fréchet distance in the same random-CNN features for the
   teacher's 32 NFE, the student's 4 NFE and the undistilled 4 NFE.

"The RF recipe distills" == FD(student 4-NFE) beats FD(undistilled 4-NFE)
by a wide margin and lands near FD(teacher 32-NFE). Prints one JSON line
per metric.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from .distill import FlashDiffusionSD3, FlashDiffusionSD3Config
from .lora import lora_scaling
from .schedulers import SchedulerConfig, flow_match
from .toy_quality import (
    LORA_RANK,
    autocast,
    distill,
    evaluate,
    log,
    make_batch,
    make_discriminator,
    make_unet,
    parse_args,
)

SHIFT = 3.0  # the SD3 schedule warp (FlashDiffusionSD3's default)


def train_teacher_rf(unet, steps: int, batch: int, lr: float, seed: int = 0, verbose: bool = True):
    """Flow-matching pretraining: v̂(x_σ, t) → noise − x₀, σ from the shifted
    schedule (the part the recipe takes from the SD3 checkpoint). Returns
    the losses."""
    dev = next(unet.parameters()).device
    cfg = SchedulerConfig(shift=SHIFT)
    sched = flow_match.set_timesteps(cfg, cfg.num_train_timesteps)
    sig, ts = sched.sigmas_train.to(dev), sched.timesteps_train.to(dev)
    opt = torch.optim.Adam(unet.parameters(), lr=lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    losses = []
    for i in range(steps):
        x0 = make_batch(gen, batch)
        idx = torch.randint(0, cfg.num_train_timesteps, (batch,), generator=gen, device=dev)
        noise = torch.randn(x0.shape, generator=gen, device=dev)
        s = sig[idx][:, None, None, None]
        noisy = s * noise + (1.0 - s) * x0
        with autocast(dev):
            loss = torch.mean((unet(noisy, ts[idx], None) - (noise - x0)) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i % max(1, steps // 5) == 0:
            log(f"  rf teacher step {i}: loss {losses[-1]:.4f}", verbose)
    return losses


def build_flash_rf(unet, distill_steps: int, k: int = 4, gan_scale: float = 0.1, seed: int = 0):
    """The staged SD3 recipe (flash_sd3.yaml ramps the GAN in): stage 0,
    the first 80% of the steps, distill + DMD (the discriminator trains:
    loss_D is unscaled); stage 1 adds the GAN's G term at ``gan_scale``."""
    disc = make_discriminator(unet, seed)
    stage0 = max(1, int(0.8 * distill_steps))
    model = FlashDiffusionSD3(
        FlashDiffusionSD3Config(
            K=[k, k], num_iterations_per_K=[stage0, 10 ** 9],
            guidance_scale_min=1.0, guidance_scale_max=1.0,
            timestep_distribution="uniform", distill_loss_type="l2",
            use_dmd_loss=True, dmd_loss_scale=[1.0, 1.0],
            adversarial_loss_scale=[0.0, gan_scale],
        ),
        teacher_module=unet, scheduler_config=SchedulerConfig(shift=SHIFT), discriminator=disc,
        lora_scaling=lora_scaling(LORA_RANK),
    )
    return model, disc


def run(teacher_steps: int, distill_steps: int, batch: int, n_eval: int, seed: int = 0, device="cuda",
        k: int = 4, gan_scale: float = 0.1, verbose: bool = True):
    """The whole proof; returns ({the three FDs, wall_s}, (model, lora))."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    unet = make_unet(seed, dev)
    train_teacher_rf(unet, teacher_steps, batch, 2e-3, seed, verbose)
    model, _ = build_flash_rf(unet, distill_steps, k=k, gan_scale=gan_scale, seed=seed)
    lora = distill(model, distill_steps, batch, 1e-3, seed, verbose, tag="rf ")
    out = evaluate(model, lora, n_eval, seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["wall_s"] = round(time.time() - t0, 1)
    return out, (model, lora)


def main(argv: Optional[Sequence[str]] = None):
    import json

    args = parse_args(argv, **{
        "--k": dict(type=int, default=4, help="teacher rollout steps per stage"),
        "--gan-scale": dict(type=float, default=0.1, help="stage-1 adversarial scale (0 = distill+DMD only)"),
    })
    out, _ = run(args.teacher_steps, args.distill_steps, args.batch, args.n_eval, args.seed, args.device,
                 k=args.k, gan_scale=args.gan_scale)
    for k, v in out.items():
        print(json.dumps({"metric": f"toy_quality_rf/{k}", "value": round(float(v), 4)}))
    return out


if __name__ == "__main__":
    main()
