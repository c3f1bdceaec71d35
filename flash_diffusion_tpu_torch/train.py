"""Flash distillation of SD1.5 with the PyTorch port: build_trainer and CLI.

    python -m flash_diffusion_tpu_torch.train --config examples/configs/flash_sd.yaml \\
        --max-steps 10 [--weights-root /weights/sd15] [--random-init] [--device cuda]

``build_trainer("sd15", device=...)`` is the port's counterpart of
``examples/train_flash_sd.py``: an SD1.5 teacher (``remat`` on), a rank-128
LoRA student over it, the SD VAE, CLIP-L (its last hidden state) and
LPIPS-VGG16 frozen in bf16, a conv discriminator over the teacher's mid
features (64 features, ``num_stages`` from the image size: 1 at 512²), the
DDPM teacher schedule and the yaml's losses, loss scales, mode
probabilities and learning rates; then ``TrainingPipeline.fit(batches,
max_steps=n)`` runs the simultaneous step.

Weights are random, made from ``seed``, unless ``weights_root`` holds a
local diffusers layout (``unet/``, ``vae/``, ``text_encoder/``
safetensors); LPIPS and the discriminator are always random (the
pretrained VGG/LPIPS weights are not in the repository). The data pipeline
(webdataset shards) is not ported: ``synthetic_batches`` makes batches from
a seed. Batch layout at the boundary: ``image`` [B, H, W, 3] fp32 in
[-1, 1] (NHWC, as the JAX package), ``text_ids`` [B, 77] int token ids.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch
import yaml

from .distill import LPIPS, ConvDiscriminator, DiscriminatorConfig, FlashDiffusion, FlashDiffusionConfig
from .lora import init_lora, lora_scaling
from .models import AutoencoderKL, UNet2DCondition, sd15_unet_config, sd_vae_config
from .models.embedders import ClipEmbedder, ClipEmbedderConfig, ConditionerWrapper
from .sample import _load_local
from .schedulers import SchedulerConfig
from .trainer import TrainingConfig, TrainingPipeline

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "configs", "flash_sd.yaml")
MODELS = ("sd15",)


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def synthetic_batches(batch_size: int = 4, image_size: int = 512, seed: int = 0,
                      max_length: int = 77) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches made from ``seed``: images uniform in [-1, 1] and
    CLIP-style ids (BOS, random tokens, EOS, EOS padding)."""
    rng = np.random.default_rng(seed)
    while True:
        image = rng.uniform(-1.0, 1.0, (batch_size, image_size, image_size, 3)).astype(np.float32)
        ids = np.full((batch_size, max_length), 49407, np.int64)
        ids[:, 0] = 49406
        for i in range(batch_size):
            n = int(rng.integers(1, max_length - 1))
            ids[i, 1:n] = rng.integers(0, 49406, n - 1)
        yield {"image": image, "text_ids": ids}


def build_trainer(
    model: str = "sd15",
    weights_root: str = "",
    device: Union[str, torch.device] = "cuda",
    seed: Optional[int] = None,
    config: Union[str, Dict[str, Any]] = DEFAULT_CONFIG,
) -> TrainingPipeline:
    """The Flash SD1.5 trainer on ``device`` from a yaml config (a path or
    its dict); ``seed`` defaults to the config's ``SEED``; the frozen
    modules are stored in bf16, as the JAX example stores them. Sets
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False, as ``build_pipeline``."""
    if model not in MODELS:
        raise ValueError(f"training of {model!r} is not ported yet (one of {MODELS})")
    cfg = load_config(config) if isinstance(config, str) else config
    seed = cfg.get("SEED", 0) if seed is None else seed
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size = cfg.get("IMAGE_SIZE", 512)
    rank = cfg.get("LORA_RANK", 128)
    mid_hw = size // 64  # SD1.5: the mid block runs at latent / 8
    num_stages = max(0, int(math.log2(max(mid_hw // 4, 1))))
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with device:
            unet = UNet2DCondition(sd15_unet_config(remat=True))
            vae = AutoencoderKL(sd_vae_config())
            clip = ClipEmbedder(ClipEmbedderConfig(input_key="text", layer="last"))
            disc = ConvDiscriminator(DiscriminatorConfig(feature_dim=64, num_stages=num_stages),
                                     in_channels=unet.config.block_out_channels[-1])
            lpips = LPIPS()
        if weights_root:
            _load_local(unet, os.path.join(weights_root, "unet/diffusion_pytorch_model.safetensors"))
            _load_local(vae, os.path.join(weights_root, "vae/diffusion_pytorch_model.safetensors"))
            _load_local(clip.module, os.path.join(weights_root, "text_encoder/model.safetensors"),
                        keep=lambda k: not k.endswith("position_ids"))
        generator = torch.Generator(device=device).manual_seed(seed)
        lora = init_lora(unet, rank, generator, device=device)
    model_cfg = FlashDiffusionConfig(
        K=cfg["K"],
        num_iterations_per_K=cfg["NUM_ITERATIONS_PER_K"],
        guidance_scale_min=float(cfg["GUIDANCE_MIN"]),
        guidance_scale_max=float(cfg["GUIDANCE_MAX"]),
        distill_loss_type=cfg["DISTILL_LOSS_TYPE"],
        ucg_keys=cfg.get("UCG_KEYS", ["text"]),
        timestep_distribution=cfg["TIMESTEP_DISTRIBUTION"],
        mixture_num_components=cfg["MIXTURE_NUM_COMPONENTS"],
        mixture_var=cfg["MIXTURE_VAR"],
        use_dmd_loss=cfg["USE_DMD_LOSS"],
        dmd_loss_scale=cfg["DMD_LOSS_SCALE"],
        distill_loss_scale=cfg["DISTILL_LOSS_SCALE"],
        adversarial_loss_scale=cfg["ADVERSARIAL_LOSS_SCALE"],
        gan_loss_type=cfg["GAN_LOSS_TYPE"],
        mode_probs=cfg.get("MODE_PROBS"),
        use_teacher_as_real=cfg.get("USE_TEACHER_AS_REAL", False),
        use_empty_prompt=cfg.get("USE_EMPTY_PROMPT", True),
        **({"lpips_crop": cfg["LPIPS_CROP"]} if "LPIPS_CROP" in cfg else {}),
    )
    flash = FlashDiffusion(
        model_cfg, teacher_module=unet, scheduler_config=SchedulerConfig(),
        teacher_scheduler=cfg.get("TEACHER_SCHEDULER", "DDPMScheduler"),
        sampling_scheduler=cfg.get("SAMPLING_SCHEDULER", "LCMScheduler"),
        vae=vae, conditioner=ConditionerWrapper([clip]), discriminator=disc, lpips=lpips,
        lora_scaling=lora_scaling(rank),
    )
    train_cfg = TrainingConfig(
        learning_rates=[float(cfg["LR"]), float(cfg.get("LR_DISCRIMINATOR", cfg["LR"]))], seed=seed)
    return TrainingPipeline(flash, train_cfg, lora, device=device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--model", default="sd15", choices=MODELS)
    ap.add_argument("--weights-root", default=None)
    ap.add_argument("--random-init", action="store_true", help="ignore WEIGHTS_ROOT")
    ap.add_argument("--max-steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    cfg = load_config(args.config)
    root = "" if args.random_init else (args.weights_root or cfg.get("WEIGHTS_ROOT", ""))
    root = root if root and os.path.isdir(root) else ""
    trainer = build_trainer(args.model, root, device=args.device, seed=args.seed, config=cfg)
    trainer.config.log_every_n_steps = 1
    seed = cfg.get("SEED", 0) if args.seed is None else args.seed
    aux = trainer.fit(synthetic_batches(cfg.get("BATCH_SIZE", 4), cfg.get("IMAGE_SIZE", 512), seed),
                      max_steps=args.max_steps)
    print({k: float(v) for k, v in aux.items()})


if __name__ == "__main__":
    main()
