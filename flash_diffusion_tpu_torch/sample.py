"""Few-step text-to-image sampling with the PyTorch port: build_pipeline and CLI.

    python -m flash_diffusion_tpu_torch.sample --model sdxl --prompt "A raccoon reading a book" \
        --steps 4 --out sample.png [--weights-root /weights/sdxl]

``build_pipeline(model, device=...)`` is the port's counterpart of the sd15
and sdxl branches of ``examples/sample.py::build_pipeline``, with the LCM
schedule:

- ``sd15``: CLIP-L conditioning (its last hidden state), the SD1.5 UNet and
  the SD VAE decoder, 64×64×4 latents (512²);
- ``sdxl``: CLIP-L (the penultimate layer's output) and OpenCLIP-bigG (the
  same, plus its projected pooled output as the vector) conditioning, with
  original size, crop and target size through three 256-channel
  ``TimestepsEmbedder``s (``size_cond_fn``), the SDXL UNet and the SDXL VAE
  decoder (scaling factor 0.13025), 128×128×4 latents (1024²).

UNet and VAE run in bf16, the CLIP towers in fp32, as the JAX package runs
them. Weights are random, made from ``seed``, unless ``weights_root`` holds
a local diffusers layout (``unet/``, ``vae/``, ``text_encoder/`` and, for
SDXL, ``text_encoder_2/`` safetensors), whose keys the port's modules carry
as they are. The tokenizer contract is the JAX example's: a local CLIP
tokenizer under ``weights_root/tokenizer`` if present (both towers read the
same ids), else deterministic zero ids.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import zlib

import numpy as np
import torch

from .models import (
    AutoencoderKL,
    UNet2DCondition,
    sd15_unet_config,
    sd_vae_config,
    sdxl_unet_config,
)
from .models.embedders import (
    ClipEmbedder,
    ClipEmbedderConfig,
    ConditionerWrapper,
    TimestepsEmbedder,
    TimestepsEmbedderConfig,
)
from .lora import load_peft_safetensors
from .pipelines import FlashPipeline

MODELS = ("sd15", "sdxl")
SIZE_KEYS = ("original_size_as_tuple", "crop_coords_top_left", "target_size_as_tuple")


def clip_tokenizer(root: str, max_length: int = 77, key: str = "text_ids"):
    """Local CLIP tokenizer if ``root/tokenizer`` exists, else zero ids."""
    tok_dir = os.path.join(root, "tokenizer")
    if os.path.isdir(tok_dir):
        from transformers import CLIPTokenizerFast

        tok = CLIPTokenizerFast.from_pretrained(tok_dir)

        def tokenizer_fn(texts):
            out = tok(texts, padding="max_length", max_length=max_length,
                      truncation=True, return_tensors="np")
            return {key: out["input_ids"]}

        return tokenizer_fn
    print("WARNING: no local tokenizer — using zero token ids", file=sys.stderr)
    return lambda texts: {key: np.zeros((len(texts), max_length), np.int64)}


def _load_local(module: torch.nn.Module, path: str, keep=lambda k: True) -> None:
    """Load a diffusers/transformers safetensors file, if present, by its own keys."""
    if os.path.exists(path):
        from safetensors.torch import load_file

        module.load_state_dict({k: v for k, v in load_file(path).items() if keep(k)})


def size_cond_fn(n: int, h: int, w: int):
    """SDXL's size conditions of a batch of n images at h×w pixels: original
    and target size (h, w), crop (0, 0)."""
    return {
        "original_size_as_tuple": np.tile([h, w], (n, 1)).astype(np.float32),
        "crop_coords_top_left": np.zeros((n, 2), np.float32),
        "target_size_as_tuple": np.tile([h, w], (n, 1)).astype(np.float32),
    }


def build_modules(model: str):
    """The fp32 modules of a family on the default device:
    (unet, vae, conditioners, [(checkpoint file, CLIP tower)], size_cond_fn)."""
    if model not in MODELS:
        raise ValueError(f"model {model!r} is not ported yet (one of {MODELS})")
    if model == "sd15":
        clip = ClipEmbedder(ClipEmbedderConfig(input_key="text"))
        return (UNet2DCondition(sd15_unet_config()), AutoencoderKL(sd_vae_config()), [clip],
                [("text_encoder/model.safetensors", clip)], None)
    clip_l = ClipEmbedder(ClipEmbedderConfig(input_key="text", layer="hidden", layer_idx=-2))
    clip_g = ClipEmbedder(ClipEmbedderConfig(
        input_key="text",
        text_embedder_config=dict(hidden_size=1280, intermediate_size=5120, num_layers=32,
                                  num_heads=20, hidden_act="gelu", projection_dim=1280),
        layer="hidden", layer_idx=-2, always_return_pooled=True, use_projection=True,
    ))
    sizes = [TimestepsEmbedder(TimestepsEmbedderConfig(input_key=k, num_channels=256))
             for k in SIZE_KEYS]
    towers = [("text_encoder/model.safetensors", clip_l),
              ("text_encoder_2/model.safetensors", clip_g)]
    return (UNet2DCondition(sdxl_unet_config()), AutoencoderKL(sd_vae_config(scaling_factor=0.13025)),
            [clip_l, clip_g, *sizes], towers, size_cond_fn)


def build_pipeline(model: str = "sd15", weights_root: str = "",
                   device: str | torch.device = "cuda", seed: int = 0,
                   lora: str | None = None, lora_scale: float = 1.0) -> FlashPipeline:
    """Build the ``sd15`` or ``sdxl`` pipeline on ``device``: UNet and VAE in
    bf16, the CLIP towers in fp32. ``lora``: a PEFT ``.safetensors`` adapter
    to merge (``lora.load_peft_safetensors``; its scaling times
    ``lora_scale``); ``pipe.lora_loader`` reads such files for serving.

    Sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False: fp32 convolutions would
    otherwise run in TF32 by default, and the fp32 CLIP towers are held to
    fp32 numerics."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # random init on the device itself, from a private RNG stream
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with device:
            unet, vae, conditioners, towers, size_fn = build_modules(model)
    if weights_root:
        _load_local(unet, os.path.join(weights_root, "unet/diffusion_pytorch_model.safetensors"))
        _load_local(vae, os.path.join(weights_root, "vae/diffusion_pytorch_model.safetensors"))
        for path, tower in towers:
            _load_local(tower.module, os.path.join(weights_root, path),
                        keep=lambda k: not k.endswith("position_ids"))
    pipe = FlashPipeline(
        unet.to(torch.bfloat16).eval(), ConditionerWrapper(conditioners).eval(),
        vae.to(torch.bfloat16).eval(), clip_tokenizer(weights_root),
        latent_shape=(128, 128, 4) if model == "sdxl" else (64, 64, 4),
    )
    pipe.size_cond_fn = size_fn
    pipe.lora_loader = load_peft_safetensors
    if lora:
        tree, scaling = pipe.lora_loader(lora)
        pipe.load_lora(tree, scaling * lora_scale)
        print(f"loaded LoRA {lora} (scaling {scaling * lora_scale})")
    return pipe


def png_bytes(pix: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``pix`` [H, W, 3] uint8 (stdlib only: zlib, one
    IDAT, filter type 0 on every row)."""
    h, w, _ = pix.shape
    raw = b"".join(b"\x00" + pix[i].tobytes() for i in range(h))

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def save_png(path: str, images: np.ndarray) -> None:
    """Save [B, H, W, 3] images in [-1, 1] side by side as an 8-bit PNG."""
    grid = np.concatenate(list(images), axis=1)
    pix = np.clip((grid + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(png_bytes(pix))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="sd15", choices=MODELS)
    ap.add_argument("--weights-root", default="")
    ap.add_argument("--prompt", action="append", required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--guidance-scale", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="sample.png")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    pipe = build_pipeline(args.model, args.weights_root, device=args.device, seed=args.seed)
    images = pipe.generate(
        args.prompt, num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale, seed=args.seed,
    )
    save_png(args.out, images.cpu().numpy())
    print("saved", args.out)


if __name__ == "__main__":
    main()
