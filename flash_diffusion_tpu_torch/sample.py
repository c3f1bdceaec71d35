"""Few-step text-to-image sampling with the PyTorch port: build_pipeline and CLI.

    python -m flash_diffusion_tpu_torch.sample --model sdxl --prompt "A raccoon reading a book" \
        --steps 4 --out sample.png [--weights-root /weights/sdxl]

``build_pipeline(model, device=...)`` is the port's counterpart of the sd15,
sdxl and pixart branches of ``examples/sample.py::build_pipeline``, with the
LCM schedule:

- ``sd15``: CLIP-L conditioning (its last hidden state), the SD1.5 UNet and
  the SD VAE decoder, 64×64×4 latents (512²);
- ``sdxl``: CLIP-L (the penultimate layer's output) and OpenCLIP-bigG (the
  same, plus its projected pooled output as the vector) conditioning, with
  original size, crop and target size through three 256-channel
  ``TimestepsEmbedder``s (``size_cond_fn``), the SDXL UNet and the SDXL VAE
  decoder (scaling factor 0.13025), 128×128×4 latents (1024²);
- ``pixart``: T5-v1.1-XXL conditioning over 120 tokens with its padding
  mask, the resolution and aspect ratio [h, w, w/h] as a raw vector
  (``size_cond_fn``), the Pixart-α DiT (``pixart_config(num_vector_embeds=
  3)``) and the SD VAE decoder, 128×128×4 latents (1024²), LCM on linear
  betas 1e-4 → 0.02.

UNet, DiT and VAE run in bf16, the text towers in fp32, as the JAX package
runs them. Weights are random, made from ``seed``, unless ``weights_root``
holds a local diffusers layout (``unet/`` or ``transformer/``, ``vae/``,
``text_encoder/`` and, for SDXL, ``text_encoder_2/`` safetensors, sharded
or not), whose keys the port's modules carry as they are (a stock Pixart
1024-MS transformer goes through ``pixart_state_from_diffusers``). The
tokenizer contract is the JAX example's: a local tokenizer under
``weights_root/tokenizer`` if present (CLIP, or T5 for Pixart), else
deterministic zero ids (and an all-ones T5 mask).
"""

from __future__ import annotations

import argparse
import glob
import os
import struct
import sys
import zlib

import numpy as np
import torch

from .models import (
    AutoencoderKL,
    DiT,
    UNet2DCondition,
    pixart_config,
    sd15_unet_config,
    sd_vae_config,
    sdxl_unet_config,
)
from .models.dit import pixart_state_from_diffusers
from .models.embedders import (
    ClipEmbedder,
    ClipEmbedderConfig,
    ConditionerWrapper,
    RawVectorEmbedder,
    RawVectorEmbedderConfig,
    T5TextEmbedder,
    T5TextEmbedderConfig,
    TimestepsEmbedder,
    TimestepsEmbedderConfig,
)
from .lora import load_peft_safetensors
from .pipelines import FlashPipeline
from .schedulers import SchedulerConfig

MODELS = ("sd15", "sdxl", "pixart")
# Pixart's LCM schedule: linear betas, as the family trains
# (``examples/sample.py`` pixart branch)
PIXART_SCHEDULER = SchedulerConfig(beta_schedule="linear", beta_start=0.0001, beta_end=0.02)
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


def t5_tokenizer(root: str, max_length: int = 120):
    """Local T5 tokenizer if ``root/tokenizer`` exists (``text_ids`` and
    ``text_mask``), else zero ids with an all-ones mask."""
    tok_dir = os.path.join(root, "tokenizer")
    if os.path.isdir(tok_dir):
        from transformers import T5TokenizerFast

        tok = T5TokenizerFast.from_pretrained(tok_dir)

        def tokenizer_fn(texts):
            out = tok(texts, padding="max_length", max_length=max_length,
                      truncation=True, return_tensors="np")
            return {"text_ids": out["input_ids"], "text_mask": out["attention_mask"]}

        return tokenizer_fn
    print("WARNING: no local T5 tokenizer — using zero token ids", file=sys.stderr)
    return lambda texts: {"text_ids": np.zeros((len(texts), max_length), np.int64),
                          "text_mask": np.ones((len(texts), max_length), np.int64)}


def _load_local(module: torch.nn.Module, path: str, keep=lambda k: True, convert=None) -> None:
    """Load a diffusers/transformers safetensors file, or a directory of
    shards, if present, by its own keys (after ``convert`` of the dict)."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors"))) if os.path.isdir(path) else (
        [path] if os.path.exists(path) else [])
    if files:
        from safetensors.torch import load_file

        sd = {k: v for f in files for k, v in load_file(f).items() if keep(k)}
        module.load_state_dict(convert(sd) if convert else sd)


def _t5_keys(sd):
    """transformers ``T5EncoderModel`` files hold the tied token embedding as
    ``shared.weight``, ``encoder.embed_tokens.weight`` or both."""
    emb = sd.pop("encoder.embed_tokens.weight", None)
    if "shared.weight" not in sd:
        sd["shared.weight"] = emb
    return sd


def load_weights(model: str, root: str, denoiser, vae, towers) -> None:
    """The local diffusers layout under ``root``, where present: the UNet
    (``unet/``) or the DiT (``transformer/``, through
    ``pixart_state_from_diffusers``), the VAE and the text towers (T5's
    through ``_t5_keys``)."""
    pixart = model == "pixart"
    _load_local(denoiser, os.path.join(root, "transformer" if pixart else "unet",
                                       "diffusion_pytorch_model.safetensors"),
                convert=pixart_state_from_diffusers if pixart else None)
    _load_local(vae, os.path.join(root, "vae/diffusion_pytorch_model.safetensors"))
    for path, tower in towers:
        _load_local(tower.module, os.path.join(root, path),
                    keep=lambda k: not k.endswith("position_ids"), convert=_t5_keys if pixart else None)


def size_cond_fn(n: int, h: int, w: int):
    """SDXL's size conditions of a batch of n images at h×w pixels: original
    and target size (h, w), crop (0, 0)."""
    return {
        "original_size_as_tuple": np.tile([h, w], (n, 1)).astype(np.float32),
        "crop_coords_top_left": np.zeros((n, 2), np.float32),
        "target_size_as_tuple": np.tile([h, w], (n, 1)).astype(np.float32),
    }


def pixart_size_cond_fn(n: int, h: int, w: int):
    """Pixart 1024-MS's size condition of a batch of n images at h×w
    pixels: [h, w, w/h] per image."""
    return {"resolution_ar": np.tile([float(h), float(w), w / h], (n, 1)).astype(np.float32)}


def build_modules(model: str, remat: bool = False):
    """The fp32 modules of a family on the default device: (denoiser, vae,
    conditioners, [(checkpoint file or shard directory, text tower)],
    size_cond_fn). ``remat``: the UNet or the DiT recomputes its blocks in
    the backward (training)."""
    if model not in MODELS:
        raise ValueError(f"model {model!r} is not ported yet (one of {MODELS})")
    if model == "pixart":
        t5 = T5TextEmbedder(T5TextEmbedderConfig(input_key="text", max_length=120))
        res_ar = RawVectorEmbedder(RawVectorEmbedderConfig(input_key="resolution_ar"))
        return (DiT(pixart_config(num_vector_embeds=3, remat=remat)), AutoencoderKL(sd_vae_config()), [t5, res_ar],
                [("text_encoder", t5)], pixart_size_cond_fn)
    if model == "sd15":
        clip = ClipEmbedder(ClipEmbedderConfig(input_key="text"))
        return (UNet2DCondition(sd15_unet_config(remat=remat)), AutoencoderKL(sd_vae_config()), [clip],
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
    return (UNet2DCondition(sdxl_unet_config(remat=remat)), AutoencoderKL(sd_vae_config(scaling_factor=0.13025)),
            [clip_l, clip_g, *sizes], towers, size_cond_fn)


def build_pipeline(model: str = "sd15", weights_root: str = "",
                   device: str | torch.device = "cuda", seed: int = 0,
                   lora: str | None = None, lora_scale: float = 1.0) -> FlashPipeline:
    """Build the ``sd15``, ``sdxl`` or ``pixart`` pipeline on ``device``: UNet
    or DiT and VAE in bf16, the text towers in fp32. ``lora``: a PEFT
    ``.safetensors`` adapter over the UNet to merge
    (``lora.load_peft_safetensors``; its scaling times ``lora_scale``);
    ``pipe.lora_loader`` reads such files for serving.

    Sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False: fp32 convolutions would
    otherwise run in TF32 by default, and the fp32 text towers are held to
    fp32 numerics."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # random init on the device itself, from a private RNG stream
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with device:
            denoiser, vae, conditioners, towers, size_fn = build_modules(model)
    pixart = model == "pixart"
    if weights_root:
        load_weights(model, weights_root, denoiser, vae, towers)
    pipe = FlashPipeline(
        denoiser.to(torch.bfloat16).eval(), ConditionerWrapper(conditioners).eval(),
        vae.to(torch.bfloat16).eval(), t5_tokenizer(weights_root) if pixart else clip_tokenizer(weights_root),
        latent_shape=(64, 64, 4) if model == "sd15" else (128, 128, 4),
        scheduler_config=PIXART_SCHEDULER if pixart else None,
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
