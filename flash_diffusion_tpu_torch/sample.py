"""Few-step text-to-image sampling with the PyTorch port: build_pipeline and CLI.

    python -m flash_diffusion_tpu_torch.sample --model sdxl --prompt "A raccoon reading a book" \
        --steps 4 --out sample.png [--weights-root /weights/sdxl] [--lora a.safetensors [--lora-scale 1.0]]

``build_pipeline(model, device=...)`` is the port's counterpart of the sd15,
sdxl, pixart and sd3 branches of ``examples/sample.py::build_pipeline``,
with the LCM schedule (SD3: Flash flow matching):

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
  betas 1e-4 → 0.02;
- ``sd3``: SD3-medium (``examples/sample.py::_build_sd3``): CLIP-L and
  CLIP-G, each with its projection (penultimate hidden states, projected
  pooled outputs), packed by ``SD3Conditioner`` to 77 CLIP tokens padded
  to 4096 wide and 77 zero T5 tokens, or with ``t5=True`` followed by
  T5-XXL's ``t5_max_length`` (256) tokens; the MMDiT
  (``sd3_medium_config``: 24 joint blocks of 1536, 2.03 B parameters), the
  16-channel SD3 VAE decoder (scaling 1.5305, shift 0.0609), 128×128×16
  latents (1024²), ``FlashFlowMatchEulerDiscreteScheduler`` with shift 3.

UNet, DiT, MMDiT and VAE run in bf16, the text towers in fp32, as the JAX
package runs them. Weights are random, made from ``seed``, unless
``weights_root`` holds a local diffusers layout (``unet/`` or
``transformer/``, ``vae/``, ``text_encoder/`` and, for SDXL and SD3,
``text_encoder_2/``, for SD3 with T5 ``text_encoder_3/`` safetensors,
sharded or not), whose keys the port's modules carry as they are (a stock
Pixart 1024-MS transformer goes through ``pixart_state_from_diffusers``).
The tokenizer contract is the JAX example's: a local tokenizer under
``weights_root/tokenizer`` if present (CLIP, or T5 for Pixart; SD3's T5 one
under ``tokenizer_3``), else deterministic zero ids (and an all-ones T5
mask). A LoRA file is a PEFT adapter under the ``unet`` prefix, or
``transformer`` for Pixart and SD3, as the JAX pipelines read them.
"""

from __future__ import annotations

import argparse
import functools
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
    MMDiT,
    UNet2DCondition,
    pixart_config,
    sd3_medium_config,
    sd3_vae_config,
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
    SD3Conditioner,
    T5AsSD3Embedder,
    T5TextEmbedder,
    T5TextEmbedderConfig,
    TimestepsEmbedder,
    TimestepsEmbedderConfig,
)
from .lora import load_peft_safetensors
from .pipelines import FlashPipeline
from .schedulers import SchedulerConfig

MODELS = ("sd15", "sdxl", "pixart", "sd3")
# Pixart's LCM schedule: linear betas, as the family trains
# (``examples/sample.py`` pixart branch)
PIXART_SCHEDULER = SchedulerConfig(beta_schedule="linear", beta_start=0.0001, beta_end=0.02)
# SD3's Flash flow-match sampler (``examples/sample.py::_build_sd3``)
SD3_SCHEDULER = "FlashFlowMatchEulerDiscreteScheduler"
SD3_SCHEDULER_CONFIG = SchedulerConfig(shift=3.0)
SD3_JOINT_DIM = 4096  # the width the CLIP tokens are padded to, T5-XXL's
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


def t5_tokenizer(root: str, max_length: int = 120, subdir: str = "tokenizer"):
    """Local T5 tokenizer if ``root/subdir`` exists (``text_ids`` and
    ``text_mask``), else zero ids with an all-ones mask."""
    tok_dir = os.path.join(root, subdir)
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
    (``unet/``), the DiT (``transformer/``, through
    ``pixart_state_from_diffusers``) or the MMDiT (``transformer/``), the
    VAE and the text towers (T5's through ``_t5_keys``)."""
    pixart = model == "pixart"
    _load_local(denoiser, os.path.join(root, "unet" if model in ("sd15", "sdxl") else "transformer",
                                       "diffusion_pytorch_model.safetensors"),
                convert=pixart_state_from_diffusers if pixart else None)
    _load_local(vae, os.path.join(root, "vae/diffusion_pytorch_model.safetensors"))
    for path, tower in towers:
        _load_local(tower.module, os.path.join(root, path), keep=lambda k: not k.endswith("position_ids"),
                    convert=_t5_keys if isinstance(tower, T5TextEmbedder) else None)


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


def _sd3_clip(**encoder):
    """One of SD3's CLIP towers: the penultimate hidden states and the
    projected pooled output."""
    return ClipEmbedder(ClipEmbedderConfig(input_key="text", text_embedder_config=encoder, layer="hidden",
                                           layer_idx=-2, always_return_pooled=True, use_projection=True))


def build_modules(model: str, remat: bool = False, t5: bool = False, t5_max_length: int = 256):
    """The fp32 modules of a family on the default device: (denoiser, vae,
    conditioners, [(checkpoint file or shard directory, text tower)],
    size_cond_fn). ``remat``: the UNet, the DiT or the MMDiT recomputes its
    blocks in the backward (training). ``t5`` (sd3): add T5-XXL over
    ``t5_max_length`` tokens to SD3's two CLIP towers."""
    if model not in MODELS:
        raise ValueError(f"model {model!r} is not ported yet (one of {MODELS})")
    if t5 and model != "sd3":
        raise ValueError("t5 is an option of sd3 alone")
    if model == "sd3":
        clip_l = _sd3_clip(projection_dim=768)
        clip_g = _sd3_clip(hidden_size=1280, intermediate_size=5120, num_layers=32, num_heads=20,
                           hidden_act="gelu", projection_dim=1280)
        conditioners = [clip_l, clip_g]
        towers = [("text_encoder/model.safetensors", clip_l), ("text_encoder_2/model.safetensors", clip_g)]
        if t5:
            t5_tower = T5AsSD3Embedder(T5TextEmbedderConfig(input_key="t5_text", max_length=t5_max_length))
            conditioners.append(t5_tower)
            towers.append(("text_encoder_3", t5_tower))
        return (MMDiT(sd3_medium_config(remat=remat)), AutoencoderKL(sd3_vae_config()), conditioners, towers,
                None)
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


def make_conditioner(model: str, conditioners) -> ConditionerWrapper:
    """The family's conditioner over its embedders: SD3's packs them
    (``SD3Conditioner``, 4096 wide), the others merge them by type."""
    if model == "sd3":
        return SD3Conditioner(conditioners, t5_dim=SD3_JOINT_DIM)
    return ConditionerWrapper(conditioners)


def sd3_tokenizer(root: str, t5: bool = False, t5_max_length: int = 256):
    """SD3's tokenizer: CLIP ids (``text_ids``) and, with ``t5``, T5 ids and
    mask (``t5_text_ids``, ``t5_text_mask``; from ``root/tokenizer_3``)."""
    clip_tok = clip_tokenizer(root)
    if not t5:
        return clip_tok
    t5_tok = t5_tokenizer(root, t5_max_length, subdir="tokenizer_3")

    def tokenizer_fn(texts):
        out, t5_out = dict(clip_tok(texts)), t5_tok(texts)
        out["t5_text_ids"], out["t5_text_mask"] = t5_out["text_ids"], t5_out["text_mask"]
        return out

    return tokenizer_fn


def build_pipeline(model: str = "sd15", weights_root: str = "",
                   device: str | torch.device = "cuda", seed: int = 0,
                   lora: str | None = None, lora_scale: float = 1.0,
                   t5: bool = False, t5_max_length: int = 256) -> FlashPipeline:
    """Build the ``sd15``, ``sdxl``, ``pixart`` or ``sd3`` pipeline on
    ``device``: UNet, DiT or MMDiT and VAE in bf16, the text towers in fp32
    (``t5``: SD3 with T5-XXL over ``t5_max_length`` tokens). ``lora``: a
    PEFT ``.safetensors`` adapter over the denoiser to merge
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
            denoiser, vae, conditioners, towers, size_fn = build_modules(model, t5=t5, t5_max_length=t5_max_length)
    if weights_root:
        load_weights(model, weights_root, denoiser, vae, towers)
    if model == "sd3":
        tokenizer = sd3_tokenizer(weights_root, t5, t5_max_length)
        sched = dict(scheduler=SD3_SCHEDULER, scheduler_config=SD3_SCHEDULER_CONFIG)
    elif model == "pixart":
        tokenizer, sched = t5_tokenizer(weights_root), dict(scheduler_config=PIXART_SCHEDULER)
    else:
        tokenizer, sched = clip_tokenizer(weights_root), {}
    pipe = FlashPipeline(
        denoiser.to(torch.bfloat16).eval(), make_conditioner(model, conditioners).eval(),
        vae.to(torch.bfloat16).eval(), tokenizer,
        latent_shape=(64, 64, 4) if model == "sd15" else (128, 128, vae.config.latent_channels), **sched,
    )
    pipe.size_cond_fn = size_fn
    pipe.lora_loader = functools.partial(load_peft_safetensors,
                                         prefix="unet" if model in ("sd15", "sdxl") else "transformer")
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
    ap.add_argument("--lora", default=None, help="PEFT safetensors adapter to merge")
    ap.add_argument("--lora-scale", type=float, default=1.0)
    ap.add_argument("--prompt", action="append", required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--guidance-scale", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="sample.png")
    ap.add_argument("--t5", action="store_true", help="sd3: add T5-XXL to the two CLIP towers")
    ap.add_argument("--t5-max-length", type=int, default=256)
    args = ap.parse_args()
    if args.t5 and args.model != "sd3":
        ap.error("--t5 is an option of --model sd3")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    pipe = build_pipeline(args.model, args.weights_root, device=args.device, seed=args.seed, t5=args.t5,
                          t5_max_length=args.t5_max_length, lora=args.lora, lora_scale=args.lora_scale)
    images = pipe.generate(
        args.prompt, num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale, seed=args.seed,
    )
    save_png(args.out, images.cpu().numpy())
    print("saved", args.out)


if __name__ == "__main__":
    main()
