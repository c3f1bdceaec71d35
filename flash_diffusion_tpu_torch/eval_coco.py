"""COCO-style FID / CLIP-FID / CLIPScore evaluation CLI of the PyTorch port.

    python -m flash_diffusion_tpu_torch.eval_coco --model sd15 --weights-root /weights/sd15 \\
        --shards /data/coco/{00000..00012}.tar --lora flash_lora.safetensors \\
        --inception /weights/pt_inception-2015-12-05-6726825d.pth --max-batches 200

The port of ``examples/eval_coco.py``, with the same flags and ``--device``
(``cuda`` by default). Shard samples need an image (jpg/png) and a caption
(txt or json["caption"]); the data chain is KeysFromJSON → KeyRename →
ImageTransform (resize, center crop to ``--resolution``) → Rescale.
Prints one JSON line: InceptionV3-pool3 FID ("fid", with ``--inception``;
a ``pt_inception-2015-12-05`` file name, or ``--fid-variant``, selects
pytorch-fid's canonical blocks, comparable to published COCO tables, a
torchvision ``inception_v3_google`` file internally consistent values
only), CLIP-FID ("clip_fid", with CLIP ViT-L/14 vision weights at
``<weights-root>/image_encoder/model.safetensors``) and "clip_score",
where that file is a full CLIP checkpoint (both towers and
``text_projection``, e.g. openai/clip-vit-large-patch14's
``model.safetensors``). ``--random-init`` samples from random denoiser,
VAE and text weights (seed 0) and still reads the extractors' files.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import torch

from .data import (
    DataModuleConfig,
    DataPipeline,
    ImageTransformMapper,
    ImageTransformMapperConfig,
    KeyRenameMapper,
    KeyRenameMapperConfig,
    KeysFromJSONMapper,
    KeysFromJSONMapperConfig,
    MapperWrapper,
    RescaleMapper,
    RescaleMapperConfig,
)
from .eval import evaluate
from .sample import MODELS, build_pipeline


def data_chain(res: int):
    """The shards' mapper chain: caption out of the json, image and text
    keys, resize and center crop to ``res``², [-1, 1]."""
    return [MapperWrapper([
        KeysFromJSONMapper(KeysFromJSONMapperConfig(
            key="json", keys_to_extract=["caption"], remove_original=True, strict=False)),
        KeyRenameMapper(KeyRenameMapperConfig(
            key_map={"jpg": "image", "png": "image", "caption": "text", "txt": "text"})),
        ImageTransformMapper(ImageTransformMapperConfig(key="image", transforms=[
            {"name": "Resize", "size": [res, res]}, {"name": "CenterCrop", "size": [res, res]},
            {"name": "ToTensor"}])),
        RescaleMapper(RescaleMapperConfig(key="image")),
    ])]


def clip_extractors(path: str, tokenizer_fn, device: torch.device):
    """(vision tower, text_embed_fn or None) from a CLIP ViT-L/14 file: the
    vision tower in bf16 on the card (the attention kernels take bf16), in
    fp32 on the CPU; the text tower (with ``text_projection``, where the
    file holds it) in fp32, as the port runs text towers."""
    from safetensors.torch import load_file

    from .models import CLIPTextModel, CLIPVisionModel, clip_l_config, clip_vit_l14_config
    from .models.vision import import_clip_text, import_clip_vision

    sd = load_file(path)
    with torch.device("meta"):
        vision = CLIPVisionModel(clip_vit_l14_config())
    vision.load_state_dict(import_clip_vision(sd), assign=True)
    vision = vision.to(device, torch.bfloat16 if device.type == "cuda" else torch.float32).eval()
    if "text_projection.weight" not in sd:
        return vision, None
    with torch.device("meta"):
        text = CLIPTextModel(clip_l_config(projection_dim=768))
    text.load_state_dict(import_clip_text(sd), assign=True)
    text = text.to(device, torch.float32).eval()

    @torch.inference_mode()
    def text_embed_fn(batch: Dict):
        texts = list(batch.get("text", [])) or [""] * batch["image"].shape[0]
        ids = torch.as_tensor(tokenizer_fn(texts)["text_ids"], device=device)
        return text(ids)["text_embeds"]

    return vision, text_embed_fn


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="sd15", choices=MODELS)
    ap.add_argument("--weights-root", default="")
    ap.add_argument("--shards", nargs="+", required=True)
    ap.add_argument("--lora", default=None)
    ap.add_argument("--lora-scale", type=float, default=1.0)
    ap.add_argument("--inception", default=None, help="inception_v3 .pth (torchvision or pt_inception-2015-12-05)")
    ap.add_argument("--fid-variant", action="store_true",
                    help="force canonical pytorch-fid block semantics (auto-detected from a pt_inception* filename)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--guidance-scale", type=float, default=0.0)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--resolution", type=int, default=0, help="0 = model native")
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")

    pipe = build_pipeline(args.model, "" if args.random_init else args.weights_root, device=device,
                          lora=args.lora, lora_scale=args.lora_scale)
    inception = None
    if args.inception:
        from .models import load_inception_v3

        fid_variant = args.fid_variant or "pt_inception" in os.path.basename(args.inception)
        inception = load_inception_v3(args.inception, fid_variant, device)
    vision = text_embed_fn = None
    clip_file = os.path.join(args.weights_root or "", "image_encoder/model.safetensors")
    if os.path.exists(clip_file):
        vision, text_embed_fn = clip_extractors(clip_file, pipe.tokenizer_fn, device)
    if inception is None and vision is None:
        raise SystemExit("no feature extractor: pass --inception weights and/or put CLIP "
                         "vision weights under <weights-root>/image_encoder/")

    res = args.resolution or (512 if args.model == "sd15" else 1024)
    data = DataPipeline(DataModuleConfig(
        shards_path_or_urls=list(args.shards), per_worker_batch_size=args.batch_size,
        num_workers=max(1, (os.cpu_count() or 2) - 1),
        shuffle_buffer_size=1, shuffle_shards=False), data_chain(res))
    metrics = evaluate(pipe, data.batches(epoch=0), vision_module=vision, text_embed_fn=text_embed_fn,
                       num_inference_steps=args.steps, guidance_scale=args.guidance_scale,
                       max_batches=args.max_batches, inception_module=inception)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in metrics.items()}))
    return metrics


if __name__ == "__main__":
    main()
