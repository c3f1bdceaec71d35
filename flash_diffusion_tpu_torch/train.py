"""Flash distillation of SD1.5, SDXL, Pixart-α and SD3, and of SD1.5 with a Canny T2I-Adapter, with the PyTorch port: build_trainer and CLI.

    python -m flash_diffusion_tpu_torch.train [--model sd15|sdxl|pixart|sd3|sd15-canny] \\
        [--config examples/configs/flash_sd.yaml] --max-steps 10 [--weights-root /weights/sd15] \\
        [--random-init] [--device cuda] [--shards /data/{000000..000010}.tar] \\
        [--eval-shards /data/eval/{00000..00003}.tar] [--output-dir runs] [--resume]
    torchrun --nproc-per-node N -m flash_diffusion_tpu_torch.train ... \
        [--dist-backend nccl|gloo] [--frozen-sharding replicated|fsdp]

Under torchrun each process is a data-parallel rank on ``cuda:LOCAL_RANK``
(``parallel.initialize_distributed``; rank 0 builds the kernels, the
others wait): the yaml's ``BATCH_SIZE`` is the global batch, each rank
reads its own shards (or its rows of each synthetic batch), the gradients
are averaged over the group (``TrainingPipeline``), and rank 0 alone logs
to the file, checkpoints and writes the exports; every rank restores
with ``--resume``. ``--frozen-sharding fsdp`` shards the frozen modules
(FSDP2).

``build_trainer(model, device=...)`` is the port's counterpart of
``examples/train_flash_sd.py``, ``train_flash_sdxl.py``,
``train_flash_pixart.py``, ``train_flash_sd3.py`` and
``train_flash_canny_adapter.py``. The teacher, VAE and
conditioner come from
``sample.build_modules(model)`` with the denoiser's ``remat`` on; a LoRA
student over the teacher, LPIPS-VGG16 when the distill loss is ``lpips``,
a conv discriminator (over the UNet's mid features, 1280 channels,
``num_stages`` from the mid block's size, the 4×4 head taking ≥ 4×4; over
the DiT's 4-channel output latents for Pixart), the yaml's teacher
schedule, losses, loss scales, mode probabilities and learning rates; then
``TrainingPipeline.fit(batches, max_steps=n)`` runs the training run: the
simultaneous (or, with ``GAN_UPDATE_MODE: alternating``, the alternating)
step, ``EMA_DECAY``, ``GRADIENT_ACCUMULATION_STEPS``, ``VAL_EVERY_N_STEPS``
over ``EVAL_SHARDS_PATH_OR_URLS``, checkpoints every
``CKPT_EVERY_N_STEPS`` under ``<output-dir>/checkpoints`` (``--resume``
restores the latest), and at the end the LoRA student (the EMA one when
tracked) as ``<output-dir>/pytorch_lora_weights.safetensors`` (PEFT names,
the ``unet`` or ``transformer`` prefix); the CLI also checkpoints the last
step, so that ``--resume`` continues any run, and for ``sdxl`` writes a
kohya-format copy for ComfyUI, ``<output-dir>/comfy/FlashSDXL.safetensors``
(``lora.save_kohya_safetensors``).
By model (its default yaml in ``CONFIGS``):

- ``sd15``: SD1.5 UNet, SD VAE, CLIP-L (its last hidden state); mid block
  at latent / 8, a 64-feature discriminator; ``flash_sd.yaml``: 512²,
  batch 4, LoRA rank 128, DDPM teacher, hinge GAN;
- ``sdxl``: SDXL UNet, SDXL VAE (scaling factor 0.13025), CLIP-L and bigG
  (the penultimate layer, bigG's projected pooled output) with the three
  size embeddings; mid block at latent / 4 (3 stages at 1024²), a
  256-feature discriminator; ``flash_sdxl.yaml``: 1024², batch 2, LoRA rank
  64, DPM-Solver++ 2M teacher, lsgan, the uncond dropping both CLIP towers;
- ``pixart``: the Pixart-α DiT (1152 wide, 28 blocks, 16 heads of 72, the
  3 vector embedders), SD VAE, T5-v1.1-XXL over 120 tokens with its padding
  mask and the raw [h, w, aspect ratio] vector; the teacher's tables on
  linear betas 1e-4 → 0.02 (``sample.PIXART_SCHEDULER``, the JAX
  example's); a 64-feature, 3-stage discriminator over the 4-channel
  output latents (the DiT's ``return_features``); ``flash_pixart.yaml``:
  512², batch 4, K = 16, LoRA rank 64, DDPM teacher, l2 distill, DMD,
  hinge GAN;
- ``sd3``: SD3-medium's MMDiT (24 joint blocks of 1536), the 16-channel
  SD3 VAE, CLIP-L and CLIP-G packed by ``SD3Conditioner`` with T5-XXL over
  ``T5_MAX_LENGTH`` (77) tokens when ``USE_T5`` (else 77 zero T5 tokens);
  ``FlashDiffusionSD3`` (the flow-match Euler teacher on shift 3, float
  timesteps); a 64-feature discriminator over the MMDiT's 16-channel
  post-mid features, 4 stages (``sd3_discriminator_config``), fewer where
  the image is too small for the 4×4 head; ``flash_sd3.yaml``: 1024², batch
  2, K = 32, LoRA rank 64, l2 distill, DMD, lsgan, the uncond dropping every
  text key (``UCG_KEYS``: ``text`` and ``t5_text``). The yaml's
  ``TEXT_ENCODER_OFFLOAD`` (4) keeps the text towers on the host between
  bursts of that many batches, whose conditioning is computed while they
  are on the card (T5-XXL in fp32 takes ≈ 19 GB of it);
- ``sd15-canny``: ``sd15``'s modules and a frozen bf16 T2I-Adapter
  (``T2IAdapterConfig()``: channels [320, 640, 1280, 1280]) whose
  residuals, from the batch's Canny ``edge`` map at
  ``ADAPTER_CONDITIONING_SCALE``, condition every UNet call;
  ``flash_canny_adapter.yaml``: 512², batch 4, K = 16, LoRA rank 128, DDPM
  teacher, l2 distill, DMD, hinge GAN, the empty-prompt uncond. Its data
  chain ends in ``CannyEdgeMapper`` (``data_mappers``) and its text ids
  are zeros (``make_tokenizer``), as the JAX example's. The adapter's
  weights come from the seed, never zeros (JAX's example freezes an
  all-zero adapter, whose residuals are 0): no published adapter fits its
  architecture.

Weights are random, made from ``seed``, unless ``weights_root`` holds a
local diffusers layout (``unet/``, ``vae/``, ``text_encoder/`` and, for
SDXL, ``text_encoder_2/``; Pixart: ``transformer/`` and a T5
``text_encoder/``; SD3: ``transformer/``, ``text_encoder_2/`` and
``text_encoder_3/``; ``sample.load_weights``); LPIPS and the discriminator
are always random (the pretrained VGG/LPIPS weights are not in the
repository). Data: ``build_data(cfg)`` streams local (or URL, or ``pipe:``)
webdataset shards of ``.jpg`` + ``.json`` (``caption``,
``aesthetic_score``), kept at ``MIN_AESTHETIC_SCORE`` and above, each image
resized and center-cropped to ``IMAGE_SIZE`` square and scaled to
[-1, 1], as ``examples/common.py`` builds it (``ASPECT_BUCKETING``: batches
of one aspect bucket each, with their real SDXL size tuples; ``DECODER:
native``: the native JPEG decoder); ``tokenize_batches`` adds the
token ids (a local tokenizer under ``weights_root``, else zero ids, as in
JAX). Without a shard, ``synthetic_batches`` makes batches from a seed, and
the CLI logs which source it used. Batch layout at the boundary: ``image`` [B, H, W, 3] fp32 in [-1, 1] (NHWC, as the JAX
package), ``text_ids`` [B, 77] int token ids (Pixart: [B, 120] T5 ids
with ``text_mask``), for SDXL the size tuples of ``sample.size_cond_fn``,
for Pixart ``resolution_ar``, for SD3 with T5 ``t5_text_ids`` and
``t5_text_mask``.
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

from .distill import (
    LPIPS,
    ConvDiscriminator,
    DiscriminatorConfig,
    FlashDiffusion,
    FlashDiffusionConfig,
    FlashDiffusionSD3,
    FlashDiffusionSD3Config,
    sd3_discriminator_config,
)
from .lora import init_lora, lora_scaling, save_kohya_safetensors, save_peft_safetensors
from .parallel.mesh import (
    BACKENDS,
    build_kernels_once,
    initialize_distributed,
    is_main,
    local_batch_slice,
    shard_batch,
    world_size,
)
from .models import T2IAdapter, T2IAdapterConfig
from .sample import (
    PIXART_SCHEDULER,
    SD3_SCHEDULER_CONFIG,
    build_modules,
    clip_tokenizer,
    load_weights,
    make_conditioner,
    sd3_tokenizer,
    size_cond_fn,
    t5_tokenizer,
)
from .schedulers import SchedulerConfig
from .trainer import (
    CheckpointCallback,
    TrainingConfig,
    TrainingPipeline,
    export_lora,
    latest_step,
    restore_state,
    save_state,
)

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "configs")
CONFIGS = {model: os.path.join(_CONFIG_DIR, name) for model, name in (
    ("sd15", "flash_sd.yaml"), ("sdxl", "flash_sdxl.yaml"), ("pixart", "flash_pixart.yaml"),
    ("sd3", "flash_sd3.yaml"), ("sd15-canny", "flash_canny_adapter.yaml"))}
MODELS = tuple(CONFIGS)
# by UNet model: (pixels per mid-block position, discriminator features);
# the mid block runs at latent / 8 in SD1.5's four levels, latent / 4 in
# SDXL's three
_MID = {"sd15": (64, 64), "sdxl": (32, 256)}
# the denoiser family of each trained model (``sample.build_modules``'),
# which keys ``_MID`` and ``LORA_PREFIX``
FAMILY = {"sd15-canny": "sd15"}
# the T2I-Adapter runs: model → the batch key of the frozen adapter's input,
# made by the data chain's last mapper (``data_mappers``); their text ids
# are zeros, as ``train_flash_canny_adapter.py`` feeds them
ADAPTER_INPUT = {"sd15-canny": "edge"}
# by model, what a yaml may leave out: the JAX examples' defaults
# (examples/train_flash_sd.py, train_flash_sdxl.py, train_flash_sd3.py,
# common.py)
DEFAULTS = {
    "sd15": {"IMAGE_SIZE": 512, "BATCH_SIZE": 4, "LORA_RANK": 128, "USE_EMPTY_PROMPT": True,
             "TEACHER_SCHEDULER": "DDPMScheduler", "TEACHER_SAMPLING_SCHEDULER": "EulerAncestralDiscreteScheduler"},
    "sdxl": {"IMAGE_SIZE": 1024, "BATCH_SIZE": 2, "LORA_RANK": 64, "USE_EMPTY_PROMPT": False,
             "TEACHER_SCHEDULER": "DPMSolverMultistepScheduler", "TEACHER_SAMPLING_SCHEDULER": "EulerDiscreteScheduler"},
    "pixart": {"IMAGE_SIZE": 512, "BATCH_SIZE": 4, "LORA_RANK": 64, "T5_MAX_LENGTH": 120,
               "USE_EMPTY_PROMPT": True, "TEACHER_SCHEDULER": "DDPMScheduler", "DISTILL_LOSS_TYPE": "l2",
               "TEACHER_SAMPLING_SCHEDULER": "DPMSolverMultistepScheduler"},
    "sd3": {"IMAGE_SIZE": 1024, "BATCH_SIZE": 2, "LORA_RANK": 64, "USE_T5": True, "T5_MAX_LENGTH": 77,
            "USE_EMPTY_PROMPT": False, "TEACHER_SCHEDULER": "FlowMatchEulerDiscreteScheduler",
            "DISTILL_LOSS_TYPE": "l2"},
    "sd15-canny": {"IMAGE_SIZE": 512, "BATCH_SIZE": 4, "LORA_RANK": 128, "USE_EMPTY_PROMPT": True,
                   "TEACHER_SCHEDULER": "DDPMScheduler", "TEACHER_SAMPLING_SCHEDULER": "EulerDiscreteScheduler",
                   "ADAPTER_CONDITIONING_SCALE": 1.0},
}
# the PEFT prefix of each family's denoiser (``sample.build_pipeline``'s)
LORA_PREFIX = {"sd15": "unet", "sdxl": "unet", "pixart": "transformer", "sd3": "transformer"}
logger = logging.getLogger(__name__)


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def _t5_ids(rng: np.random.Generator, batch_size: int, length: int):
    """T5-style ids (random tokens, EOS 1, padding 0) and their mask (1 up
    to the EOS)."""
    ids = np.zeros((batch_size, length), np.int64)
    for i in range(batch_size):
        n = int(rng.integers(1, length))
        ids[i, :n - 1] = rng.integers(3, 32100, n - 1)
        ids[i, n - 1] = 1
    return ids, (ids != 0).astype(np.int64)


def synthetic_batches(batch_size: int = 4, image_size: int = 512, seed: int = 0,
                      max_length: Optional[int] = None, model: str = "sd15",
                      t5_max_length: Optional[int] = 77) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches made from ``seed``: images uniform in [-1, 1] and
    CLIP-style ids of ``max_length`` (77 by default: BOS, random tokens,
    EOS, EOS padding); for ``sdxl`` also the size tuples (original and
    target size ``image_size`` square, crop (0, 0)), as
    ``examples/train_flash_sdxl.py`` makes them. For ``pixart``, T5-style
    ids (120 by default: random tokens, EOS 1, padding 0) with their
    ``text_mask`` (1 up to the EOS) and ``resolution_ar`` = [size, size,
    1.0], as ``train_flash_pixart.py`` makes them. For ``sd3``, the CLIP
    ids and, unless ``t5_max_length`` is None (no T5 tower), T5-style
    ``t5_text_ids`` of that length with ``t5_text_mask``, as
    ``train_flash_sd3.py`` tokenizes them. For ``sd15-canny``, zero text
    ids and the images' Canny ``edge`` maps, as
    ``train_flash_canny_adapter.py`` feeds them."""
    rng = np.random.default_rng(seed)
    mappers = data_mappers(model)
    pixart = model == "pixart"
    max_length = max_length or (120 if pixart else 77)
    while True:
        image = rng.uniform(-1.0, 1.0, (batch_size, image_size, image_size, 3)).astype(np.float32)
        if pixart:
            ids, mask = _t5_ids(rng, batch_size, max_length)
            batch = {"image": image, "text_ids": ids, "text_mask": mask,
                     "resolution_ar": np.tile([float(image_size), float(image_size), 1.0],
                                              (batch_size, 1)).astype(np.float32)}
        else:
            ids = np.full((batch_size, max_length), 49407, np.int64)
            ids[:, 0] = 49406
            for i in range(batch_size):
                n = int(rng.integers(1, max_length - 1))
                ids[i, 1:n] = rng.integers(0, 49406, n - 1)
            batch = {"image": image, "text_ids": ids}
        if model == "sdxl":
            batch.update(size_cond_fn(batch_size, image_size, image_size))
        if model == "sd3" and t5_max_length:
            batch["t5_text_ids"], batch["t5_text_mask"] = _t5_ids(rng, batch_size, t5_max_length)
        if model in ADAPTER_INPUT:
            key = ADAPTER_INPUT[model]
            batch["text_ids"] = np.zeros_like(ids)
            batch[key] = np.stack([mappers[-1]({"image": im})[key] for im in image])
        yield batch


class _AtLeast:
    """``value >= threshold`` (a class, so that process workers can pickle it)."""

    def __init__(self, threshold: float):
        self.threshold = threshold

    def __call__(self, value) -> bool:
        return value >= self.threshold


def data_mappers(model: str) -> list:
    """The mappers a model's data chain ends in: ``sd15-canny``'s Canny edge
    map of the image (the JAX example's ``CannyEdgeMapper``, key ``edge``)."""
    if model not in ADAPTER_INPUT:
        return []
    from .data import CannyEdgeMapper, CannyEdgeMapperConfig

    return [CannyEdgeMapper(CannyEdgeMapperConfig(key="image"))]


def build_data(cfg: Dict[str, Any], extra_filters_mappers=(), num_workers: Optional[int] = None,
               worker_backend: str = "thread"):
    """The training ``DataPipeline`` over ``cfg["SHARDS_PATH_OR_URLS"]``, the
    port of ``examples/common.py:119-226``: samples with ``jpg`` and
    ``json``, ``caption`` → ``text`` and ``aesthetic_score`` read from the
    JSON, ``jpg`` → ``image`` in [-1, 1], kept when the score is at least
    ``MIN_AESTHETIC_SCORE`` (6.0) or absent; batches of ``BATCH_SIZE``. The
    image, by the config:

    - by default resized to ``IMAGE_SIZE`` square and center-cropped (PIL);
    - with ``ASPECT_BUCKETING``, fitted by ``BucketAssignMapper`` to the
      nearest bucket of ``make_buckets(IMAGE_SIZE, BUCKET_STRIDE (64),
      BUCKET_MAX_ASPECT (2.0))``, cropped at ``BUCKET_CROP`` (center), with
      the real SDXL size tuples; a batch holds one bucket, and the draft
      decode covers ``IMAGE_SIZE · BUCKET_MAX_ASPECT`` unless
      ``DECODE_DRAFT_SIZE`` says otherwise;
    - with ``DECODER: native`` (and no bucketing), decoded, resized,
      cropped and scaled in one call of the native decoder
      (``data/native_decode.py``; JPEG members stay bytes), or by PIL as
      above where that decoder does not build (``is_available()``), as the
      JAX example falls back. The log says which decoder runs."""
    from .data import (
        BucketAssignMapper,
        BucketAssignMapperConfig,
        DataModuleConfig,
        DataPipeline,
        FilterOnCondition,
        FilterOnConditionConfig,
        ImageTransformMapper,
        ImageTransformMapperConfig,
        KeyFilter,
        KeyFilterConfig,
        KeyRenameMapper,
        KeyRenameMapperConfig,
        KeysFromJSONMapper,
        KeysFromJSONMapperConfig,
        MapperWrapper,
        RescaleMapper,
        RescaleMapperConfig,
    )
    from .data import native_decode

    size = cfg.get("IMAGE_SIZE", 512)
    bucketing = bool(cfg.get("ASPECT_BUCKETING", False))
    native = cfg.get("DECODER", "pil") == "native" and not bucketing  # the native path is square
    if native and not native_decode.is_available():
        logger.warning("data: DECODER native is unavailable here (%s); decoding with PIL",
                       native_decode.BUILD_INFO.get("error"))
        native = False
    logger.info("data: %s decoder%s", "native" if native else "PIL",
                ", aspect buckets" if bucketing else f", {size}² center crops")
    if bucketing:
        image_mapper = BucketAssignMapper(BucketAssignMapperConfig(
            key="image", buckets=bucket_ladder(cfg), crop=cfg.get("BUCKET_CROP", "center")))
    elif native:
        image_mapper = native_decode.NativeDecodeMapper(
            native_decode.NativeDecodeMapperConfig(key="image", height=size, width=size))
    else:
        image_mapper = ImageTransformMapper(ImageTransformMapperConfig(key="image", transforms=[
            {"name": "Resize", "size": [size, size]},
            {"name": "CenterCrop", "size": [size, size]},
            {"name": "ToTensor"},
        ]))
    chain = [
        KeyFilter(KeyFilterConfig(keys=["jpg", "json"])),
        MapperWrapper([
            KeysFromJSONMapper(KeysFromJSONMapperConfig(
                key="json", keys_to_extract=["caption", "aesthetic_score"], remove_original=True, strict=False)),
            KeyRenameMapper(KeyRenameMapperConfig(key_map={"jpg": "image", "caption": "text"})),
            image_mapper,
            *([] if native else [RescaleMapper(RescaleMapperConfig(key="image"))]),  # native gives [-1, 1]
        ]),
        FilterOnCondition(FilterOnConditionConfig(condition_key="aesthetic_score", strict=False),
                          _AtLeast(cfg.get("MIN_AESTHETIC_SCORE", 6.0))),
        *extra_filters_mappers,
    ]
    data_cfg = DataModuleConfig(
        shards_path_or_urls=list(cfg["SHARDS_PATH_OR_URLS"]),
        per_worker_batch_size=cfg.get("BATCH_SIZE", 2),
        num_workers=cfg.get("NUM_WORKERS", 2) if num_workers is None else num_workers,
        worker_backend=worker_backend,
        shuffle_buffer_size=cfg.get("SHUFFLE_BUFFER_SIZE", 100),
        # with buckets the draft decode must cover the longest bucket side
        decode_draft_size=cfg.get("DECODE_DRAFT_SIZE",
                                  int(size * cfg.get("BUCKET_MAX_ASPECT", 2.0)) if bucketing else size),
        aspect_bucketing=bucketing,
        decoder="raw_image" if native else "pil",
        seed=cfg.get("SEED", 0),
    )
    return DataPipeline(data_cfg, chain)


def make_tokenizer(model: str, cfg: Dict[str, Any], weights_root: str = ""):
    """texts → token-id arrays for ``model``'s conditioner: CLIP ids for
    SD1.5 and SDXL, T5 ids and mask over ``T5_MAX_LENGTH`` for Pixart, CLIP
    and (with ``USE_T5``) T5 ids for SD3; a local tokenizer under
    ``weights_root`` (``tokenizer/``, SD3's T5 ``tokenizer_3/``), else zero
    ids (an all-ones T5 mask), as the JAX examples fall back; what ``cfg``
    leaves out comes from ``DEFAULTS``. ``sd15-canny``: zero CLIP ids
    whatever the text, as ``train_flash_canny_adapter.py`` sets them."""
    cfg = {**DEFAULTS[model], **cfg}
    if model in ADAPTER_INPUT:
        return lambda texts: {"text_ids": np.zeros((len(texts), 77), np.int64)}
    if model == "pixart":
        return t5_tokenizer(weights_root, cfg["T5_MAX_LENGTH"])
    if model == "sd3":
        return sd3_tokenizer(weights_root, bool(cfg["USE_T5"]), cfg["T5_MAX_LENGTH"])
    return clip_tokenizer(weights_root)


def tokenize_batches(batches, tokenizer, model: str = "sd15", image_size: int = 512):
    """Each batch with ``tokenizer(batch["text"])``'s ids added, and the
    family's extras: SDXL's size tuples where the batch has none
    (``image_size`` square, crop (0, 0)), as ``train_flash_sdxl.py:195-203``
    makes them (a bucketed batch carries its own), and Pixart's
    ``resolution_ar``."""
    for batch in batches:
        batch = dict(batch)
        batch.update(tokenizer(list(batch["text"])))
        n = len(batch["text"])
        if model == "sdxl" and "original_size_as_tuple" not in batch:
            batch.update(size_cond_fn(n, image_size, image_size))
        elif model == "pixart":
            batch["resolution_ar"] = np.tile([float(image_size), float(image_size), 1.0], (n, 1)).astype(np.float32)
        yield batch


def _shards_present(specs) -> bool:
    from .data import expand_shards

    return any(s.startswith(("pipe:", "http://", "https://", "gs://", "s3://")) or
               os.path.isfile(s[len("file://"):] if s.startswith("file://") else s)
               for s in expand_shards(specs or []))


def bucket_ladder(cfg: Dict[str, Any]):
    """The (h, w) buckets of ``ASPECT_BUCKETING`` (``build_data``'s ladder),
    or None without it."""
    if not cfg.get("ASPECT_BUCKETING", False):
        return None
    from .data import make_buckets

    return make_buckets(cfg["IMAGE_SIZE"], cfg.get("BUCKET_STRIDE", 64), cfg.get("BUCKET_MAX_ASPECT", 2.0))


def _discriminator(model: str, denoiser, size: int, buckets=None) -> ConvDiscriminator:
    """Pixart's 64-feature, 3-stage discriminator over the DiT's 4-channel
    output latents, fixed as ``train_flash_pixart.py`` fixes it; SD3's over
    the MMDiT's 16-channel post-mid features (latent-sized: size / 8),
    ``train_flash_sd3.py``'s 4 stages or as many as leave the 4×4 head; a
    UNet's over its mid features, with as many stages as the mid block's
    size leaves the 4×4 head. With ``buckets`` (the ladder of
    ``ASPECT_BUCKETING``, ``bucket_ladder``) the UNet's count comes from the
    shortest side of the buckets' mid features, so that every bucket
    reaches the head (at 1024² with max aspect 2: 704 / 32 = 22, 2 stages).
    Here the port leaves the JAX example's rule
    (``train_flash_sdxl.py:85-89``, from ``IMAGE_SIZE`` alone: 3 stages at
    1024²), which reduces every non-square bucket's mid features below the
    head: 34×30 at the (1088, 960) bucket becomes 4×3."""
    if model == "pixart":
        return ConvDiscriminator(DiscriminatorConfig(feature_dim=64, num_stages=3),
                                 in_channels=denoiser.config.in_channels)
    if model == "sd3":
        fit = int(math.log2(max(size // 8 // 4, 1)))
        return ConvDiscriminator(sd3_discriminator_config(num_stages=min(4, fit)),
                                 in_channels=denoiser.config.in_channels)
    per_mid, features = _MID[FAMILY.get(model, model)]
    side = min(min(hw) for hw in buckets) if buckets else size
    num_stages = max(0, int(math.log2(max(side // per_mid // 4, 1))))
    return ConvDiscriminator(DiscriminatorConfig(feature_dim=features, num_stages=num_stages),
                             in_channels=denoiser.config.block_out_channels[-1])


def build_trainer(
    model: str = "sd15",
    weights_root: str = "",
    device: Union[str, torch.device] = "cuda",
    seed: Optional[int] = None,
    config: Union[str, Dict[str, Any], None] = None,
    frozen_sharding: str = "replicated",
) -> TrainingPipeline:
    """The Flash trainer of ``model`` on ``device`` from a yaml config (a
    path or its dict; the model's ``CONFIGS`` entry by default); ``seed``
    defaults to the config's ``SEED``; the frozen modules are stored in
    bf16, as the JAX examples store them (the adapter of ``sd15-canny``
    too, made from the seed after the other modules). Sets
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False, as ``build_pipeline``.
    In a ``torch.distributed`` group (the default one) the
    trainer is data-parallel over it, the config's ``BATCH_SIZE`` the
    global batch; ``frozen_sharding="fsdp"`` shards the frozen modules
    (``TrainingPipeline``)."""
    if model not in MODELS:
        raise ValueError(f"training of {model!r} is not ported yet (one of {MODELS})")
    config = CONFIGS[model] if config is None else config
    cfg = {**DEFAULTS[model], **(load_config(config) if isinstance(config, str) else config)}
    seed = cfg.get("SEED", 0) if seed is None else seed
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = cfg["LORA_RANK"]
    family = FAMILY.get(model, model)
    sd3 = model == "sd3"
    t5 = {"t5": bool(cfg["USE_T5"]), "t5_max_length": cfg["T5_MAX_LENGTH"]} if sd3 else {}
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with device:
            denoiser, vae, conditioners, towers, _ = build_modules(family, remat=True, **t5)
            disc = _discriminator(model, denoiser, cfg["IMAGE_SIZE"], bucket_ladder(cfg))
            lpips = LPIPS() if cfg["DISTILL_LOSS_TYPE"] == "lpips" else None
            adapter = T2IAdapter(T2IAdapterConfig()) if model in ADAPTER_INPUT else None
        if weights_root:
            load_weights(family, weights_root, denoiser, vae, towers)
        generator = torch.Generator(device=device).manual_seed(seed)
        lora = init_lora(denoiser, rank, generator, device=device)
    kw = dict(
        K=cfg["K"],
        num_iterations_per_K=cfg["NUM_ITERATIONS_PER_K"],
        guidance_scale_min=float(cfg["GUIDANCE_MIN"]),
        guidance_scale_max=float(cfg["GUIDANCE_MAX"]),
        distill_loss_type=cfg["DISTILL_LOSS_TYPE"],
        ucg_keys=cfg.get("UCG_KEYS", ["text", "t5_text"] if t5.get("t5") else ["text"]),
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
        use_empty_prompt=cfg["USE_EMPTY_PROMPT"],
        gan_update_mode=cfg.get("GAN_UPDATE_MODE", "simultaneous"),
        **({"lpips_crop": cfg["LPIPS_CROP"]} if "LPIPS_CROP" in cfg else {}),
    )
    if adapter is not None:
        kw.update(adapter_input_key=ADAPTER_INPUT[model], adapter_conditioning_scale=float(cfg["ADAPTER_CONDITIONING_SCALE"]))
    modules = dict(vae=vae, conditioner=make_conditioner(family, conditioners), discriminator=disc, lpips=lpips,
                   lora_scaling=lora_scaling(rank))
    if sd3:
        flash = FlashDiffusionSD3(
            FlashDiffusionSD3Config(**kw, use_adversarial_loss=cfg.get("USE_ADVERSARIAL_LOSS", True)),
            teacher_module=denoiser, scheduler_config=SD3_SCHEDULER_CONFIG, **modules)
    else:
        flash = FlashDiffusion(
            FlashDiffusionConfig(**kw), teacher_module=denoiser,
            scheduler_config=PIXART_SCHEDULER if model == "pixart" else SchedulerConfig(),
            teacher_scheduler=cfg["TEACHER_SCHEDULER"],
            sampling_scheduler=cfg.get("SAMPLING_SCHEDULER", "LCMScheduler"),
            teacher_sampling_scheduler=cfg["TEACHER_SAMPLING_SCHEDULER"], adapter=adapter, **modules)
    ema = cfg.get("EMA_DECAY")
    train_cfg = TrainingConfig(
        learning_rates=[float(cfg["LR"]), float(cfg.get("LR_DISCRIMINATOR", cfg["LR"]))], seed=seed,
        checkpoint_every_n_steps=int(cfg.get("CKPT_EVERY_N_STEPS", 5000)),
        ema_decay=float(ema) if ema else None,
        gradient_accumulation_steps=int(cfg.get("GRADIENT_ACCUMULATION_STEPS", 1)),
        val_every_n_steps=cfg.get("VAL_EVERY_N_STEPS"))
    offload = int(cfg.get("TEXT_ENCODER_OFFLOAD", 0) or 0) if sd3 else 0
    return TrainingPipeline(flash, train_cfg, lora, device=device, text_encoder_offload=offload,
                            frozen_sharding=frozen_sharding)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="sd15", choices=MODELS)
    ap.add_argument("--config", default=None, help="a yaml config (default: the model's, CONFIGS)")
    ap.add_argument("--weights-root", default=None)
    ap.add_argument("--random-init", action="store_true", help="ignore WEIGHTS_ROOT")
    ap.add_argument("--max-steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", nargs="+", default=None, help="training shards (default: the yaml's)")
    ap.add_argument("--eval-shards", nargs="+", default=None, help="validation shards (VAL_EVERY_N_STEPS)")
    ap.add_argument("--output-dir", default="runs", help="checkpoints, the log and the LoRA file")
    ap.add_argument("--resume", action="store_true", help="restore the latest checkpoint of --output-dir")
    ap.add_argument("--dist-backend", default="nccl", choices=BACKENDS,
                    help="the data-parallel group's backend under torchrun (gloo for ranks that share a card)")
    ap.add_argument("--frozen-sharding", default="replicated", choices=("replicated", "fsdp"),
                    help="fsdp: shard the frozen modules over the ranks (FSDP2)")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    initialize_distributed(args.dist_backend)  # under torchrun; a no-op without a launcher
    if torch.device(args.device).type == "cuda":
        build_kernels_once()
    main_rank = is_main()
    if main_rank:
        os.makedirs(args.output_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(asctime)s %(name)s: %(message)s", handlers=[logging.StreamHandler()] + (
                            [logging.FileHandler(os.path.join(args.output_dir, "train.log"))] if main_rank else []))
    cfg = {**DEFAULTS[args.model], **load_config(args.config or CONFIGS[args.model])}
    if args.shards:
        cfg["SHARDS_PATH_OR_URLS"] = args.shards
    if args.eval_shards:
        cfg["EVAL_SHARDS_PATH_OR_URLS"] = args.eval_shards
    root = "" if args.random_init else (args.weights_root or cfg.get("WEIGHTS_ROOT", ""))
    root = root if root and os.path.isdir(root) else ""
    seed = cfg.get("SEED", 0) if args.seed is None else args.seed
    trainer = build_trainer(args.model, root, device=args.device, seed=seed, config=cfg,
                            frozen_sharding=args.frozen_sharding)
    n_ranks = world_size()
    tc = trainer.config
    tc.log_every_n_steps, tc.checkpoint_dir = 1, os.path.join(args.output_dir, "checkpoints")
    size = cfg["IMAGE_SIZE"]
    if _shards_present(cfg.get("SHARDS_PATH_OR_URLS")):
        from .data import prefetch_to_device

        tokenizer = make_tokenizer(args.model, cfg, root)
        rows = local_batch_slice(cfg["BATCH_SIZE"])  # each rank reads its own shards (data/dataset.py)
        local = {**cfg, "BATCH_SIZE": rows.stop - rows.start}
        data = prefetch_to_device(tokenize_batches(build_data(local, data_mappers(args.model)), tokenizer, args.model,
                                                   size))
        logger.info("data: shards %s", cfg["SHARDS_PATH_OR_URLS"])
    else:
        if args.model == "sd3":
            data = synthetic_batches(cfg["BATCH_SIZE"], size, seed, model="sd3",
                                     t5_max_length=cfg["T5_MAX_LENGTH"] if cfg["USE_T5"] else None)
        else:
            data = synthetic_batches(cfg["BATCH_SIZE"], size, seed, cfg.get("T5_MAX_LENGTH"), args.model)
        if n_ranks > 1:  # the rank's rows of each global batch
            data = (shard_batch(b) for b in data)
        logger.info("data: synthetic batches from seed %d (no shard at %s)", seed, cfg.get("SHARDS_PATH_OR_URLS"))
    eval_data = None
    if _shards_present(cfg.get("EVAL_SHARDS_PATH_OR_URLS")):
        eval_pipe = build_data({**cfg, "SHARDS_PATH_OR_URLS": cfg["EVAL_SHARDS_PATH_OR_URLS"]},
                               data_mappers(args.model))
        eval_tok = make_tokenizer(args.model, cfg, root)
        eval_data = lambda: tokenize_batches(eval_pipe.batches(epoch=0), eval_tok, args.model, size)
    if args.resume:
        _, step = restore_state(tc.checkpoint_dir, trainer)
        if step is None:
            logger.warning("--resume: no checkpoint under %s, starting fresh", tc.checkpoint_dir)
        else:
            logger.info("resumed from step %d", step)
    callbacks = [CheckpointCallback(tc.checkpoint_dir, tc.checkpoint_every_n_steps)]  # fit logs each step
    aux = trainer.fit(data, max_steps=args.max_steps, callbacks=callbacks, eval_data=eval_data)
    if not main_rank:  # rank 0 alone writes the checkpoint and the exports
        return
    print({k: float(v) for k, v in aux.items()})
    if trainer.step and latest_step(tc.checkpoint_dir) != trainer.step:  # so that --resume continues this run
        save_state(tc.checkpoint_dir, trainer.step, trainer.state_dict())
        logger.info("step %d: checkpoint saved to %s", trainer.step, tc.checkpoint_dir)
    out = os.path.join(args.output_dir, "pytorch_lora_weights.safetensors")
    lora = export_lora(trainer)
    save_peft_safetensors(out, lora, prefix=LORA_PREFIX[FAMILY.get(args.model, args.model)])
    print("saved", out)
    if args.model == "sdxl":  # a kohya-format copy for ComfyUI, as train_flash_sdxl.py:231-236 writes
        comfy = os.path.join(args.output_dir, "comfy", "FlashSDXL.safetensors")
        os.makedirs(os.path.dirname(comfy), exist_ok=True)
        save_kohya_safetensors(comfy, lora)
        print("saved", comfy)


if __name__ == "__main__":
    main()
