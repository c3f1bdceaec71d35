"""Rank bodies of the port's parallel tests, run by ``parallel.spawn``.

``tests/test_torch_parallel.py`` (tensor parallelism, the serving channel,
int8 under TP) and ``tests/test_torch_dp_train.py`` (data parallelism and
FSDP) hand these functions their weights and inputs; each runs in a fresh
process of a two-rank gloo group on the CPU and returns its results. Only
torch and the port are imported here: JAX runs in the tests' own process.
Not collected by pytest (no ``test_`` prefix).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from flash_diffusion_tpu_torch.parallel import rank, shard_batch, shard_params_tp

torch.set_num_threads(2)

# the tiny models of the TP forwards: every attention's heads and every
# feed-forward's width split over 2 ranks
UNET15_KW = dict(in_channels=4, out_channels=4, block_out_channels=[16, 32],
                 down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"], layers_per_block=1,
                 num_heads=[2, 2], cross_attention_dim=32, norm_num_groups=8)
UNETXL_KW = dict(in_channels=4, out_channels=4, block_out_channels=[32, 128],
                 down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"], layers_per_block=1,
                 transformer_layers_per_block=[1, 2], num_heads=[1, 4], cross_attention_dim=32, norm_num_groups=8,
                 class_embed_type="projection", projection_class_embeddings_input_dim=24)
DIT_KW = dict(in_channels=4, out_channels=8, patch_size=2, hidden_size=48, depth=2, num_heads=4,
              caption_channels=32, num_vector_embeds=3, vector_embed_dim=16, sample_size=8, interpolation_scale=2.0)
MMDIT_KW = dict(in_channels=16, out_channels=16, patch_size=2, hidden_size=64, depth=2, num_heads=4,
                joint_attention_dim=32, pooled_projection_dim=24, pos_embed_max_size=16, sample_size=8)
CLIP_KW = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, max_positions=16,
               eos_token_id=99)
T5_KW = dict(vocab_size=50, d_model=32, d_ff=48, d_kv=8, num_layers=2, num_heads=4, relative_buckets=8,
             relative_max_distance=16)
KINDS = ("unet15", "unetxl", "dit", "mmdit", "clip", "t5")


def port_model(kind: str) -> torch.nn.Module:
    from flash_diffusion_tpu_torch import models as tm

    build = {
        "unet15": lambda: tm.UNet2DCondition(tm.UNetConfig(**UNET15_KW)),
        "unetxl": lambda: tm.UNet2DCondition(tm.UNetConfig(**UNETXL_KW, use_linear_projection=True)),
        "dit": lambda: tm.DiT(tm.DiTConfig(**DIT_KW)),
        "mmdit": lambda: tm.MMDiT(tm.MMDiTConfig(**MMDIT_KW)),
        "clip": lambda: tm.CLIPTextModel(tm.CLIPTextConfig(**CLIP_KW)),
        "t5": lambda: tm.T5Encoder(tm.T5Config(**T5_KW)),
    }[kind]
    return build().eval()


def run_model(kind: str, net, inputs) -> torch.Tensor:
    t = {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v for k, v in inputs.items()}
    if kind == "clip":
        return net(t["ids"])["last_hidden_state"]
    if kind == "t5":
        return net(t["ids"], t["mask"])
    cond = {k: torch.from_numpy(v) for k, v in inputs["cond"].items()}
    return net(t["x"], t["t"], {"cond": cond})


def _loaded(kind, state):
    net = port_model(kind)
    net.load_state_dict(state)
    return net


@contextlib.contextmanager
def _env(**kw):
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@torch.no_grad()
def tp_forwards(rank_, world, models, x, w):
    """Each model of ``models`` ({kind: (state dict, inputs)}) sharded over
    the group, its forward; then the GEGLU and row-bias sensitivity runs of
    the SD1.5-shaped UNet: its halves split contiguously (the trap), the
    K10 mode (bias on rank 0's epilogue) and the K10 mode with the bias on
    every rank, the K12 mode in bf16 sharded and whole; ``int8_codes`` of
    ``x`` and ``w``; ``shard_batch`` of a batch of 4 and of 3."""
    from flash_diffusion_tpu_torch.models import layers

    out = {"codes": int8_codes(rank_, world, x, w), "rows": shard_batch({"a": np.arange(4), "b": [1, 2, 3, 4],
                                                                        "s": 7})}
    try:
        shard_batch({"a": np.arange(3)})
    except ValueError as e:
        out["odd_batch"] = str(e)
    for kind, (state, inputs) in models.items():
        net = _loaded(kind, state)
        shard_params_tp(net)
        out[kind] = run_model(kind, net, inputs)
    state, inputs = models["unet15"]
    net = _loaded("unet15", state)
    with _patched(layers, "GEGLU", type("NotGEGLU", (), {})):  # tp_plan then splits [a | g] contiguously
        shard_params_tp(net)
    out["geglu_contiguous"] = run_model("unet15", net, inputs)
    net = _loaded("unet15", state)
    shard_params_tp(net)
    with _env(FLASH_TPU_FFN_DOWN_GEMM="1"):
        out["k10"] = run_model("unet15", net, inputs)
        with _patched(layers.dist, "get_rank", lambda group=None: 0):  # every rank adds the bias
            out["k10_bias_twice"] = run_model("unet15", net, inputs)
    whole = _loaded("unet15", state).to(torch.bfloat16)  # the UNet casts its inputs to bf16
    with _env(FLASH_TPU_FFN_FUSED="1"):
        out["k12_whole"] = run_model("unet15", whole, inputs)
        shard_params_tp(whole)
        out["k12"] = run_model("unet15", whole, inputs)
    return out


def int8_codes(rank_, world, x, w):
    """A row-parallel layer's int8 codes: the activations' [T, K] and the
    weight's [N, K], quantized whole and as this rank's K / n columns with
    the group's amax."""
    from flash_diffusion_tpu_torch.parallel import shard_tensor
    from flash_diffusion_tpu_torch.quant import quantize_activation, quantize_weight

    group = torch.distributed.group.WORLD
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    xq, sx = quantize_activation(x)
    wq, sw = quantize_weight(w)
    xq_r, sx_r = quantize_activation(shard_tensor(x, 1, rank_, world), group)
    wq_r, sw_r = quantize_weight(shard_tensor(w, 1, rank_, world), group)
    return {"xq": xq, "sx": sx, "wq": wq, "sw": sw, "xq_r": xq_r, "sx_r": sx_r, "wq_r": wq_r, "sw_r": sw_r}


def tiny_pipeline():
    """A tiny SD1.5-shaped pipeline (the UNet and CLIP of the TP forwards,
    a 2-level VAE), the same on every rank (torch seed 0)."""
    from flash_diffusion_tpu_torch import FlashPipeline
    from flash_diffusion_tpu_torch.models import AutoencoderKL, AutoencoderKLConfig, UNet2DCondition, UNetConfig
    from flash_diffusion_tpu_torch.models.embedders import ClipEmbedder, ClipEmbedderConfig, ConditionerWrapper

    torch.manual_seed(0)
    clip = ClipEmbedder(ClipEmbedderConfig(input_key="text", text_embedder_config=CLIP_KW))
    return FlashPipeline(
        UNet2DCondition(UNetConfig(**UNET15_KW)).eval(), ConditionerWrapper([clip]).eval(),
        AutoencoderKL(AutoencoderKLConfig(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)).eval(),
        tokenizer_fn, latent_shape=(8, 8, 4), vae_scale_factor=2)


def tokenizer_fn(texts):
    ids = np.stack([(np.arange(16) * (len(t) + 3) + sum(map(ord, t))) % 99 for t in texts])
    for i, t in enumerate(texts):
        ids[i, 4 + len(t) % 10] = 99
    return {"text_ids": ids.astype(np.int32)}


PROMPT, SEED = "a raccoon reading a book", 5


def tp_serving(rank_, world, lora_path):
    """The tiny pipeline whole, then sharded and served: a request, a
    ``/loras`` load through the ordered channel, a request, an unload, a
    request; then int8 (min_dim 16) whole and sharded, in lockstep."""
    from flash_diffusion_tpu_torch.serving import ServingConfig, serve_tp_rank

    pipe = tiny_pipeline()
    gen = lambda: pipe.generate([PROMPT], seed=[SEED])
    want = {"base": gen()}
    pipe.load_lora_file(lora_path)
    want["lora"] = gen()
    pipe.unload_lora()
    pipe.shard_tp()
    got = {}

    def drive(server):
        req = lambda: server.handle_generate({"prompt": PROMPT, "seed": SEED}, timeout=120)["images"][0]
        got["base"] = req()
        got["loras_load"] = server.handle_loras({"action": "load", "path": lora_path})
        got["lora"] = req()
        got["bad_load"] = server.handle_loras({"action": "load", "path": lora_path + ".missing"})
        got["loras_unload"] = server.handle_loras({"action": "unload"})
        got["unloaded"] = req()

    config = ServingConfig(port=0, linger_ms=1.0, batch_sizes=(1,), max_batch=1, uint8_images=False)
    serve_tp_rank(pipe, config, on_ready=drive)
    whole = tiny_pipeline()
    whole.quantize("int8", min_dim=16)
    pipe.quantize("int8", min_dim=16)
    int8 = {"whole": whole.generate([PROMPT], seed=[SEED]), "tp": pipe.generate([PROMPT], seed=[SEED])}
    if rank_ != 0:
        return {"int8": int8}
    return {"want": want, "got": {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in got.items()},
            "int8": int8}


def tp_fatal(rank_, world):
    """A dispatch that raises on rank 0 only: its server stops and this
    rank raises; the follower's next collective fails within the group's
    timeout."""
    from flash_diffusion_tpu_torch.serving import ServingConfig, serve_tp_rank

    pipe = tiny_pipeline()
    pipe.shard_tp()
    if rank_ == 0:
        def broken(*a, **kw):
            raise RuntimeError("a fault in rank 0's denoiser")
        pipe.denoiser.forward = broken
    got = {}
    drive = lambda server: got.update(r=server.handle_generate({"prompt": PROMPT, "seed": SEED}, timeout=60))
    serve_tp_rank(pipe, ServingConfig(port=0, linger_ms=1.0, batch_sizes=(1,), max_batch=1), on_ready=drive)
    return got


def tp_loras_out_of_step(rank_, world, lora_path):
    """A ``/loras`` load that works on rank 0 and fails on the follower:
    rank 0's server must stop by itself (not when the driver is done) and
    this rank raise; the follower's ``OutOfStep`` is returned, so that the
    run's error is rank 0's own."""
    import time

    from flash_diffusion_tpu_torch.serving import OutOfStep, ServingConfig, serve_tp_rank

    pipe = tiny_pipeline()
    pipe.shard_tp()
    if rank_ != 0:
        def missing(*a, **kw):
            raise FileNotFoundError(lora_path)
        pipe.load_lora_file = missing
        try:
            serve_tp_rank(pipe, ServingConfig(port=0))
        except OutOfStep as e:
            return {"follower": repr(e)}
        raise AssertionError("the follower stayed in step")

    def drive(server):
        server.handle_loras({"action": "load", "path": lora_path})
        deadline = time.monotonic() + 30.0
        while server.fatal is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if server.fatal is None:
            raise AssertionError("the server kept serving out of step")

    serve_tp_rank(pipe, ServingConfig(port=0, linger_ms=1.0, batch_sizes=(1,), max_batch=1), on_ready=drive)
    return {}


def tp_faults(rank_, world, smoke_path):
    """``chip_smoke.py``'s planted TP faults on the tiny pipeline: the
    request alone in the whole pipeline, then at TP = 2 under each of
    ``TP_FAULTS``; the final latents."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", smoke_path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    pipe = tiny_pipeline()
    run = lambda: pipe.generate([PROMPT], seed=[SEED], decode=False)[0]
    alone = run()
    pipe.shard_tp()
    return {"alone": alone, "faults": cs.run_tp_faults(pipe, run)}


# ---------------------------------------------------------------- data parallel
def _rows(t, rank_, world):
    b = t.shape[0] // world
    return t[rank_ * b:(rank_ + 1) * b]


def dp_grads(rank_, world, spec):
    """One ``train_step`` of a trainer over the JAX-converted weights, this
    rank's rows of the staged batch, the global batch's draws (``draw``
    returns ``spec["draws"]``, sliced by the trainer); returns the averaged
    LoRA and discriminator gradients and the step's aux."""
    from flash_diffusion_tpu_torch.distill import ConvDiscriminator, DiscriminatorConfig, FlashDiffusion, \
        FlashDiffusionConfig
    from flash_diffusion_tpu_torch.models import UNet2DCondition, UNetConfig
    from flash_diffusion_tpu_torch.trainer import TrainingConfig, TrainingPipeline

    unet = UNet2DCondition(UNetConfig(**spec["unet_kw"]))
    unet.load_state_dict(spec["unet"])
    dcfg = DiscriminatorConfig(**spec["disc_kw"])
    disc = ConvDiscriminator(dcfg, in_channels=spec["disc_in"])
    disc.load_state_dict(spec["disc"])
    model = FlashDiffusion(FlashDiffusionConfig(**spec["flash_kw"]), unet, discriminator=disc, lora_scaling=0.5)
    model.draw = lambda generator, stage, latent: spec["draws"]
    tc = TrainingConfig(optimizers_name=["SGD", "SGD"], learning_rates=[1e-3, 1e-3])
    tr = TrainingPipeline(model, tc, spec["lora"], device="cpu", frozen_dtype=None)
    z, conds = spec["z"], spec["conds"]
    batch = {"__z": _rows(z, rank_, world),
             "__conds": tuple({"cond": {"crossattn": _rows(c, rank_, world)}} for c in conds)}
    aux = tr.train_step(batch, spec["stage"])
    return {"aux": aux, "lora": {n: {k: t.grad for k, t in ab.items()} for n, ab in tr.lora.items()},
            "disc": {n: p.grad for n, p in tr.model.discriminator.named_parameters()}}


def tiny_trainer(cfg_kw=None, train_kw=None, frozen_sharding="replicated", seed=0, offload=0, targets=None):
    """The tiny SD1.5-shaped trainer of ``tests/test_torch_trainer_run.py``
    (``remat``, a VAE, a 1-layer CLIP, a 1-stage discriminator; l2, DMD,
    hinge GAN, K = [2, 2]) with SGD, fp32, from ``seed``; data-parallel
    over the default group when there is one. ``offload``: the text
    towers' bursts; ``targets``: the LoRA's (``CONV_TARGETS``: conv pairs
    too)."""
    from flash_diffusion_tpu_torch.distill import ConvDiscriminator, DiscriminatorConfig, FlashDiffusion, \
        FlashDiffusionConfig
    from flash_diffusion_tpu_torch.lora import DEFAULT_TARGETS, init_lora
    from flash_diffusion_tpu_torch.models import AutoencoderKL, AutoencoderKLConfig, UNet2DCondition, UNetConfig
    from flash_diffusion_tpu_torch.models.embedders import ClipEmbedder, ClipEmbedderConfig, ConditionerWrapper
    from flash_diffusion_tpu_torch.trainer import TrainingConfig, TrainingPipeline

    torch.manual_seed(seed)
    unet = UNet2DCondition(UNetConfig(**DP_UNET_KW, remat=True))
    vae = AutoencoderKL(AutoencoderKLConfig(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8))
    clip = ConditionerWrapper([ClipEmbedder(ClipEmbedderConfig(input_key="text", ucg_rate=0.5, text_embedder_config=dict(
        vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, max_positions=8,
        eos_token_id=63)))])
    disc = ConvDiscriminator(DiscriminatorConfig(feature_dim=8, num_stages=1), in_channels=32)
    kw = {**dict(K=[2, 2], num_iterations_per_K=[2, 2], distill_loss_type="l2", mixture_num_components=2,
                 use_dmd_loss=True, adversarial_loss_scale=0.5), **(cfg_kw or {})}
    model = FlashDiffusion(FlashDiffusionConfig(**kw), unet, vae=vae, conditioner=clip, discriminator=disc)
    lora = init_lora(unet, 2, torch.Generator().manual_seed(1), targets=targets or DEFAULT_TARGETS)
    for ab in lora.values():  # B ≠ 0: A has a gradient too
        ab["b"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
    tc = TrainingConfig(optimizers_name=["SGD", "SGD"], learning_rates=[1e-2, 1e-2], seed=seed, **(train_kw or {}))
    return TrainingPipeline(model, tc, lora, device="cpu", frozen_dtype=None, frozen_sharding=frozen_sharding,
                            text_encoder_offload=offload)


DP_UNET_KW = dict(in_channels=4, out_channels=4, block_out_channels=[16, 32],
                  down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"], layers_per_block=1,
                  transformer_layers_per_block=[1, 1], num_heads=[2, 2], cross_attention_dim=16, norm_num_groups=8)
DP_BATCH, DP_HW = 4, 32
# the dense targets and every resnet convolution: a tree with conv pairs
CONV_TARGETS = (r".*\.(to_q|to_k|to_v|to_out\.0|proj_in|proj_out|ff\.net\.0\.proj|ff\.net\.2)$",
                r".*resnets\.\d+\.(conv1|conv2)$")


def global_batches(n, seed=21):
    rng = np.random.default_rng(seed)
    return [{"image": rng.uniform(-1, 1, (DP_BATCH, DP_HW, DP_HW, 3)).astype(np.float32),
             "text_ids": rng.integers(0, 63, (DP_BATCH, 8))} for _ in range(n)]


def trainable(tr):
    out = {f"lora.{n}.{k}": v.detach().clone() for n, ab in tr.lora.items() for k, v in ab.items()}
    out.update({f"disc.{k}": v.detach().clone() for k, v in tr.model.discriminator.state_dict().items()})
    return out


def teacher_weights(tr):
    """The teacher's state, whole (an FSDP shard gathered), by the layers'
    own names (a merged-weights layer's W under ``weight``)."""
    from torch.distributed.tensor import DTensor

    return {k.replace("parametrizations.weight.original", "weight"):
            (v.full_tensor() if isinstance(v, DTensor) else v).detach().clone()
            for k, v in tr.model.teacher_module.state_dict().items()}


def in_chunks(t: torch.Tensor, chunks) -> bool:
    """Whether ``t``'s data lies in one of the byte ``chunks``."""
    p = t.data_ptr()
    return any(c.data_ptr() <= p < c.data_ptr() + c.numel() for c in chunks)


def watch_towers(tr):
    """Wrap ``tr``'s conditioning so that each call records, for every text
    tower parameter, (its local numel, its numel) and whether its local
    data lies in the offload's device copy; returns the record."""
    seen, encode = [], tr.model._conditionings

    def watched(*args, **kw):
        local = _locals(tr.model.conditioner)
        seen.append({"sizes": [(t.numel(), p.numel()) for t, p in zip(local, tr.model.conditioner.parameters())],
                     "placed": all(in_chunks(t, tr._towers._device_chunks) for t in local if t.numel())})
        return encode(*args, **kw)

    tr.model._conditionings = watched
    return seen


def run_fit(cfg_kw=None, train_kw=None, frozen_sharding="replicated", steps=2, sharded=True, **kw):
    """``fit`` of ``tiny_trainer`` (``kw``: its ``offload`` and ``targets``)
    over ``global_batches`` (each rank's rows when ``sharded``): the
    trainable state and the logged losses by step."""
    from flash_diffusion_tpu_torch.trainer import MetricLogger

    tr = tiny_trainer(cfg_kw, train_kw, frozen_sharding, **kw)
    data = global_batches(steps)
    hist = MetricLogger(1)
    tr.fit([shard_batch(b) for b in data] if sharded else data, max_steps=steps, callbacks=[hist])
    return tr, {"state": trainable(tr), "losses": [h for _, h in hist.history]}


def tiny_sd3_patches(kw):
    """``sample``'s SD3 configs replaced by tiny ones (``kw``: the MMDiT's,
    the VAE's, the CLIP-L, CLIP-G and T5 towers' and the joint width, as
    ``tests/test_torch_sd3_train.py`` sets them): (module, name, value)."""
    from flash_diffusion_tpu_torch import sample
    from flash_diffusion_tpu_torch.models import MMDiTConfig, sd3_vae_config
    from flash_diffusion_tpu_torch.models.embedders import T5TextEmbedderConfig

    clip = sample._sd3_clip
    return [
        (sample, "_sd3_clip", lambda **k: clip(**(dict(kw["clip_g"], projection_dim=32) if k.get("hidden_size") == 1280
                                                  else dict(kw["clip"], projection_dim=16)))),
        (sample, "sd3_medium_config", lambda **k: MMDiTConfig(**kw["mmdit"], **k)),
        (sample, "sd3_vae_config", lambda **k: sd3_vae_config(**kw["vae"], **k)),
        (sample, "T5TextEmbedderConfig", lambda **k: T5TextEmbedderConfig(**k, text_embedder_config=kw["t5"])),
        (sample, "SD3_JOINT_DIM", kw["joint"]),
    ]


def sd3_fit(kw, frozen_sharding):
    """One ``fit`` step of ``build_trainer("sd3")`` on ``flash_sd3.yaml`` (T5
    on, the towers offloaded in bursts of the yaml's 4) at 64², stage 1, K
    = 4, over tiny modules, each rank on its rows of the yaml's global
    batch of 2: the LoRA after the step, the logged losses and the moves."""
    from flash_diffusion_tpu_torch import train
    from flash_diffusion_tpu_torch.trainer import MetricLogger

    cfg = {**train.load_config(train.CONFIGS["sd3"]), "LORA_RANK": 4, "IMAGE_SIZE": 64, "K": [4] * 4,
           "NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000]}
    with contextlib.ExitStack() as stack:
        for obj, name, value in tiny_sd3_patches(kw):
            stack.enter_context(_patched(obj, name, value))
        tr = train.build_trainer("sd3", device="cpu", config=cfg, frozen_sharding=frozen_sharding)
    hist = MetricLogger(1)
    data = train.synthetic_batches(cfg["BATCH_SIZE"], cfg["IMAGE_SIZE"], model="sd3")
    tr.fit((shard_batch(b) for b in data), max_steps=1, callbacks=[hist])
    return {"lora": {f"{n}.{k}": v.detach().clone() for n, ab in tr.lora.items() for k, v in ab.items()},
            "losses": [h for _, h in hist.history], "moves": len(tr.offload_moves),
            "offload": tr.text_encoder_offload}


def dp_all(rank_, world, spec):
    """``dp_grads`` then ``dp_fits`` in one group."""
    return {"grads": dp_grads(rank_, world, spec), "fits": dp_fits(rank_, world, spec["sd3"])}


def dp_fits(rank_, world, sd3_kw):
    """Two steps of the simultaneous mode, two of the alternating mode with
    accumulation 2, one step under FSDP beside one replicated; then
    ``switch_teacher``'s merge under both. Then FSDP beside replicated with
    the text towers offloaded (bursts of 2, 3 steps, the towers watched in
    each encode), on a tree with conv pairs and with ``lora_mode="merge"``
    on the dense tree (each merged into the teacher after the step), and
    ``build_trainer("sd3")``'s step (``sd3_fit``)."""
    from flash_diffusion_tpu_torch.trainer import MetricLogger

    out = {}
    _, out["simultaneous"] = run_fit()
    _, out["alternating"] = run_fit({"gan_update_mode": "alternating"}, {"gradient_accumulation_steps": 2})
    rep, out["replicated_1"] = run_fit(steps=1)
    fsdp, out["fsdp_1"] = run_fit(frozen_sharding="fsdp", steps=1)
    for name, tr in (("replicated", rep), ("fsdp", fsdp)):
        tr.model.merge_lora_into_teacher(tr.lora)
        out[f"merged_{name}"] = teacher_weights(tr)
    for sharding in ("replicated", "fsdp"):
        tr = tiny_trainer(frozen_sharding=sharding, offload=2)
        seen = watch_towers(tr)
        data = [shard_batch(b) for b in global_batches(3)]
        hist = MetricLogger(1)
        tr.fit(data, max_steps=3, callbacks=[hist])
        out[f"offload_{sharding}"] = {
            "state": trainable(tr), "losses": [h for _, h in hist.history], "moves": len(tr.offload_moves),
            "seen": seen, "released": all(in_chunks(t, tr._towers._host) for t in _locals(tr.model.conditioner))}
    for tree, kw in (("conv", dict(targets=CONV_TARGETS)), ("merge", dict(cfg_kw={"lora_mode": "merge"}))):
        for sharding in ("replicated", "fsdp"):
            tr, out[f"{tree}_{sharding}"] = run_fit(frozen_sharding=sharding, steps=1, **kw)
            out[f"{tree}_{sharding}"]["merged_student"] = tr.model.merged_student
            out[f"{tree}_{sharding}"]["exports"] = exports_round_trip(tr)
            tr.model.merge_lora_into_teacher(tr.lora)
            out[f"{tree}_{sharding}"]["merged"] = teacher_weights(tr)
    out["sd3"] = {sharding: sd3_fit(sd3_kw, sharding) for sharding in ("replicated", "fsdp")}
    out["rank"] = rank()
    return out


def exports_round_trip(tr) -> bool:
    """The trained tree read back bit for bit from its PEFT and kohya
    exports, the kohya names resolved against the (sharded) student."""
    from flash_diffusion_tpu_torch.lora import from_kohya, from_peft, to_kohya, to_peft

    want = {n: {k: v.detach() for k, v in ab.items()} for n, ab in tr.lora.items()}
    peft, _ = from_peft(to_peft(want))
    kohya, _ = from_kohya(to_kohya(want), tr.model.student_module)
    return all(torch.equal(back[n][k], want[n][k]) for back in (peft, kohya) for n in want for k in ("a", "b"))


def _locals(module):
    """Each parameter's local data (an FSDP shard's, or the tensor)."""
    from torch.distributed.tensor import DTensor

    return [p.to_local() if isinstance(p, DTensor) else p for p in module.parameters()]
