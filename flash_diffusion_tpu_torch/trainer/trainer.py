"""Training pipeline of the port: the Flash training run.

Port of ``flash_diffusion_tpu/trainer/trainer.py:48-491``:

- the frozen modules (teacher UNet, DiT or MMDiT, VAE, T2I-Adapter, text
  conditioner, LPIPS) are stored in ``frozen_dtype`` (bf16); the denoiser,
  the VAE and the adapter compute in it, as their JAX modules do
  (dtype=bf16), and the adapter is in no optimizer; CLIP, T5 and LPIPS
  are fp32 flax modules in JAX that promote the bf16-stored weights at use,
  so here their weights are rounded through ``frozen_dtype`` and kept in
  fp32, the same numbers (SD3's CLIP-L, CLIP-G and T5-XXL inside its
  ``SD3Conditioner`` too; a param-less conditioner, Pixart's
  ``RawVectorEmbedder``, passes through). A parity trap: T5-XXL's weights are bf16-rounded in
  training but fp32 as loaded in sampling (``sample.build_pipeline``), so
  the two give different text states from one checkpoint;
- the LoRA factors, the discriminator, the optimizer state and the EMA
  stay fp32 (Adam's first moment in ``adam_mu_dtype``);
- per step: the conditioning and the VAE encode are staged under
  ``no_grad`` (the JAX ``__conds``/``__z``), each from a generator of its
  own seeded by the seed and the step (JAX folds the step into its key),
  so that offloaded, resident and resumed runs draw alike; then one
  ``losses`` and one backward. Simultaneous mode: loss_G + loss_D, both
  updates. Alternating mode (``gan_update_mode``): the global step's parity
  picks ``"g"`` (even: only the LoRA has a gradient and an update) or
  ``"d"`` (odd: only the discriminator), so a resumed run keeps it;
- gradient accumulation is the optimizers' (``training_config.Optimizer``,
  optax ``MultiSteps``); the EMA student (``ema_decay``) moves only when the
  generator's optimizer applies an update, never on a ``"d"`` step;
- ``switch_teacher``: at a stage boundary whose K changes, the LoRA is
  merged into the teacher's weights, which the student shares;
- text-encoder offload (``text_encoder_offload`` = n): the towers live on
  the host and move to the device once for each burst of n batches, whose
  conditioning is computed then; callbacks that sample use
  ``sampling_frozen()``, which places them for the block. The host copies
  are packed into pinned chunks (``parallel/offload.py HostOffload``); one
  placement is one entry of ``offload_moves``. Under FSDP the towers are
  sharded block by block and a rank's shards are what moves: during a
  burst each block is gathered from them in its own forward, as JAX places
  the offloaded towers with the FSDP sharding at each burst
  (``trainer.py:305-330``);
- ``evaluate``: averaged loss aux over held-out batches with fixed
  generators, from ``fit`` every ``val_every_n_steps``; ``state_dict`` and
  ``load_state_dict`` carry the trainable state (``checkpoint.py``).

The step runs eagerly; the stages are ``record_function`` spans
(``fdt.train.encode``/``.backward``/``.optimizer`` here, the loss stages in
``distill/flash.py``), read by ``profiling.py --train``.

Data parallel (JAX ``trainer.py:77-121``: a data axis over the mesh), one
process per GPU in the default ``torch.distributed`` group (``parallel/mesh.py``):
each rank steps on its rows of the global batch (the yaml's
``BATCH_SIZE``), the LoRA and discriminator gradients are averaged over
the group after the backward and before the optimizers' ``step`` (one
all-reduce of the flattened gradients), so that accumulation, the EMA,
WGAN clipping and ``switch_teacher`` run alike on every rank; the step's
scalar losses are the group's mean. Every random draw is the global
batch's, from the generators every rank holds alike, sliced to the rank's
rows: ``draw`` (step-level scalars as they are, per-sample tensors cut)
and the VAE encode's noise (the conditioning's drops are one scalar a
conditioner). So N ranks step as one process at the global batch. The LoRA
and the discriminator are broadcast from rank 0 at the start. Only rank 0
logs; the callbacks write on rank 0 (``loggers.py``).

``frozen_sharding="fsdp"`` (JAX ``shard_params_fsdp`` of the frozen trees)
shards the frozen modules with FSDP2 (``torch.distributed.fsdp.
fully_shard``: the parameters split over the group, gathered for each
forward): the denoiser and the text towers block by block, the VAE,
LPIPS and the adapter. The student then shares the sharded denoiser as
one module: the LoRA pairs attach to it before it is sharded, and the
teacher is the same module under ``models/layers.py lora_disabled()``
(``TeacherView``; a checkpointed block's recompute keeps its forward's
setting), so that ``switch_teacher``'s merge writes the shards the
student reads. On the side path the pairs sit beside the gathered
weights; on the merged path (``lora_mode="merge"``, or a conv pair) each
targeted weight's parametrization merges W + scaling·Δ on the weight FSDP
gathered for the forward, and gives W alone to the teacher, as GSPMD
partitions JAX's merge over the sharded tree (``parallel/mesh.py:91-116``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import time
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..distill.losses import clip_disc_weights
from ..lora import LoraTree
from ..models.layers import lora_disabled
from ..parallel.mesh import all_reduce_, is_main, rank, replicate, world_size
from ..parallel.offload import HostOffload
from ..utils.ema import init_ema, update_ema
from .training_config import TrainingConfig

logger = logging.getLogger(__name__)


def _fsdp_units(module: torch.nn.Module):
    """The submodules of ``module`` to shard as units of their own, the
    innermost first: the denoisers' blocks, the text towers and their
    layers. T5's first block stays in its encoder's unit: ``T5Encoder``
    reads its relative-position table before the blocks run."""
    from ..models.dit import PixartBlock
    from ..models.layers import BasicTransformerBlock, ResnetBlock2D, SpatialTransformer
    from ..models.mmdit import JointBlock
    from ..models.text_encoders import CLIPTextModel, T5Encoder, _CLIPLayer, _T5Block

    units = (BasicTransformerBlock, ResnetBlock2D, SpatialTransformer, PixartBlock, JointBlock, _CLIPLayer,
             _T5Block, CLIPTextModel, T5Encoder)
    first_t5 = {id(m.encoder.block[0]) for m in module.modules() if isinstance(m, T5Encoder)}
    return [m for m in reversed(list(module.modules())) if isinstance(m, units) and id(m) not in first_t5]


class TeacherView:
    """The teacher of the FSDP mode: the student's sharded denoiser called
    with its LoRA pairs off (``lora_disabled``); every other attribute is
    the module's."""

    def __init__(self, module: torch.nn.Module):
        self.module = module

    def __call__(self, *args, **kwargs):
        with lora_disabled():
            return self.module(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.module, name)


def export_lora(pipeline: "TrainingPipeline") -> LoraTree:
    """The LoRA tree to publish: the EMA student when it is tracked, else
    the live one."""
    return pipeline.ema if pipeline.ema is not None else pipeline.lora


class TrainingPipeline:
    """Drives a ``FlashDiffusion``(``SD3``). ``fit`` feeds batches, steps,
    validates and calls the callbacks."""

    def __init__(
        self,
        model,
        config: TrainingConfig,
        lora: LoraTree,
        frozen_dtype: Optional[torch.dtype] = torch.bfloat16,
        device=None,
        text_encoder_offload: int = 0,
        frozen_sharding: str = "replicated",
    ):
        self.model, self.config = model, config
        self.device = torch.device(device) if device is not None else next(
            model.teacher_module.parameters()).device
        if frozen_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"frozen_sharding is replicated or fsdp, not {frozen_sharding!r}")
        self.world, self.rank = world_size(), rank()
        self.frozen_sharding = frozen_sharding
        adapter = model.adapter
        for m in (model.teacher_module, model.vae, adapter, model.conditioner, model.lpips):
            if m is not None:
                m.requires_grad_(False).eval()
        if frozen_dtype is not None:
            for m in (model.teacher_module, model.vae, adapter):
                if m is not None:
                    m.to(frozen_dtype)
            with torch.no_grad():  # fp32 modules over bf16-rounded weights
                for m in (model.conditioner, model.lpips):
                    for p in (m.parameters() if m is not None else ()):
                        p.copy_(p.to(frozen_dtype))
        self.lora = {name: {k: t.detach().to(self.device, torch.float32).requires_grad_()
                            for k, t in ab.items()} for name, ab in lora.items()}
        replicate(self._lora_leaves())
        if frozen_sharding == "fsdp":
            self._shard_frozen()
        else:
            model.attach_lora(self.lora)
        self.opt_g = config.build_optimizer(0, self._lora_leaves())
        disc = model.discriminator
        self.opt_d = None
        if disc is not None:
            disc.float().requires_grad_(True).train()
            replicate(disc)
            self.opt_d = config.build_optimizer(1, list(disc.parameters()))
        self.ema = init_ema(self.lora) if config.ema_decay else None
        self.is_wgan = model.config.gan_loss_type == "wgan"
        self.alternating = model.config.gan_update_mode == "alternating"
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.data_wait_s = 0.0  # seconds fit waited on its data iterator
        self.offload_moves = []  # seconds of each host → device move of the towers
        self.last_val: Dict[str, float] = {}
        self.text_encoder_offload = int(text_encoder_offload)
        self._towers = None  # HostOffload of the conditioner while offloaded
        if self.text_encoder_offload and model.conditioner is not None:
            self._towers = HostOffload(model.conditioner, self.device)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def _lora_leaves(self):
        return [t for ab in self.lora.values() for t in ab.values()]

    def _shard_frozen(self) -> None:
        """FSDP2 over the frozen modules; the student is the sharded
        denoiser with the LoRA attached (before the sharding, so that FSDP
        manages a merged layer's own weight), the teacher its
        ``TeacherView``."""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

        model = self.model
        mesh = init_device_mesh(self.device.type, (self.world,))
        denoiser = model.teacher_module
        model.attach_lora(self.lora, module=denoiser)
        for m in (denoiser, model.vae, model.conditioner, model.lpips, model.adapter):
            if m is None or not any(True for _ in m.parameters()):
                continue
            for unit in _fsdp_units(m):  # each called through its forward, which gathers it
                fully_shard(unit, mesh=mesh)
            fully_shard(m, mesh=mesh)
        if model.vae is not None:
            for method in ("encode", "decode_latents"):
                register_fsdp_forward_method(model.vae, method)
        model.teacher_module = TeacherView(denoiser)

    def _draw(self, generator: torch.Generator, stage: int, z: torch.Tensor) -> Dict[str, Any]:
        """``model.draw`` of the global batch, cut to this rank's rows."""
        if self.world == 1:
            return self.model.draw(generator, stage, z)
        b = z.shape[0]
        draws = self.model.draw(generator, stage, z.new_empty((b * self.world, *z.shape[1:])))
        rows = slice(self.rank * b, (self.rank + 1) * b)
        cut = lambda v: v[rows] if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == b * self.world else v
        return {k: [cut(x) for x in v] if isinstance(v, list) else cut(v) for k, v in draws.items()}

    def _average(self, tensors) -> None:
        """Average the tensors over the group in place (one all-reduce)."""
        tensors = list(tensors)
        if self.world == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        all_reduce_(flat, "avg")
        at = 0
        for t in tensors:
            t.copy_(flat[at: at + t.numel()].view_as(t))
            at += t.numel()

    def _generator(self, step: int, stream: int) -> torch.Generator:
        """The staging generator of ``step``: stream 0 the conditioning's
        unconditional drops, 1 the VAE encode's noise."""
        seed = (((self.config.seed ^ 0x5EED) << 32) + 2 * int(step) + stream) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Arrays and tensors on the device, floats as fp32 and integers as
        int64; other entries (captions) as they are."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, (np.ndarray, torch.Tensor)):
                v = torch.as_tensor(v).to(self.device, non_blocking=True)
                out[k] = v.float() if v.is_floating_point() else v.long()
            else:
                out[k] = v
        return out

    # ------------------------------------------------------------------ offload
    @contextlib.contextmanager
    def sampling_frozen(self):
        """The text towers on the device for the block: with the offload on,
        they are placed on entry (one entry of ``offload_moves``, its
        seconds) and go back to the host on exit."""
        if self._towers is None:
            yield
            return
        t0 = time.perf_counter()
        self._towers.place()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.offload_moves.append(time.perf_counter() - t0)
        try:
            yield
        finally:
            self._towers.release()

    def _bursts(self, batches: Iterator, step0: int, callbacks=()):
        """(host batch, its conditioning) with the conditioning computed in
        bursts of ``text_encoder_offload`` batches, the towers on the device
        only while a burst encodes."""
        step, key = step0, self.model.config.input_key
        while True:
            chunk = list(itertools.islice(batches, self.text_encoder_offload))
            if not chunk:
                return
            out = []
            with self.sampling_frozen(), record_function("fdt.train.encode"), torch.no_grad():
                for b in chunk:
                    ids = self.to_device({k: v for k, v in b.items() if k != key})
                    out.append((b, self.model._conditionings(ids, self._generator(step, 0))))
                    step += 1
            for cb in callbacks:
                if hasattr(cb, "after_burst"):
                    cb.after_burst(self)
            yield from out

    # ------------------------------------------------------------------ step
    def stage_batch(self, batch: Dict[str, Any], step: Optional[int] = None, conds=None) -> Dict[str, Any]:
        """The batch on the device with ``__conds`` (``conds`` when given;
        offloaded towers are placed for the encode) and ``__z`` staged, from
        the generators of ``step`` (the trainer's step by default)."""
        model = self.model
        step = self.step if step is None else step
        batch = self.to_device(batch)
        with record_function("fdt.train.encode"), torch.no_grad():
            if conds is not None:
                batch["__conds"] = conds
            elif model.conditioner is not None:
                with self.sampling_frozen():
                    batch["__conds"] = model._conditionings(batch, self._generator(step, 0))
            if model.vae is not None:
                batch["__z"] = self._encode(batch, self._generator(step, 1))
        return batch

    def _encode(self, batch: Dict[str, Any], generator: torch.Generator) -> torch.Tensor:
        model = self.model
        x = batch[model.config.input_key]
        vcfg = model.vae.config
        f = 2 ** (len(vcfg.block_out_channels) - 1)
        b = x.shape[0]  # the global batch's noise, this rank's rows
        noise = torch.randn((b * self.world, x.shape[1] // f, x.shape[2] // f, vcfg.latent_channels),
                            generator=generator, device=self.device)[self.rank * b:(self.rank + 1) * b]
        return model._encode(batch, noise)

    def _set_trainable(self, lora: bool, disc: bool) -> None:
        for t in self._lora_leaves():
            t.requires_grad_(lora)
        if self.model.discriminator is not None:
            self.model.discriminator.requires_grad_(disc)

    def train_step(self, batch: Dict[str, Any], stage: int, phase: Optional[str] = None) -> Dict[str, Any]:
        """One step on a staged batch: ``losses``, one backward, the updates
        of ``phase`` (None: both; ``"g"``: the LoRA's; ``"d"``: the
        discriminator's), the EMA when the LoRA's optimizer applied one."""
        model = self.model
        g_on = phase != "d"
        d_on = phase != "g" and self.opt_d is not None
        draws = self._draw(self.generator, stage, batch["__z"])
        self.opt_g.zero_grad()
        if self.opt_d is not None:
            self.opt_d.zero_grad()
        self._set_trainable(g_on, d_on)
        try:
            total, aux = model.losses(batch, draws, stage)
            with record_function("fdt.train.backward"):
                if total.requires_grad:
                    total.backward()
        finally:
            self._set_trainable(True, True)
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
        if self.world > 1:
            with record_function("fdt.train.all_reduce"), torch.no_grad():
                params = (self._lora_leaves() if g_on else []) + (
                    list(model.discriminator.parameters()) if d_on else [])
                self._average(p.grad for p in params if p.grad is not None)
                self._average(v for v in aux.values() if isinstance(v, torch.Tensor) and v.dim() == 0)
        with record_function("fdt.train.optimizer"):
            applied = self.opt_g.step() if g_on else False
            if d_on:
                self.opt_d.step()
                if self.is_wgan:
                    clip_disc_weights(model.discriminator, self.config.wgan_clip)
            if self.ema is not None and applied:
                update_ema(self.ema, self.lora, self.config.ema_decay)
        self.step += 1
        return aux

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def evaluate(self, data: Iterable[Dict[str, Any]], stage: int = 0, max_batches: int = 8) -> Dict[str, float]:
        """Scalar loss aux averaged over up to ``max_batches`` held-out
        batches, no update; every batch staged and drawn from the same fixed
        generators (seeds 0, 1 and 0, as JAX's fixed keys)."""
        model, sums, n = self.model, {}, 0
        with self.sampling_frozen():
            for i, batch in enumerate(data):
                if i >= max_batches:
                    break
                batch = self.to_device(batch)
                fixed = lambda s: torch.Generator(device=self.device).manual_seed(s)
                if model.conditioner is not None:
                    batch["__conds"] = model._conditionings(batch, fixed(0))
                if model.vae is not None:
                    batch["__z"] = self._encode(batch, fixed(1))
                _, aux = model.losses(batch, model.draw(fixed(0), stage, batch["__z"]), stage)
                for k, v in aux.items():
                    if np.ndim(v) == 0:
                        sums[k] = sums.get(k, 0.0) + float(v)
                n += 1
        if self.world > 1:  # the group's mean over every rank's batches
            keys = sorted(sums)
            t = torch.tensor([sums[k] for k in keys] + [float(n)], dtype=torch.float64, device=self.device)
            all_reduce_(t, "sum")
            sums, n = dict(zip(keys, t[:-1].tolist())), t[-1].item()
        return {f"val/{k}": v / max(n, 1) for k, v in sums.items()}

    # ------------------------------------------------------------------ state
    def state_dict(self) -> Dict[str, Any]:
        """The trainable state: LoRA, discriminator, both optimizers, EMA,
        step and the step generator's state (tensors referenced)."""
        disc = self.model.discriminator
        return {
            "lora": {name: dict(ab) for name, ab in self.lora.items()},
            "disc": disc.state_dict() if disc is not None else {},
            "opt_g": self.opt_g.state_dict(),
            "opt_d": self.opt_d.state_dict() if self.opt_d is not None else None,
            "ema": self.ema,
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for name, ab in self.lora.items():
            for k, t in ab.items():
                t.copy_(state["lora"][name][k])
        if self.model.discriminator is not None:
            self.model.discriminator.load_state_dict(state["disc"])
        self.opt_g.load_state_dict(state["opt_g"])
        if self.opt_d is not None:
            self.opt_d.load_state_dict(state["opt_d"])
        if (self.ema is None) != (state["ema"] is None):
            raise ValueError("the checkpoint's EMA and this trainer's ema_decay disagree")
        if self.ema is not None:
            for name, ab in self.ema.items():
                for k, t in ab.items():
                    t.copy_(state["ema"][name][k])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])

    # ------------------------------------------------------------------ fit
    def _timed(self, batches: Iterator) -> Iterator:
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            self.data_wait_s += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    def fit(self, data: Iterable[Dict[str, Any]], max_steps: Optional[int] = None, callbacks=(),
            eval_data=None) -> Dict[str, Any]:
        """Train on ``data`` (dicts with ``image`` [B, H, W, 3] in [-1, 1] and
        the token ids) from the trainer's step (a restored one included)
        until ``max_steps`` micro-steps; ``callbacks`` are called after each
        step; with ``eval_data`` (a factory of fresh iterators) and
        ``val_every_n_steps``, ``evaluate`` runs at that cadence
        (``last_val``). Returns the last step's aux."""
        cfg, model = self.config, self.model
        max_steps = max_steps or cfg.max_steps or sum(model.config.num_iterations_per_K)
        batches = self._timed(iter(data))
        if self._towers is not None:
            items = self._bursts(batches, self.step, callbacks)
        else:
            items = ((b, None) for b in batches)
        aux: Dict[str, Any] = {}
        prev_stage = model.stage_for_iteration(max(self.step, 1))
        t0 = time.perf_counter()
        while self.step < max_steps:
            item = next(items, None)
            if item is None:
                break
            batch, conds = item
            step = self.step
            stage = model.stage_for_iteration(step + 1)
            if (stage != prev_stage and model.config.switch_teacher
                    and model.config.K[stage] != model.config.K[prev_stage]):
                model.merge_lora_into_teacher(self.lora)
                if is_main():
                    logger.info("stage %d: switched teacher to merged student", stage)
            prev_stage = stage
            phase = ("g" if step % 2 == 0 else "d") if self.alternating else None
            aux = self.train_step(self.stage_batch(batch, step, conds), stage, phase)
            if self.step % cfg.log_every_n_steps == 0 and is_main():
                metrics = {k: float(v) for k, v in aux.items()}
                logger.info("step %d stage %d %.3f s/step %s", self.step, stage,
                            (time.perf_counter() - t0) / cfg.log_every_n_steps, metrics)
                t0 = time.perf_counter()
            if eval_data is not None and cfg.val_every_n_steps and self.step % cfg.val_every_n_steps == 0:
                self.last_val = self.evaluate(eval_data(), stage, max_batches=cfg.val_batches)
                if is_main():
                    logger.info("step %d %s", self.step, self.last_val)
            for cb in callbacks:
                cb(self, aux, self.step)
        return aux
