"""The eval path of the port against the JAX package, on the CPU.

Same weights (JAX params carried by ``utils/convert.py``), same inputs made
from a numpy seed, fp32 on both sides; each tolerance stated:

- ``FIDStats`` streamed over three batches against JAX's over one, and
  ``frechet_distance``/``fid_from_features`` (1e-10 relative: both in
  float64); ``clip_score`` (1e-6);
- ``clip_preprocess`` shrinking (512² and 300×400 → 224², antialiased as
  ``jax.image.resize``), growing (160² → 224²) and at 224² (1e-4 of
  max|x|: fp32 filter weights summed in another order at the 300×400
  scales), and plain bilinear resizing is 1e-2 off there;
- a tiny ``CLIPVisionModel`` (28², patch 14, width 64, 2 layers, 4 heads)
  through ``vision_from_jax`` (1e-4), and ``import_clip_vision`` of a
  transformers-named dict (with and without ``vision_model.``, with a
  ``position_ids`` buffer and a text tower beside) against JAX's importer
  (1e-4); the text side of a full CLIP dict into ``CLIPTextModel``;
- InceptionV3 at 75², batch 1, in both variants through
  ``inception_from_jax``, and ``import_inception_v3`` of a torchvision-named
  dict (BatchNorm statistics, ``fc``, ``AuxLogits``) against JAX's fold
  (1e-4 of max|feature|); the two variants differ;
- ``evaluate`` with a stub pipeline that returns given images, the tiny
  ViT at 224², a text embedding and InceptionV3, on both sides: every
  metric within 1e-4 relative;
- ``QualityValidator``: its history keys, ``val/feature_fd`` equal to
  ``frechet_distance`` of the embeddings it saw (1e-12 relative), the EMA
  tree sampled;
- ``eval_coco.main`` with ``--device cpu`` on tiny JPEG shards, with a tiny
  SD1.5 pipeline, a tiny full-CLIP file and an InceptionV3 file named
  ``pt_inception-…`` (the FID variant detected): one JSON line, every
  metric finite.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch import eval as teval
from flash_diffusion_tpu_torch.models import CLIPTextModel, CLIPVisionConfig, CLIPVisionModel, InceptionV3Pool3
from flash_diffusion_tpu_torch.models.inception import import_inception_v3
from flash_diffusion_tpu_torch.models.inception import preprocess as incep_preprocess
from flash_diffusion_tpu_torch.models.text_encoders import CLIPTextConfig
from flash_diffusion_tpu_torch.models.vision import import_clip_text, import_clip_vision
from flash_diffusion_tpu_torch.trainer import QualityValidator
from flash_diffusion_tpu_torch.utils import inception_from_jax, vision_from_jax
from test_torch_adapters import close, flax_params

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu.eval import harness as jharness
    from flash_diffusion_tpu.eval import metrics as jmetrics
    from flash_diffusion_tpu.models import inception as jincep
    from flash_diffusion_tpu.models import vision as jvision
    from flash_diffusion_tpu.utils import hf as jhf
except ImportError:
    jax = None

torch.set_num_threads(2)
VIT_KW = dict(image_size=28, patch_size=14, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
              projection_dim=32)


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1e-12, np.abs(want).max()))


# ---------------------------------------------------------------- metrics
def test_fid_stats_streaming_and_frechet_distance_match_jax(jax_ref):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 12)) * 0.7 + 0.2
    b = rng.standard_normal((33, 12)) @ rng.standard_normal((12, 12)) * 0.3
    port = teval.FIDStats()
    for chunk in np.array_split(a, 3):
        port.update(torch.from_numpy(chunk))
    mu, cov = port.finalize()
    jmu, jcov = jmetrics.FIDStats().update(a).finalize()
    assert rel(mu, jmu) < 1e-10 and rel(cov, jcov) < 1e-10
    mu_b, cov_b = teval.FIDStats().update(b).finalize()
    got = teval.frechet_distance(mu, cov, mu_b, cov_b)
    want = jmetrics.frechet_distance(jmu, jcov, *jmetrics.FIDStats().update(b).finalize())
    assert abs(got - want) <= 1e-10 * abs(want)
    assert abs(teval.fid_from_features(a, b) - jmetrics.fid_from_features(a, b)) <= 1e-10 * abs(want)
    assert abs(teval.fid_from_features(a, a)) < 1e-8


def test_clip_score_matches_jax(jax_ref):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((6, 16)).astype(np.float32)
    txt = (img * 0.5 + rng.standard_normal((6, 16))).astype(np.float32)
    txt[0] = -img[0]  # a negative cosine: clipped to 0
    got = float(teval.clip_score(torch.from_numpy(img), torch.from_numpy(txt)))
    want = float(jmetrics.clip_score(jnp.asarray(img), jnp.asarray(txt)))
    assert abs(got - want) <= 1e-6 * abs(want)
    assert 0 <= got <= 100


@pytest.mark.parametrize("h,w", [(512, 512), (300, 400), (160, 160), (224, 224)])
def test_clip_preprocess_matches_jax_resize(jax_ref, h, w):
    """Antialiased when it shrinks, as ``jax.image.resize``; a plain
    bilinear ``F.interpolate`` is not within the tolerance there."""
    x = np.random.default_rng(2).uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    got = teval.clip_preprocess(torch.from_numpy(x))
    want = np.asarray(jmetrics.clip_preprocess(jnp.asarray(x)))
    assert got.shape == (2, 224, 224, 3)
    close(got, want, 1e-4)
    if h > 224:
        plain = torch.nn.functional.interpolate(torch.from_numpy((x + 1) / 2).permute(0, 3, 1, 2), size=(224, 224),
                                                mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        plain = (plain - torch.tensor(teval.metrics.CLIP_MEAN)) / torch.tensor(teval.metrics.CLIP_STD)
        assert np.abs(plain.numpy() - want).max() > 1e-2


# ---------------------------------------------------------------- the CLIP vision tower
def _jax_vit(cfg_kw, seed=0):
    cfg = jvision.CLIPVisionConfig(**cfg_kw)
    net = jvision.CLIPVisionModel(cfg)
    s = cfg_kw["image_size"]
    return cfg, net, flax_params(net, seed, jnp.zeros((1, s, s, 3)))


def test_clip_vision_matches_jax(jax_ref):
    cfg, net, params = _jax_vit(VIT_KW)
    port = CLIPVisionModel(CLIPVisionConfig(**VIT_KW))
    port.load_state_dict(vision_from_jax(params, cfg))
    x = np.random.default_rng(3).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = net.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    close(got["image_embeds"], want["image_embeds"], 1e-4)
    close(got["pooled_output"], want["pooled_output"], 1e-4)


@pytest.mark.parametrize("prefixed", [True, False])
def test_import_clip_vision_matches_jax_importer(jax_ref, prefixed):
    """A transformers-named dict (the port's own names, random values) read
    by both importers: the same function."""
    cfg = jvision.CLIPVisionConfig(**VIT_KW)
    rng = np.random.default_rng(4)
    sd = {k: (rng.standard_normal(v.shape) * (0.2 if v.dim() > 1 else 0.05) + (k.endswith("norm.weight")
                                                                                 or "norm1.weight" in k
                                                                                 or "norm2.weight" in k
                                                                                 or "layrnorm.weight" in k))
          .astype(np.float32) for k, v in CLIPVisionModel(CLIPVisionConfig(**VIT_KW)).state_dict().items()}
    if not prefixed:  # a CLIPVisionModel file of some exports: no vision_model. prefix
        sd = {k.removeprefix("vision_model."): v for k, v in sd.items()}
    sd["vision_model.embeddings.position_ids" if prefixed else "embeddings.position_ids"] = np.arange(5)[None]
    sd["text_model.final_layer_norm.weight"] = np.ones(16, np.float32)  # a text tower beside, ignored
    jparams = jhf.import_clip_vision({k: v for k, v in sd.items() if not k.startswith("text_model.")}, cfg)
    port = CLIPVisionModel(CLIPVisionConfig(**VIT_KW))
    port.load_state_dict(import_clip_vision({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}))
    x = np.random.default_rng(5).standard_normal((1, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x))["image_embeds"]
    close(got, jvision.CLIPVisionModel(cfg).apply(jparams, jnp.asarray(x))["image_embeds"], 1e-4)


def test_full_clip_text_side_loads_into_clip_text_model():
    tcfg = CLIPTextConfig(hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, projection_dim=8)
    text = CLIPTextModel(tcfg)
    vision = CLIPVisionModel(CLIPVisionConfig(**VIT_KW))
    full = {**text.state_dict(), **vision.state_dict(), "logit_scale": torch.tensor(2.0),
            "text_model.embeddings.position_ids": torch.arange(77)[None]}
    fresh = CLIPTextModel(tcfg)
    fresh.load_state_dict(import_clip_text(full))
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in text.state_dict().items())
    CLIPVisionModel(CLIPVisionConfig(**VIT_KW)).load_state_dict(import_clip_vision(full))


# ---------------------------------------------------------------- InceptionV3
def _jax_inception_params(seed):
    """He-scaled kernels and folded BatchNorms near identity, from a numpy
    seed, over the shapes of ``jax.eval_shape``."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))).astype(np.float32)

    shapes = jax.eval_shape(jincep.InceptionV3Pool3().init, jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3)))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("fid", [False, True])
def test_inception_matches_jax(jax_ref, fid):
    params = _jax_inception_params(6)
    x = np.random.default_rng(7).uniform(-1, 1, (1, 75, 75, 3)).astype(np.float32)
    want = np.asarray(jincep.InceptionV3Pool3(fid_variant=fid).apply(params, jnp.asarray(x)))
    port = InceptionV3Pool3(fid_variant=fid)
    port.load_state_dict(inception_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 2048)
    close(got, want, 1e-4)
    other = np.asarray(jincep.InceptionV3Pool3(fid_variant=not fid).apply(params, jnp.asarray(x)))
    assert np.abs(other - want).max() > 1e-3 * np.abs(want).max()  # the variants differ


def test_import_inception_v3_matches_jax_fold(jax_ref):
    """A torchvision-named state dict with BatchNorm statistics, ``fc`` and
    ``AuxLogits``: the port's BatchNorms against JAX's fold at eps 1e-3."""
    rng = np.random.default_rng(8)
    sd = {}
    for k, v in InceptionV3Pool3().state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("conv.weight"):
            sd[k] = (rng.standard_normal(v.shape) * np.sqrt(2.0 / np.prod(v.shape[1:]))).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k.endswith("bn.weight"):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            sd[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    sd["fc.weight"], sd["fc.bias"] = np.zeros((1008, 2048), np.float32), np.zeros(1008, np.float32)
    sd["AuxLogits.conv0.conv.weight"] = np.zeros((128, 768, 1, 1), np.float32)
    x = np.random.default_rng(9).uniform(-1, 1, (1, 75, 75, 3)).astype(np.float32)
    want = np.asarray(jincep.InceptionV3Pool3(fid_variant=True).apply(jincep.import_inception_v3(sd), jnp.asarray(x)))
    port = InceptionV3Pool3(fid_variant=True)
    port.load_state_dict(import_inception_v3(sd), strict=False)
    assert set(port.state_dict()) - set(import_inception_v3(sd)) == {
        k for k in port.state_dict() if k.endswith("num_batches_tracked")}
    with torch.no_grad():
        close(port(torch.from_numpy(x)), want, 1e-4)


# ---------------------------------------------------------------- evaluate
class _Stub:
    """A pipeline whose ``generate`` returns the images given for a seed."""

    def __init__(self, fakes):
        self.fakes, self.calls = fakes, []

    def generate(self, prompts, num_inference_steps=4, guidance_scale=0.0, seed=0, **kw):
        self.calls.append((tuple(prompts) if not isinstance(prompts, dict) else None, num_inference_steps, seed))
        return self.fakes[seed]


def test_evaluate_matches_jax_with_a_stub_pipeline(jax_ref):
    """Two batches of 4 at 64²: CLIP-FID through the tiny ViT at 224², the
    CLIPScore against a fixed text embedding, InceptionV3's FID (random
    He-scaled weights); port vs JAX within 1e-4 relative; generate called
    with seed + i; no extractor raises."""
    rng = np.random.default_rng(10)
    reals = [rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    fakes = {3 + i: (0.5 * reals[i] + 0.3 * rng.uniform(-1, 1, (4, 64, 64, 3))).astype(np.float32)
             for i in range(2)}
    vit_kw = {**VIT_KW, "image_size": 224}
    cfg, jnet, jparams = _jax_vit(vit_kw, seed=11)
    text = rng.standard_normal((4, 32)).astype(np.float32)
    iparams = _jax_inception_params(12)
    jbatches = [{"image": r, "text_ids": np.zeros((4, 77), np.int32)} for r in reals]
    want = jharness.evaluate(_Stub({k: jnp.asarray(v) for k, v in fakes.items()}), iter(jbatches), jnet, jparams,
                             text_embed_fn=lambda b: jnp.asarray(text), seed=3, inception_params=iparams,
                             inception_fid_variant=True)
    vit = CLIPVisionModel(CLIPVisionConfig(**vit_kw))
    vit.load_state_dict(vision_from_jax(jparams, cfg))
    incep = InceptionV3Pool3(fid_variant=True)
    incep.load_state_dict(inception_from_jax(iparams))
    stub = _Stub({k: torch.from_numpy(v) for k, v in fakes.items()})
    batches = [{"image": r, "text": [f"caption {i}"] * 4} for i, r in enumerate(reals)]
    got = teval.evaluate(stub, iter(batches), vit, text_embed_fn=lambda b: torch.from_numpy(text), seed=3,
                         inception_module=incep, max_batches=5)
    assert stub.calls == [(("caption 0",) * 4, 4, 3), (("caption 1",) * 4, 4, 4)]
    assert set(got) == {"fid", "clip_fid", "clip_score", "num_samples"} == set(want)
    assert got["num_samples"] == want["num_samples"] == 8
    for k in ("fid", "clip_fid", "clip_score"):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    with pytest.raises(ValueError, match="vision_module"):
        teval.evaluate(stub, iter(batches))


# ---------------------------------------------------------------- QualityValidator
def test_quality_validator_history_and_feature_fd():
    """Every 2 steps: the EMA tree sampled from seeded latents; history
    (step, {val/feature_fd, val/clip_score}); the FD equal to
    ``frechet_distance`` of the embeddings it saw; the same step twice gives
    the same FD."""
    rng = np.random.default_rng(13)
    held = [{"image": rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32), "text_ids": np.zeros((3, 4), np.int64)}
            for _ in range(3)]
    seen, loras = [], []

    class Model:
        def sample(self, lora, z, batch, num_steps, guidance_scale, generator):
            loras.append(lora)
            assert set(batch) == {"text_ids"} and num_steps == 2
            return torch.tanh(z.repeat(1, 2, 2, 1)[..., :3] + torch.randn(z.shape[0], 1, 1, 3, generator=generator))

    pipe = types.SimpleNamespace(model=Model(), lora="lora", ema="ema", device=torch.device("cpu"),
                                 to_device=lambda b: {k: torch.as_tensor(v) for k, v in b.items()},
                                 sampling_frozen=lambda: __import__("contextlib").nullcontext())

    def embed(images):
        f = torch.as_tensor(images).float().mean(dim=(1, 2))
        seen.append(f)
        return torch.cat([f, f ** 2], -1)

    qv = QualityValidator(lambda: iter(held), (4, 4, 3), embed, every_n_steps=2, num_batches=2, num_steps=2,
                          text_embed_fn=lambda b: torch.ones(3, 6))
    qv(pipe, {}, 1)
    assert qv.history == [] and seen == []
    qv(pipe, {}, 2)
    (step, metrics), = qv.history
    assert step == 2 and set(metrics) == {"val/feature_fd", "val/clip_score"} and loras == ["ema", "ema"]
    reals = torch.cat([torch.cat([f, f ** 2], -1) for f in seen[0::2]])
    fakes = torch.cat([torch.cat([f, f ** 2], -1) for f in seen[1::2]])
    want = teval.fid_from_features(reals.double().numpy(), fakes.double().numpy())
    assert abs(metrics["val/feature_fd"] - want) <= 1e-12 * want  # streamed: float64 sums in another order
    qv(pipe, {}, 2)
    assert qv.history[1][1]["val/feature_fd"] == metrics["val/feature_fd"]
    QualityValidator(lambda: iter(held), (4, 4, 3), embed, every_n_steps=2, num_steps=2, use_ema=False)(pipe, {}, 2)
    assert loras[-1] == "lora"


# ---------------------------------------------------------------- the CLI
def write_shards(root, n_shards, per_shard, seed):
    """Tar shards of ``.jpg`` (noise, 40–56 a side) + ``.json`` captions."""
    import io
    import tarfile

    from PIL import Image

    rng = np.random.default_rng(seed)
    paths, idx = [], 0
    for s in range(n_shards):
        paths.append(os.path.join(root, f"{s:06d}.tar"))
        with tarfile.open(paths[-1], "w") as tf:
            for _ in range(per_shard):
                buf = io.BytesIO()
                h, w = (int(v) for v in rng.integers(40, 57, 2))
                Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="JPEG")
                meta = json.dumps({"caption": f"sample {idx}"}).encode()
                for name, data in ((f"{idx:06d}.jpg", buf.getvalue()), (f"{idx:06d}.json", meta)):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                idx += 1
    return paths


def test_eval_coco_main_on_tiny_shards(monkeypatch, tmp_path, capsys):
    """``eval_coco.main`` with ``--device cpu --random-init`` over 2 JPEG
    shards: a tiny SD1.5 pipeline (the tiny UNet at 8² latents, a 2-level
    VAE, a 1-layer CLIP), a tiny full-CLIP file under ``image_encoder/`` (ViT at 224² of
    width 64; the text tower with its projection), and a random
    InceptionV3 file named ``pt_inception-…``: one JSON line with finite
    fid, clip_fid and clip_score in [0, 100] over 2 batches of 2."""
    from safetensors.torch import save_file

    from flash_diffusion_tpu_torch import eval_coco, models, sample
    from flash_diffusion_tpu_torch.models import AutoencoderKLConfig, UNetConfig
    from flash_diffusion_tpu_torch.models.embedders import ClipEmbedderConfig
    from test_torch_train import UNET_KW, VAE_KW

    text_kw = dict(vocab_size=49408, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
                   max_positions=77, eos_token_id=49407)
    monkeypatch.setattr(sample, "sd15_unet_config", lambda **kw: UNetConfig(**UNET_KW, **kw))
    monkeypatch.setattr(sample, "sd_vae_config", lambda: AutoencoderKLConfig(**VAE_KW))
    monkeypatch.setattr(sample, "ClipEmbedderConfig",
                        lambda **kw: ClipEmbedderConfig(**kw, text_embedder_config=text_kw))
    vit_kw = {**VIT_KW, "image_size": 224, "projection_dim": 8}
    monkeypatch.setattr(models, "clip_vit_l14_config", lambda: CLIPVisionConfig(**vit_kw))
    monkeypatch.setattr(models, "clip_l_config", lambda **kw: CLIPTextConfig(**{**text_kw, **kw, "projection_dim": 8}))
    torch.manual_seed(0)
    clip = {**CLIPVisionModel(CLIPVisionConfig(**vit_kw)).state_dict(),
            **CLIPTextModel(CLIPTextConfig(**{**text_kw, "projection_dim": 8})).state_dict()}
    os.makedirs(tmp_path / "w" / "image_encoder")
    save_file(clip, str(tmp_path / "w" / "image_encoder" / "model.safetensors"))
    incep_file = str(tmp_path / "pt_inception-2015-12-05-test.pth")
    torch.save(InceptionV3Pool3().state_dict(), incep_file)
    build = eval_coco.build_pipeline

    def small_pipeline(*a, **kw):  # 8² latents: the tiny UNet's attention over 64 tokens, not 4096
        pipe = build(*a, **kw)
        pipe.latent_shape = (8, 8, 4)
        return pipe

    monkeypatch.setattr(eval_coco, "build_pipeline", small_pipeline)
    shards = write_shards(str(tmp_path), 2, 2, seed=0)
    metrics = eval_coco.main(["--model", "sd15", "--random-init", "--weights-root", str(tmp_path / "w"),
                              "--shards", *shards, "--inception", incep_file, "--batch-size", "2",
                              "--max-batches", "2", "--resolution", "64", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["num_samples"] == metrics["num_samples"] == 4
    assert all(np.isfinite(line[k]) for k in ("fid", "clip_fid", "clip_score"))
    assert 0 <= line["clip_score"] <= 100
