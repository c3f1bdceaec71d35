"""The port's aspect bucketing and native JPEG decoder against the JAX package.

- ``make_buckets`` and ``assign_bucket`` over several ladders;
- ``BucketAssignMapper`` (center and random crop) on seeded images of mixed
  aspect, some with a draft decode's ``original_size``: images, buckets and
  the SDXL size tuples bit-equal;
- ``bucket_batches`` on a seeded stream, the overflow flush (padded under
  ``drop_last``) included;
- the native decoder: the port's build of its own ``fastjpeg.cpp`` decodes
  the same JPEG bytes bit-equal to JAX's ``decode_to_tensor``, and
  ``NativeDecodeMapper`` (the PIL path of a PNG too) gives JAX's outputs;
- the discriminator's stage count under bucketing: JAX's example rule
  (``IMAGE_SIZE // 32``) raises on the (1088, 960) bucket's mid features,
  the port's rule (``train._discriminator`` over the ladder) reaches the
  4×4 head at every bucket, in both packages' modules.
"""

import io
import types

import numpy as np
import pytest
import torch
from PIL import Image

from flash_diffusion_tpu_torch import train
from flash_diffusion_tpu_torch.data import (
    BucketAssignMapper,
    BucketAssignMapperConfig,
    assign_bucket,
    bucket_batches,
    make_buckets,
)
from flash_diffusion_tpu_torch.data import native_decode
from flash_diffusion_tpu_torch.distill import ConvDiscriminator, DiscriminatorConfig

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu.data import bucketing as jbucketing
    from flash_diffusion_tpu.data import native_decode as jnative
    from flash_diffusion_tpu.distill.discriminator import ConvDiscriminator as JConvDiscriminator
    from flash_diffusion_tpu.distill.discriminator import DiscriminatorConfig as JDiscriminatorConfig
except ImportError:
    jax = None


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


LADDERS = [(1024, 64, 2.0), (512, 64, 2.0), (256, 64, 2.0), (768, 32, 1.5), (1024, 128, 3.0)]


@pytest.mark.parametrize("base,stride,max_aspect", LADDERS)
def test_make_buckets_and_assign_bucket_match_jax(jax_ref, base, stride, max_aspect):
    """The ladder (pairs, order) and the bucket of 200 seeded (h, w) equal
    JAX's; the square is in it, every pair within the budget and the aspect
    bound, a multiple of the stride."""
    got = make_buckets(base, stride, max_aspect)
    assert got == jbucketing.make_buckets(base, stride, max_aspect)
    assert (base, base) in got
    assert all(h * w <= base * base and h % stride == 0 == w % stride and 1 / max_aspect <= w / h <= max_aspect
               for h, w in got)
    rng = np.random.default_rng(base + stride)
    for h, w in rng.integers(16, 4000, (200, 2)):
        assert assign_bucket(got, int(h), int(w)) == jbucketing.assign_bucket(got, int(h), int(w))
    with pytest.raises(ValueError, match="not divisible"):
        make_buckets(base + 1, stride, max_aspect)


def mixed_images(seed=0):
    """Seeded RGB images of mixed aspect (wide, tall, square, extreme), two
    of them carrying a draft decode's file size as JAX's decoder records it."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (h, w) in enumerate([(90, 150), (150, 90), (120, 120), (60, 230), (230, 70), (101, 87), (64, 200)]):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if i % 3 == 0:
            img.info["original_size"] = (4 * h, 4 * w)
        out.append(img)
    return out


@pytest.mark.parametrize("crop", ["center", "random"])
def test_bucket_assign_mapper_matches_jax(jax_ref, crop):
    """``BucketAssignMapper`` (a 128² budget at stride 32, max aspect 2)
    against JAX's on the same images: the [0, 1] arrays bit-equal, the
    bucket index and the three size tuples equal (a random crop from the
    same seed lands at the same offsets); without ``to_tensor`` the PIL
    crops equal too."""
    kw = dict(key="image", base_size=128, stride=32, max_aspect=2.0, crop=crop, seed=3)
    port, ref = BucketAssignMapper(BucketAssignMapperConfig(**kw)), jbucketing.BucketAssignMapper(
        jbucketing.BucketAssignMapperConfig(**kw))
    assert port.buckets == ref.buckets
    crops = set()
    for img in mixed_images():
        got, want = port({"image": img, "text": "t"}), ref({"image": img, "text": "t"})
        assert got.keys() == want.keys()
        assert got["__bucket__"] == want["__bucket__"] and got["text"] == "t"
        th, tw = port.buckets[got["__bucket__"]]
        assert got["image"].shape == (th, tw, 3) and got["image"].dtype == np.float32
        for k in ("image", "original_size_as_tuple", "crop_coords_top_left", "target_size_as_tuple"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["original_size_as_tuple"], img.info.get("original_size", img.size[::-1]))
        crops.add(tuple(got["crop_coords_top_left"]))
    assert len(crops) > 2  # real resizes and non-zero crops
    kw["to_tensor"], kw["emit_micro_conds"] = False, False
    port, ref = BucketAssignMapper(BucketAssignMapperConfig(**kw)), jbucketing.BucketAssignMapper(
        jbucketing.BucketAssignMapperConfig(**kw))
    for img in mixed_images(1):
        got, want = port({"image": img}), ref({"image": img})
        assert set(got) == set(want) == {"image", "__bucket__"}
        np.testing.assert_array_equal(np.asarray(got["image"]), np.asarray(want["image"]))


def tagged_stream(seed, n=40, buckets=5):
    rng = np.random.default_rng(seed)
    return [{"__bucket__": int(b), "x": rng.standard_normal(3).astype(np.float32), "id": i}
            for i, b in enumerate(rng.choice(buckets, n, p=[0.5, 0.2, 0.15, 0.1, 0.05]))]


@pytest.mark.parametrize("drop_last", [True, False])
def test_bucket_batches_matches_jax(jax_ref, drop_last):
    """``bucket_batches`` (batch 4, at most 6 waiting) against JAX's on the
    same 40-sample stream: the same batches in the same order, each of one
    bucket; the backlog's overflow flush happens, padded by repetition to
    4 under ``drop_last`` and short without; a sample without a bucket
    raises."""
    got = list(bucket_batches(iter(tagged_stream(0)), 4, drop_last=drop_last, max_pending=6))
    want = list(jbucketing.bucket_batches(iter(tagged_stream(0)), 4, drop_last=drop_last, max_pending=6))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["id"], w["id"])
        np.testing.assert_array_equal(g["x"], w["x"])
    bucket_of = {s["id"]: s["__bucket__"] for s in tagged_stream(0)}
    assert all(len({bucket_of[i] for i in g["id"]}) == 1 for g in got)
    padded = [g for g in got if len(set(g["id"].tolist())) < len(g["id"])]
    short = [g for g in got if len(g["id"]) < 4]
    assert (padded and not short) if drop_last else (short and not padded)
    with pytest.raises(ValueError, match="__bucket__"):
        list(bucket_batches(iter([{"x": 1}]), 4))


def jpeg_bytes(seed):
    """Seeded JPEGs: RGB at several sizes (one large enough for the DCT
    prescale) and a grayscale one."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w, mode in ((70, 110, "RGB"), (130, 60, "RGB"), (300, 420, "RGB"), (90, 90, "L")):
        arr = rng.integers(0, 256, (h, w, 3) if mode == "RGB" else (h, w), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def test_native_decoder_matches_jax(jax_ref):
    """The port's ``fastjpeg.cpp`` built under ``build/native/`` and JAX's
    decode the same JPEG bytes to the same float32 [-1, 1] arrays, bit for
    bit, and the same file sizes, at square and non-square targets; both
    refuse bytes that are not a JPEG; ``NativeDecodeMapper`` equals JAX's
    on bytes and, through its PIL path, on a PNG image, size tuples
    included."""
    assert native_decode.is_available() and jnative.is_available(), native_decode.BUILD_INFO
    assert native_decode.BUILD_INFO["path"].split("/")[-3:-1] == ["build", "native"]
    for data in jpeg_bytes(0):
        for hw in ((64, 64), (48, 80), (80, 32)):
            got, got_hw = native_decode.decode_to_tensor(data, *hw)
            want, want_hw = jnative.decode_to_tensor(data, *hw)
            assert got.shape == (*hw, 3) and got_hw == want_hw
            np.testing.assert_array_equal(got, want)
            assert -1.0 <= got.min() and got.max() <= 1.0
    for bad in (b"\xff\xd8 not a jpeg", b""):
        with pytest.raises(ValueError):
            native_decode.decode_to_tensor(bad, 8, 8)
    png = Image.fromarray(np.random.default_rng(1).integers(0, 256, (50, 70, 3), dtype=np.uint8))
    kw = dict(key="image", height=40, width=56, emit_micro_conds=True)
    port = native_decode.NativeDecodeMapper(native_decode.NativeDecodeMapperConfig(**kw))
    ref = jnative.NativeDecodeMapper(jnative.NativeDecodeMapperConfig(**kw))
    for value in (*jpeg_bytes(2), png):
        got, want = port({"image": value, "text": "t"}), ref({"image": value, "text": "t"})
        assert got.keys() == want.keys()
        for k in ("image", "original_size_as_tuple", "crop_coords_top_left", "target_size_as_tuple"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(TypeError):
        port({"image": 3})


def unet_stub(channels=8):
    return types.SimpleNamespace(config=types.SimpleNamespace(block_out_channels=[channels]))


def test_jax_example_discriminator_rejects_a_non_square_bucket(jax_ref):
    """``train_flash_sdxl.py:85-89`` takes 3 stages at 1024²
    (``IMAGE_SIZE // 32`` = 32); with ``ASPECT_BUCKETING`` the (1088, 960)
    bucket's mid features are 34 × 30, and JAX's ``ConvDiscriminator``
    reduces them to 4 × 3 before its 4×4 VALID head and raises; the square
    bucket's 32 × 32 passes."""
    import math

    size = 1024
    stages = max(0, int(math.log2(max(size // 32 // 4, 1))))
    assert stages == 3 and (1088, 960) in make_buckets(size)
    disc = JConvDiscriminator(JDiscriminatorConfig(feature_dim=8, num_stages=stages))
    init = lambda h, w: jax.eval_shape(disc.init, jax.random.PRNGKey(0), jnp.zeros((1, h, w, 8)))
    init(32, 32)
    with pytest.raises(ValueError, match="4x3"):
        init(1088 // 32, 960 // 32)


@pytest.mark.parametrize("size,stages", [(1024, 2), (512, 1), (256, 0)])
def test_port_discriminator_rule_fits_every_bucket(jax_ref, size, stages):
    """``train._discriminator("sdxl", ...)`` over the ladder
    (``bucket_ladder``) takes its stage count from the shortest side of the
    buckets' mid features (704 / 32 = 22 at 1024²: 2 stages), and then the
    port's and JAX's discriminator reach the head at every bucket (the
    transposed ones included); without bucketing the rule is unchanged."""
    cfg = {"IMAGE_SIZE": size, "ASPECT_BUCKETING": True}
    ladder = train.bucket_ladder(cfg)
    assert ladder == make_buckets(size, 64, 2.0) and train.bucket_ladder({"IMAGE_SIZE": size}) is None
    disc = train._discriminator("sdxl", unet_stub(), size, ladder)
    assert disc.config.num_stages == stages
    assert train._discriminator("sdxl", unet_stub(), size).config.num_stages == {1024: 3, 512: 2, 256: 1}[size]
    small = ConvDiscriminator(DiscriminatorConfig(feature_dim=4, num_stages=stages), in_channels=8)
    jdisc = JConvDiscriminator(JDiscriminatorConfig(feature_dim=4, num_stages=stages))
    for h, w in ladder:
        out = small(torch.zeros(1, h // 32, w // 32, 8))
        assert out.shape[0] == 1 and out.shape[1] > 0
        jax.eval_shape(jdisc.init, jax.random.PRNGKey(0), jnp.zeros((1, h // 32, w // 32, 8)))
