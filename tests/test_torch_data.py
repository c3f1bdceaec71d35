"""The port's data pipeline against the JAX package's, on small shards.

The same tar shards (PNG and JPEG members with JSON captions and scores,
made from a seed) through both ``DataPipeline``s with the same seed, one
worker, a shuffle buffer and the same filters and mappers: the same samples
in the same order, keys, captions and arrays equal. Also: the port's
``build_data`` against the chain of ``examples/common.py`` (the JAX
example's), brace expansion, a corrupt shard and a corrupt member skipped
with the rest kept, two thread workers (the same samples as a set),
``pipe:`` shards, collation and ``prefetch_to_device``.
"""

import io
import json
import os
import sys
import tarfile

import numpy as np
import pytest
from PIL import Image

from flash_diffusion_tpu_torch import data as tdata
from flash_diffusion_tpu_torch import train

try:  # the JAX reference; absent where only the port is installed
    from flash_diffusion_tpu import data as jdata
except ImportError:
    jdata = None


@pytest.fixture(scope="module")
def jax_ref():
    if jdata is None:
        pytest.skip("needs the JAX reference package")


def make_shard(path, first, n, seed, fmt="JPEG", size=(24, 40)):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for idx in range(first, first + n):
            h, w = (int(v) for v in rng.integers(size[0], size[1] + 1, 2))
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format=fmt)
            ext = "jpg" if fmt == "JPEG" else "png"
            meta = json.dumps({"caption": f"sample {idx}", "aesthetic_score": 5.0 + idx % 3}).encode()
            for name, payload in ((f"{idx:06d}.{ext}", buf.getvalue()), (f"{idx:06d}.json", meta)):
                info = tarfile.TarInfo(name)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    return path


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three JPEG shards of 5 samples and one PNG shard of 4."""
    root = tmp_path_factory.mktemp("shards")
    paths = [make_shard(str(root / f"{s:06d}.tar"), 5 * s, 5, seed=s) for s in range(3)]
    paths.append(make_shard(str(root / "000003.tar"), 15, 4, seed=3, fmt="PNG"))
    return str(root), paths


def chain(pkg, size=16, ext="jpg"):
    """The same filters and mappers, from ``pkg`` (the port's or JAX's)."""
    return [
        pkg.KeyFilter(pkg.KeyFilterConfig(keys=[ext, "json"])),
        pkg.MapperWrapper([
            pkg.KeysFromJSONMapper(pkg.KeysFromJSONMapperConfig(
                key="json", keys_to_extract=["caption", "aesthetic_score"], remove_original=True, strict=False)),
            pkg.KeyRenameMapper(pkg.KeyRenameMapperConfig(key_map={ext: "image", "caption": "text"})),
            pkg.ImageTransformMapper(pkg.ImageTransformMapperConfig(key="image", transforms=[
                {"name": "Resize", "size": [size, size]}, {"name": "CenterCrop", "size": [size, size]},
                {"name": "ToTensor"}])),
            pkg.RescaleMapper(pkg.RescaleMapperConfig(key="image")),
        ]),
        pkg.FilterOnCondition(pkg.FilterOnConditionConfig(condition_key="aesthetic_score", strict=False),
                              lambda v: v >= 6.0),
    ]


def assert_same_samples(got, want, ordered=True):
    key = lambda s: s["__key__"]
    if not ordered:
        got, want = sorted(got, key=key), sorted(want, key=key)
    assert [key(s) for s in got] == [key(s) for s in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{key(w)} {k}")
            else:
                assert g[k] == w[k], (key(w), k)


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_pipeline_matches_jax_sample_for_sample(jax_ref, shards, ext):
    """One worker, shuffled shards, a shuffle buffer of 4: the port's
    samples and batches equal JAX's one for one, in order, over two epochs
    (the JPEG shards through brace expansion, the PNG shard by path)."""
    root, paths = shards
    spec = [os.path.join(root, "{000000..000002}.tar")] if ext == "jpg" else [paths[3]]
    kw = dict(shards_path_or_urls=spec, per_worker_batch_size=2, num_workers=1, shuffle_buffer_size=4, seed=7)
    tp = tdata.DataPipeline(tdata.DataModuleConfig(**kw), chain(tdata, ext=ext))
    jp = jdata.DataPipeline(jdata.DataModuleConfig(**kw), chain(jdata, ext=ext), process_index=0, process_count=1)
    for epoch in (0, 1):
        got, want = list(tp.samples(epoch)), list(jp.samples(epoch))
        assert len(want) == (10 if ext == "jpg" else 2)
        assert_same_samples(got, want)
    got, want = list(tp.batches(0)), list(jp.batches(0))
    assert len(got) == len(want) and all(g["image"].shape[0] == 2 for g in got)
    for g, w in zip(got, want):
        assert g["text"] == w["text"] and g["__key__"] == w["__key__"]
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["aesthetic_score"], w["aesthetic_score"])


def test_build_data_matches_the_jax_example(jax_ref, shards):
    """``train.build_data`` against ``examples/common.py``'s ``build_data``
    (one worker each, the same seed): the same batches, images [B, 16, 16, 3]
    in [-1, 1], captions as ``text``, scores below 6 dropped; the same with
    ``ASPECT_BUCKETING`` (a 32² budget at stride 8: buckets (40, 24), (32,
    32), (24, 40); each batch of one bucket, its SDXL size tuples equal)
    and with ``DECODER: native`` (the native decoder, bit-equal)."""
    root, _ = shards
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
    try:
        import common as jcommon
    finally:
        sys.path.pop(0)
    cfg = {"SHARDS_PATH_OR_URLS": [os.path.join(root, "{000000..000002}.tar")], "IMAGE_SIZE": 16, "BATCH_SIZE": 2,
           "NUM_WORKERS": 1, "SHUFFLE_BUFFER_SIZE": 3, "MIN_AESTHETIC_SCORE": 6.0}
    got = list(train.build_data(cfg).batches(0))
    want = list(jcommon.build_data(cfg).batches(0))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["text"] == w["text"] and g["image"].shape == (2, 16, 16, 3)
        np.testing.assert_array_equal(g["image"], w["image"])
        assert g["image"].min() >= -1.0 and g["image"].max() <= 1.0
        assert all(s >= 6.0 for s in g["aesthetic_score"])
    bucketed = {**cfg, "IMAGE_SIZE": 32, "ASPECT_BUCKETING": True, "BUCKET_STRIDE": 8}
    got = list(train.build_data(bucketed).batches(0))
    want = list(jcommon.build_data(bucketed).batches(0))
    assert len(got) == len(want) >= 3
    shapes = {g["image"].shape[1:3] for g in got}
    assert len(shapes) >= 2 and shapes <= {(40, 24), (32, 32), (24, 40)}
    keys = ("image", "original_size_as_tuple", "crop_coords_top_left", "target_size_as_tuple", "aesthetic_score")
    for g, w in zip(got, want):
        assert g["text"] == w["text"] and g.keys() == w.keys()
        for k in keys:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert (g["target_size_as_tuple"] == g["image"].shape[1:3]).all()
        assert g["image"].min() >= -1.0 and g["image"].max() <= 1.0
    native = {**cfg, "DECODER": "native"}
    got = list(train.build_data(native).batches(0))
    want = list(jcommon.build_data(native).batches(0))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["text"] == w["text"] and g["image"].shape == (2, 16, 16, 3)
        np.testing.assert_array_equal(g["image"], w["image"])


def test_brace_expansion_matches_jax(jax_ref):
    specs = ["a/{000..011}.tar", "b/x{0..2}_{08..10}.tar", "c.tar"]
    assert tdata.expand_shards(specs) == jdata.dataset.expand_shards(specs)
    assert tdata.expand_shards(["s/{1..3}.tar"]) == ["s/1.tar", "s/2.tar", "s/3.tar"]


def test_corrupt_shard_and_member_are_skipped(shards, tmp_path, caplog):
    """A shard that is not a tar, one that is missing, and a member that does
    not decode are skipped with a warning; every other sample comes through
    (two thread workers: the same samples as a set as one worker gives)."""
    root, paths = shards
    bad = tmp_path / "bad.tar"
    bad.write_bytes(b"not a tar file at all" * 10)
    broken = str(tmp_path / "broken.tar")
    with tarfile.open(broken, "w") as tf:
        for name, payload in (("000100.jpg", b"\xff\xd8 not a jpeg"), ("000100.json", b"{}")):
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    kw = dict(per_worker_batch_size=2, shuffle_buffer_size=1, seed=0)
    specs = [paths[0], str(bad), str(tmp_path / "missing.tar"), broken, paths[1]]
    two = list(tdata.DataPipeline(tdata.DataModuleConfig(shards_path_or_urls=specs, num_workers=2, **kw),
                                  chain(tdata)).samples())
    one = list(tdata.DataPipeline(tdata.DataModuleConfig(shards_path_or_urls=[paths[0], paths[1]], num_workers=1,
                                                         **kw), chain(tdata)).samples())
    assert_same_samples(two, one, ordered=False)
    assert len(one) == 6
    warned = caplog.text
    assert "bad.tar" in warned and "missing.tar" in warned and "000100.jpg" in warned


def test_pipe_shards_and_collation(shards):
    """A ``pipe:cat`` shard streams as the file does; collation stacks arrays
    and numbers, keeps strings as lists and only the common keys."""
    _, paths = shards
    a = list(tdata.iter_tar_samples(f"pipe:cat {paths[0]}"))
    b = list(tdata.iter_tar_samples(paths[0]))
    assert [s["__key__"] for s in a] == [s["__key__"] for s in b] and len(a) == 5
    batch = tdata.custom_collation_fn([{"x": np.ones(3), "n": 1, "t": "a", "v": [1, 2], "only": 0},
                                       {"x": np.zeros(3), "n": 2, "t": "b", "v": [3, 4]}])
    assert set(batch) == {"x", "n", "t", "v"} and batch["x"].shape == (2, 3)
    assert batch["n"].tolist() == [1, 2] and batch["t"] == ["a", "b"] and batch["v"].shape == (2, 2)


def test_prefetch_stages_tensors_and_stops(shards):
    """``prefetch_to_device`` yields the batches in order with arrays as
    tensors (unpinned without CUDA), captions untouched, and stops its
    thread when the consumer leaves early; ``DataModule`` gives the train
    pipeline's batches, and the eval pipeline's when it has one."""
    import torch

    _, paths = shards
    pipe = tdata.DataPipeline(tdata.DataModuleConfig(shards_path_or_urls=paths[:2], per_worker_batch_size=2,
                                                     num_workers=1, shuffle_buffer_size=1), chain(tdata))
    want = list(pipe.batches(0))
    got = list(tdata.prefetch_to_device(iter(want), size=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g["image"], torch.Tensor) and not g["image"].is_pinned()
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        assert g["text"] == w["text"]
    it = tdata.prefetch_to_device(iter(pipe), size=1)
    next(it)
    it.close()
    module = tdata.DataModule(pipe.config, chain(tdata))
    assert module.eval_dataloader() is None
    first = next(module.train_dataloader())
    np.testing.assert_array_equal(first["image"], want[0]["image"])
    module = tdata.DataModule(pipe.config, chain(tdata), pipe.config, chain(tdata))
    assert [b["text"] for b in module.eval_pipeline.batches(0)] == [w["text"] for w in want]


def test_process_workers_give_the_thread_workers_samples(shards):
    """Two process workers (``spawn``: ``build_data``'s chain pickles) give
    the same samples, as a set, as one thread worker."""
    root, _ = shards
    cfg = {"SHARDS_PATH_OR_URLS": [os.path.join(root, "{000000..000002}.tar")], "IMAGE_SIZE": 16, "BATCH_SIZE": 2,
           "SHUFFLE_BUFFER_SIZE": 1}
    procs = list(train.build_data(cfg, num_workers=2, worker_backend="process").samples())
    threads = list(train.build_data(cfg, num_workers=1).samples())
    assert len(threads) == 10
    assert_same_samples(procs, threads, ordered=False)


def test_key_mappers_and_filters_match_jax(jax_ref):
    """The key mappers and filters on one sample against JAX's: a
    conditional rename (its else map too), select, remove, set, JSON keys
    (a missing key raises when strict), the key and condition filters and
    their AND."""
    sample = {"jpg": 1, "txt": "a", "json": json.dumps({"caption": "c", "score": 7}), "extra": 3}
    cases = [
        ("KeyRenameMapper", dict(key_map={"jpg": "image"}, condition_key="extra", else_key_map={"txt": "text"}),
         (lambda v: v > 2,), None),
        ("KeyRenameMapper", dict(key_map={"jpg": "image"}, condition_key="extra", else_key_map={"txt": "text"}),
         (lambda v: v > 5,), None),
        ("SelectKeysMapper", dict(keys=["jpg", "missing", "txt"]), (), None),
        ("RemoveKeysMapper", dict(keys=["extra", "json"]), (), None),
        ("SetValueMapper", dict(key="flag", value=[1, 2]), (), None),
        ("KeysFromJSONMapper", dict(key="json", keys_to_extract=["caption", "score"], remove_original=True), (), None),
        ("KeysFromJSONMapper", dict(key="json", keys_to_extract=["caption", "nope"], strict=True), (), KeyError),
    ]
    for name, kw, extra, raises in cases:
        make = lambda pkg: getattr(pkg, name)(getattr(pkg, name + "Config")(**kw), *extra)
        if raises:
            for pkg in (tdata, jdata):
                with pytest.raises(raises):
                    make(pkg)(dict(sample))
            continue
        assert make(tdata)(dict(sample)) == make(jdata)(dict(sample)), name
    for pkg in (tdata, jdata):
        key = pkg.KeyFilter(pkg.KeyFilterConfig(keys=["jpg", "txt"]))
        cond = pkg.FilterOnCondition(pkg.FilterOnConditionConfig(condition_key="extra"), lambda v: v >= 3)
        loose = pkg.FilterOnCondition(pkg.FilterOnConditionConfig(condition_key="none", strict=False), bool)
        both = pkg.FilterWrapper([key, cond, loose])
        assert (key(sample), cond(sample), loose(sample), both(sample), both({"jpg": 1})) == (
            True, True, True, True, False)
