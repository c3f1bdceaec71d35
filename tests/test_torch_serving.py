"""The port's serving layer (``serving.py``), PEFT import and LoRA hot swap.

Ports of ``tests/test_serving.py`` on the tiny port pipeline (CPU, fp32):
request coalescing onto fixed batch shapes, per-request seeds (a request's
image is the same alone and in a padded batch), the HTTP endpoints,
``/loras`` with a PEFT file in float and int8 mode, and a LoRA load racing
a ``generate`` on the batcher's thread. Every wait has its own timeout.
A request alone and in a batch differ only by the CPU kernels' batch-size
dependent summation order (~1e-6 here); a wrong noise chain would give a
different image. Tests marked ``cuda`` serve one request on the card.
"""

import base64
import json
import struct
import sys
import threading
import time
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.lora import from_peft, init_lora, load_peft_safetensors
from flash_diffusion_tpu_torch.serving import (
    DynamicBatcher,
    InferenceServer,
    ServingConfig,
    _device_uint8,
    _to_png_bytes,
)
from test_torch_pipeline import tiny_port_pipeline

try:  # the JAX reference; absent where only the port is installed
    from flash_diffusion_tpu import lora as jlora
except ImportError:
    jlora = None

torch.set_num_threads(2)
WAIT = 60  # seconds: the longest any single request or thread may take here


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    return torch.device("cuda")


def same_image(a, b, rtol=1e-4):
    """Equal up to batch-size dependent summation order (scale-aware)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.allclose(a, b, atol=rtol * max(np.abs(b).max(), 1.0), rtol=rtol)


def wait_all(reqs):
    for r in reqs:
        assert r.event.wait(WAIT), "request timed out"
        assert r.error is None, r.error


def random_lora(pipe, seed=7, b_std=0.05):
    tree = init_lora(pipe.denoiser, 2, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for ab in tree.values():
        ab["b"].normal_(0.0, b_std, generator=g)
    return tree


def write_peft(path, tree, alpha=None):
    """A PEFT adapter file of a port LoRA tree (A as [r, in], B as [out, r])."""
    from safetensors.torch import save_file

    tensors = {}
    for name, ab in tree.items():
        tensors[f"unet.{name}.lora_A.weight"] = ab["a"].t().contiguous()
        tensors[f"unet.{name}.lora_B.weight"] = ab["b"].t().contiguous()
    save_file(tensors, str(path))
    return str(path)


def png_size(png: bytes):
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    width, height, depth, color = struct.unpack(">IIBB", png[16:26])
    return width, height, depth, color


def test_dynamic_batcher_coalesces_and_is_seed_deterministic():
    pipe = tiny_port_pipeline()
    cfg = ServingConfig(uint8_images=False, max_batch=4, linger_ms=200.0, batch_sizes=(1, 2, 4))
    batcher = DynamicBatcher(pipe, cfg).start()
    try:
        lone = batcher.submit("cat", seed=7, steps=2, guidance=0.0)
        wait_all([lone])
        lone_dog = batcher.submit("dog", seed=8, steps=2, guidance=0.0)
        wait_all([lone_dog])
        reqs = [batcher.submit(p, seed=s, steps=2, guidance=0.0)
                for p, s in [("cat", 7), ("dog", 8), ("owl", 9)]]
        wait_all(reqs)
        assert all(np.isfinite(r.image).all() for r in reqs)
        assert batcher.images_generated == 5 and batcher.batches_dispatched == 3
        assert batcher.slots_dispatched == 1 + 1 + 4  # three coalesced, padded to 4
        assert same_image(reqs[0].image, lone.image)
        assert same_image(reqs[1].image, lone_dog.image)  # a non-zero slot too
        assert not np.allclose(reqs[0].image, reqs[1].image)
    finally:
        batcher.stop()


def test_decode_chunk_matches_whole_batch():
    """Serial chunked decode returns the whole-batch images (to the CPU
    convolutions' batch-size dependent summation order, ~1e-6)."""
    pipe = tiny_port_pipeline()
    prompts, seeds = [f"p{i}" for i in range(4)], list(range(4))
    whole = pipe.generate(prompts, num_inference_steps=2, seed=seeds)
    pipe.decode_chunk = 2
    decoded = []
    decode = pipe.vae.decode_latents
    pipe.vae.decode_latents = lambda z: decoded.append(z.shape[0]) or decode(z)
    chunked = pipe.generate(prompts, num_inference_steps=2, seed=seeds)
    assert decoded == [2, 2]
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-5, rtol=0)
    pipe.decode_chunk = 3  # does not divide 4: one whole-batch decode
    pipe.generate(prompts, num_inference_steps=2, seed=seeds)
    assert decoded == [2, 2, 4]


def test_take_batch_defers_mismatches_to_front():
    pipe = tiny_port_pipeline()
    batcher = DynamicBatcher(pipe, ServingConfig(max_batch=4, linger_ms=30.0, batch_sizes=(1, 2, 4)))
    a1 = batcher.submit("a", seed=0, steps=2, guidance=0.0)
    b = batcher.submit("b", seed=0, steps=8, guidance=0.0)  # another key
    a2 = batcher.submit("c", seed=0, steps=2, guidance=0.0)
    first = batcher._take_batch()
    assert first == [a1]  # stops at the mismatch
    assert batcher._deferred and batcher._deferred[0] is b
    assert batcher._take_batch()[0] is b  # the deferred request leads the next cycle
    assert batcher._take_batch()[0] is a2


def test_handle_generate_empty_prompts_is_bad_request():
    server = InferenceServer(tiny_port_pipeline(), ServingConfig())
    out = server.handle_generate({"prompt": []})
    assert out["error"] and out["code"] == 400


def test_inference_server_handle_and_metrics():
    server = InferenceServer(tiny_port_pipeline(),
                             ServingConfig(uint8_images=False, max_batch=2, linger_ms=5.0, batch_sizes=(1, 2)))
    server.batcher.start()
    try:
        out = server.handle_generate({"prompt": "fox", "steps": 2, "seed": 3}, timeout=WAIT)
        assert "error" not in out
        assert len(out["images"]) == 1 and np.isfinite(out["images"][0]).all()
        m = server.metrics()
        assert m["requests"] == 1 and m["images_generated"] == 1 and m["errors"] == 0
        assert m["latency_p50_s"] is not None
        h = server.healthz()
        assert h["ok"] and h["devices"] >= 1
    finally:
        server.batcher.stop()


def test_inference_server_http_roundtrip():
    """HTTP on 127.0.0.1, an ephemeral port: /healthz, /generate as PNG and
    as JSON, /loras, /metrics, an unknown path."""
    server = InferenceServer(tiny_port_pipeline(),
                             ServingConfig(port=0, max_batch=2, linger_ms=5.0, batch_sizes=(1, 2)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert server.ready.wait(WAIT), "server never came up"
        url = f"http://127.0.0.1:{server.address[1]}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=WAIT) as r:
            assert json.loads(r.read())["ok"]

        def post(path, body):
            req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=WAIT) as r:
                return r.headers["Content-Type"], r.read()

        kind, png = post("/generate", {"prompt": "owl", "steps": 2, "format": "png"})
        assert kind == "image/png" and png_size(png) == (16, 16, 8, 2)
        kind, data = post("/generate", {"prompt": ["owl", "cat"], "steps": 2, "format": "json"})
        pngs = [base64.b64decode(p) for p in json.loads(data)["images_png_b64"]]
        assert len(pngs) == 2 and all(png_size(p) == (16, 16, 8, 2) for p in pngs)
        with urllib.request.urlopen(f"{url}/loras", timeout=WAIT) as r:
            assert json.loads(r.read()) == {"adapters": {}}
        with urllib.request.urlopen(f"{url}/metrics", timeout=WAIT) as r:
            assert json.loads(r.read())["images_generated"] == 3
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{url}/nope", timeout=WAIT)
        assert e.value.code == 404
    finally:
        server.shutdown()
        thread.join(WAIT)
    assert not thread.is_alive()


def test_png_writer_round_trips_the_pixels():
    """``_to_png_bytes`` (the shared stdlib writer): uint8 passes through;
    float images in [-1, 1] truncate as the JAX server's do."""
    pix = np.random.default_rng(0).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    png = _to_png_bytes(pix)
    assert png_size(png) == (7, 5, 8, 2)
    at = png.index(b"IDAT")
    raw = zlib.decompress(png[at + 4: at + 4 + struct.unpack(">I", png[at - 4: at])[0]])
    rows = np.frombuffer(raw, np.uint8).reshape(5, 1 + 7 * 3)
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), pix)
    img = np.array([[[-1.0, 0.0, 1.0]]], np.float32)
    assert _to_png_bytes(img) == _to_png_bytes(np.array([[[0, 127, 255]]], np.uint8))


def test_per_request_resolution():
    """height/width per request: sizes never mix in a batch, each image has
    its requested size; a lone height is a 400."""
    pipe = tiny_port_pipeline()  # 16-pixel alignment (vae_scale_factor 2)
    cfg = ServingConfig(uint8_images=False, max_batch=4, linger_ms=100.0, batch_sizes=(1, 2, 4))
    batcher = DynamicBatcher(pipe, cfg).start()
    try:
        tall = batcher.submit("cat", seed=1, steps=2, guidance=0.0, height=32, width=16)
        wide = batcher.submit("dog", seed=2, steps=2, guidance=0.0, height=16, width=32)
        deflt = batcher.submit("owl", seed=3, steps=2, guidance=0.0)
        wait_all([tall, wide, deflt])
        assert tall.image.shape == (32, 16, 3)
        assert wide.image.shape == (16, 32, 3)
        assert deflt.image.shape == (16, 16, 3)
    finally:
        batcher.stop()
    server = InferenceServer(pipe, cfg)
    for body in ({"prompt": "x", "height": 32}, {"prompt": "x", "height": 24, "width": 16}):
        out = server.handle_generate(body)
        assert out["error"] and out["code"] == 400


def test_negative_prompt_with_cfg():
    pipe = tiny_port_pipeline()
    batcher = DynamicBatcher(pipe, ServingConfig(uint8_images=False, max_batch=2, linger_ms=5.0,
                                                 batch_sizes=(1, 2))).start()
    try:
        plain = batcher.submit("cat", seed=5, steps=2, guidance=3.0)
        wait_all([plain])
        neg = batcher.submit("cat", seed=5, steps=2, guidance=3.0, negative="dog")
        wait_all([neg])
        assert not np.allclose(plain.image, neg.image)
    finally:
        batcher.stop()


@pytest.mark.parametrize("int8", [False, True])
def test_lora_hot_swap_endpoint(tmp_path, int8):
    """/loras with a PEFT file: load changes the images, scale 0 restores
    the base images exactly, unload empties the list; bad actions are 400s.
    In int8 mode the merge happens at full precision, then the quantization."""
    pipe = tiny_port_pipeline()
    if int8:
        pipe.quantize("int8", min_dim=8)
    server = InferenceServer(pipe, ServingConfig())
    gen = lambda: pipe.generate(["cat"], num_inference_steps=2, seed=[1])
    base = gen()
    path = write_peft(tmp_path / "adapter.safetensors", random_lora(pipe))

    out = server.handle_loras({"action": "load", "path": path, "name": "style", "scale": 0.5})
    assert out == {"adapters": {"style": 0.5}}
    with_lora = gen()
    assert not torch.allclose(with_lora, base, atol=1e-3)
    assert (pipe.denoiser.state_dict()["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"].dtype
            == (torch.int8 if int8 else torch.float32))

    assert server.handle_loras({"action": "scale", "name": "style", "scale": 0.0})["adapters"] == {"style": 0.0}
    assert torch.equal(gen(), base)
    assert server.handle_loras({"action": "unload", "name": "style"}) == {"adapters": {}}
    assert torch.equal(gen(), base)
    for body in ({"action": "bogus"}, {"action": "load"}, {"action": "scale", "name": "nope", "scale": 1.0},
                 {"action": "load", "path": str(tmp_path / "missing.safetensors")}):
        out = server.handle_loras(body)
        assert out["error"] and out["code"] == 400


def test_peft_import_matches_jax(tmp_path):
    """The same PEFT file through the JAX ``load_peft_safetensors`` and the
    port's: the same factors (JAX keys its tree by the module path) and the
    same scaling, with and without alpha."""
    if jlora is None:
        pytest.skip("needs the JAX reference package")
    pipe = tiny_port_pipeline()
    tree = random_lora(pipe)
    path = write_peft(tmp_path / "a.safetensors", tree)
    for alpha in (None, 4.0):
        got, scaling = load_peft_safetensors(path, alpha=alpha)
        want, jscaling = jlora.load_peft_safetensors(path, None, alpha=alpha)
        assert scaling == jscaling == (1.0 if alpha is None else 2.0)
        assert got.keys() == tree.keys()
        for name, ab in got.items():
            node = want
            for part in name.split("."):
                node = node[part]
            for leaf in ("a", "b"):
                assert torch.equal(ab[leaf], tree[name][leaf])
                np.testing.assert_array_equal(ab[leaf].numpy(), np.asarray(node["kernel"][leaf]))
    with pytest.raises(ValueError, match="No LoRA tensors"):
        from_peft({"te.x.lora_A.weight": torch.zeros(2, 3)})


@pytest.mark.parametrize("int8", [False, True])
def test_lora_load_racing_generate(int8):
    """LoRA loads and unloads on one thread while the batcher generates on
    its own: every step of a generate sees one weight set, and each image
    is either the base one or the merged one, never a mix (a half-merged or
    half-quantized set would give a third image)."""
    pipe = tiny_port_pipeline()
    if int8:
        pipe.quantize("int8", min_dim=8)
    tree = random_lora(pipe)
    gen = lambda: pipe.generate(["cat"], num_inference_steps=2, seed=[3])
    base = gen()
    pipe.load_lora(tree, 1.0)
    merged = gen()
    pipe.unload_lora()
    assert not torch.allclose(base, merged, atol=1e-3)

    layer = pipe.denoiser.get_submodule("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q")
    seen, started = [], threading.Event()
    forward = pipe.denoiser.forward

    def slow_forward(*args, **kwargs):  # records the weights each step runs with
        seen.append(layer.weight)
        started.set()
        time.sleep(0.02)
        return forward(*args, **kwargs)

    pipe.denoiser.forward = slow_forward
    stop = threading.Event()

    def toggle():
        while not stop.is_set():
            pipe.load_lora(tree, 1.0)
            pipe.unload_lora()

    batcher = DynamicBatcher(pipe, ServingConfig(uint8_images=False, max_batch=1, linger_ms=0.0,
                                                 batch_sizes=(1,))).start()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    toggler = threading.Thread(target=toggle, daemon=True)
    try:
        reqs = [batcher.submit("cat", seed=3, steps=2, guidance=0.0)]
        assert started.wait(WAIT)
        toggler.start()
        reqs += [batcher.submit("cat", seed=3, steps=2, guidance=0.0) for _ in range(5)]
        wait_all(reqs)
    finally:
        sys.setswitchinterval(switch)
        stop.set()
        toggler.join(WAIT)
        batcher.stop()
    assert not toggler.is_alive()
    assert len(seen) == 2 * len(reqs)
    for i, r in enumerate(reqs):
        assert seen[2 * i] is seen[2 * i + 1], "a generate saw two weight sets"
        assert same_image(r.image, base[0].numpy(), 1e-6) or same_image(r.image, merged[0].numpy(), 1e-6)


def test_prewarm_runs_every_batch_size():
    pipe = tiny_port_pipeline()
    sizes = []
    generate = pipe.generate
    pipe.generate = lambda prompts, **kw: sizes.append((len(prompts), kw["seed"])) or generate(prompts, **kw)
    cfg = ServingConfig(batch_sizes=(2, 1), prewarm=True)
    InferenceServer(pipe, cfg).prewarm()
    assert sizes == [(1, [0]), (2, [0, 1])]


def test_metrics_batch_occupancy_and_profile(tmp_path):
    server = InferenceServer(tiny_port_pipeline(), ServingConfig(max_batch=4, linger_ms=5.0, batch_sizes=(2, 4)))
    server.batcher.start()
    try:
        assert "error" not in server.handle_generate({"prompt": "fox", "steps": 2}, timeout=WAIT)
        assert server.metrics()["batch_occupancy"] == 0.5  # 1 image in a padded batch of 2
        prof = server.handle_profile({"seconds": 0.2, "dir": str(tmp_path / "tr")})
        assert prof["trace_dir"] == str(tmp_path / "tr") and (tmp_path / "tr" / "trace.json").exists()
        bad = server.handle_profile({"seconds": 0})
        assert bad["error"] and bad["code"] == 400
    finally:
        server.batcher.stop()


def test_uint8_image_transfer_default():
    """Images leave the device as uint8, equal to the host conversion of the
    float images to one step (device vs host rounding of one affine map)."""
    pipe = tiny_port_pipeline()
    ref = pipe.generate(["cat"], num_inference_steps=2, seed=[3])[0].numpy()
    cfg = ServingConfig(max_batch=1, linger_ms=5.0, batch_sizes=(1,))
    assert cfg.uint8_images
    batcher = DynamicBatcher(pipe, cfg).start()
    try:
        r = batcher.submit("cat", seed=3, steps=2, guidance=0.0)
        wait_all([r])
    finally:
        batcher.stop()
    assert r.image.dtype == np.uint8
    expect = np.clip((ref + 1.0) * 127.5, 0, 255).astype(np.uint8)
    assert np.abs(r.image.astype(np.int16) - expect.astype(np.int16)).max() <= 1
    assert _device_uint8(torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0])).tolist() == [0, 0, 127, 255, 255]
    assert _to_png_bytes(r.image)[:4] == b"\x89PNG"


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_int8_request_served_on_card(cuda):
    """One request through the batcher on the card, int8 with a merged LoRA:
    a finite image, the int8 GEMM kernel launched, and the same image as a
    direct ``generate`` with the request's seed (the batcher's padding and
    seed plumbing change nothing). The card's int8 path against the CPU is
    ``test_int8_pipeline_launches_the_kernel_on_card``."""
    from flash_diffusion_tpu_torch.ops import gemm

    pipe = tiny_port_pipeline(cuda, torch.bfloat16)
    pipe.load_lora(random_lora(tiny_port_pipeline()), 1.0)
    pipe.quantize("int8", min_dim=32)  # K11 takes K % 32 == 0
    server = InferenceServer(pipe, ServingConfig(uint8_images=False, max_batch=1, batch_sizes=(1,)))
    server.batcher.start()
    gemm.LAUNCHES.clear()
    try:
        out = server.handle_generate({"prompt": "fox", "seed": 3}, timeout=WAIT)
    finally:
        server.batcher.stop()
    assert "error" not in out, out
    assert gemm.LAUNCHES["int8_gemm"] > 0
    got = torch.tensor(out["images"][0])
    assert torch.isfinite(got).all()
    assert torch.equal(got, pipe.generate(["fox"], seed=[3])[0].cpu())


@pytest.mark.cuda
def test_port_ops_batch_invariant_on_card(cuda):
    """The port's own ops give slot 1 of a batch of 4 the bits it gets
    alone: GroupNorm (statistics and apply kernels, fold), LayerNorm, the
    streaming, one-shot and packed attention kernels, and the int8 product
    (per-token codes, K11) at SDXL's 128² shapes. What remains of the
    batch dependence is cuDNN's and cuBLAS's (``FlashPipeline.generate``)."""
    from flash_diffusion_tpu_torch.models.layers import lora_dense
    from flash_diffusion_tpu_torch.ops import dot_product_attention, group_norm, layer_norm
    from flash_diffusion_tpu_torch.quant import quantize_weight

    g = torch.Generator(device=cuda).manual_seed(0)
    bf = lambda *shape: torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
    w, b = bf(320), bf(320)
    wq, ws = quantize_weight(bf(640, 640))
    bias = bf(640)
    cases = [  # (op, its batch-4 inputs)
        (lambda x: group_norm(x, 32, w, b, 1e-5, act="silu"), (bf(4, 320, 16, 16),)),
        (lambda x: group_norm(x, 32, w, b, 1e-5, act="silu"),
         (bf(4, 320, 16, 16).to(memory_format=torch.channels_last),)),
        (lambda x: layer_norm(x, w, b), (bf(4, 64, 320),)),
        (lambda x: dot_product_attention(x, x, x), (bf(4, 1024, 10, 64),)),  # streaming
        (lambda x: dot_product_attention(x, x, x), (bf(4, 64, 20, 64),)),  # one-shot
        (lambda x, c: dot_product_attention(x, c, c), (bf(4, 256, 10, 64), bf(4, 77, 10, 64))),  # packed
        (lambda x: lora_dense(x, wq, bias, None, ws), (bf(4, 64, 640),)),  # int8
    ]
    for op, inputs in cases:
        assert torch.equal(op(*inputs)[1], op(*(t[1:2] for t in inputs))[0])


@pytest.mark.cuda
def test_request_alone_vs_batched_within_contract_on_card(cuda):
    """The measured contract of ``FlashPipeline.generate``: SDXL at 128²
    with per-sample seeds, a request alone against slot 1 of a batch of 4,
    differs only by cuDNN/cuBLAS's batch-size-dependent algorithms: rel. L2
    ≤ 1.5e-2 in bf16 and in int8 (H100: 9.2e-3 and 9.8e-3), where another
    seed's image differs by ~1.3."""
    from flash_diffusion_tpu_torch.sample import build_pipeline

    pipe = build_pipeline("sdxl", device=cuda, seed=0)
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    for mode in ("bf16", "int8"):
        if mode == "int8":
            pipe.quantize("int8")
        alone = pipe.generate(["a raccoon"], seed=[21], height=128, width=128)
        batch = pipe.generate(["a cat", "a raccoon", "a dog", "a fox"], seed=[20, 21, 22, 23], height=128, width=128)
        assert rel(batch[1], alone[0]) <= 1.5e-2, mode
        assert rel(batch[0], batch[1]) > 0.5
