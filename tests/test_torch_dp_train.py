"""The port's data-parallel and FSDP training (``trainer/trainer.py``).

Two gloo ranks on the CPU through ``parallel.spawn`` run the rank bodies
of ``tests/torch_parallel_workers.py``; JAX runs here alone. fp32:

- one distillation step (the tiny setup of ``tests/test_torch_train.py``:
  DMD and hinge GAN, K = [2, 2]) at a global batch of 4, each rank on its
  2 rows with the global batch's draws (``jax_step_draws``): the LoRA and
  discriminator gradients averaged over the group equal
  ``jax.value_and_grad`` at the global batch to 1e-4, as the single
  process does, and the group's mean losses JAX's;
- ``fit`` of the tiny trainer of ``tests/test_torch_trainer_run.py`` (a
  VAE encode, a conditioner with ucg drops, ``remat``) over global batches
  of 4: two simultaneous steps, and two alternating G/D steps with
  accumulation 2, leave both ranks' LoRA and discriminator bit-equal and
  equal to one process at the global batch (the port's own draws: the
  ranks draw the global batch's and take their rows) to 1e-6, the logged
  losses too;
- FSDP (``frozen_sharding="fsdp"``, the frozen modules sharded over the
  group) steps as the replicated trainer does, and ``switch_teacher``'s
  merge into the sharded teacher equals the replicated merge; so too with
  the text towers offloaded (their shards on the host between bursts), on
  a tree with conv pairs and with ``lora_mode="merge"`` (the merged-weights
  student over the sharded denoiser), and ``build_trainer("sd3")`` on
  ``flash_sd3.yaml`` (T5, the towers offloaded) at tiny width;
- the teacher's ``lora_disabled`` holds on its own thread and in a
  checkpoint's recompute only.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from flash_diffusion_tpu_torch.distill import DiscriminatorConfig
from flash_diffusion_tpu_torch.models import UNetConfig
from flash_diffusion_tpu_torch.parallel import spawn
from flash_diffusion_tpu_torch.utils import discriminator_from_jax, lora_from_jax, unet_from_jax

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu.distill import FlashDiffusion as JFlashDiffusion
    from flash_diffusion_tpu.distill import FlashDiffusionConfig as JFlashDiffusionConfig
    from flash_diffusion_tpu.distill.discriminator import ConvDiscriminator as JConvDiscriminator
    from flash_diffusion_tpu.distill.discriminator import DiscriminatorConfig as JDiscriminatorConfig
    from test_torch_sd3_train import SD3_TINY
    from test_torch_train import jax_step_draws
except ImportError:
    jax = None

torch.set_num_threads(2)
JOIN = 300  # seconds: the longest a spawn may take here
B, HW, C = 4, 16, 4  # the global batch of the JAX step; 2 rows a rank
FLASH_KW = dict(K=[2, 2], num_iterations_per_K=[2, 2], guidance_scale_min=1.0, guidance_scale_max=3.0,
                distill_loss_type="l2", mixture_num_components=2, use_dmd_loss=True, gan_loss_type="hinge",
                adversarial_loss_scale=[0.5, 1.0])
DISC_KW = dict(feature_dim=8, num_stages=1)


def perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), params)


def flax_params(module, seed, *args):
    """``module.init``'s tree filled from a numpy seed (kernels N(0,
    1/fan-in), biases 0, norm scales 1), then ``perturbed``: the shapes
    from ``jax.eval_shape``, so that no init is compiled or run."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name in ("bias", "scale"):
            return np.full(leaf.shape, float(name == "scale"), np.float32)
        fan_in = max(1, int(np.prod(leaf.shape[:-1])))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return perturbed(jax.tree_util.tree_map_with_path(fill, jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)),
                     seed + 1)


def close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0, err_msg=msg)


@pytest.fixture(scope="module")
def dp_run():
    """JAX's loss and gradients at the global batch, and the two ranks'
    ``dp_all`` on the port's spec of the same step (weights carried by
    ``utils/convert.py``, the draws), the ranks running while JAX compiles."""
    if jax is None:
        pytest.skip("needs the JAX reference package")
    net = jm.UNet2DCondition(jm.UNetConfig(**W.DP_UNET_KW))
    uparams = flax_params(net, 0, jnp.zeros((1, HW, HW, C)), jnp.zeros((1,)),
                          {"cond": {"crossattn": jnp.zeros((1, 8, 16))}})
    jdisc = JConvDiscriminator(JDiscriminatorConfig(**DISC_KW))
    dparams = flax_params(jdisc, 3, jnp.zeros((B, HW // 2, HW // 2, 32)))
    lora = perturbed(jlora.init_lora(uparams, 2, jax.random.PRNGKey(5)), 6)
    jmodel = JFlashDiffusion(JFlashDiffusionConfig(**FLASH_KW), student_module=net, teacher_module=net,
                             discriminator=jdisc, lora_scaling=0.5)
    rng = np.random.default_rng(18)
    z = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    conds = [rng.standard_normal((B, 8, 16)).astype(np.float32) for _ in range(3)]
    conds[2][:] = 0.0  # the dropped-text uncond
    jbatch = {"__z": jnp.asarray(z), "__conds": tuple({"cond": {"crossattn": jnp.asarray(c)}} for c in conds)}
    stage, key = 1, jax.random.PRNGKey(19)
    ucfg, dcfg = UNetConfig(**W.DP_UNET_KW), DiscriminatorConfig(**DISC_KW)
    spec = dict(unet_kw=W.DP_UNET_KW, unet=unet_from_jax(uparams, ucfg), disc_kw=DISC_KW, disc_in=32,
                disc=discriminator_from_jax(dparams, dcfg), flash_kw=FLASH_KW, lora=lora_from_jax(lora, ucfg),
                draws=jax_step_draws(jmodel, key, stage, z), z=torch.from_numpy(z),
                conds=[torch.from_numpy(c) for c in conds], stage=stage, sd3=SD3_TINY)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, W.dp_all, 2, "gloo", args=(spec,), timeout=JOIN)
        loss_fn = lambda tr: jmodel.losses(tr, {"teacher": uparams}, jbatch, key, stage)
        (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))({"lora": lora, "disc": dparams})
        want = dict(total=float(total), aux={k: float(v) for k, v in aux.items() if np.ndim(v) == 0},
                    lora=lora_from_jax(grads["lora"], ucfg), disc=discriminator_from_jax(grads["disc"], dcfg))
        return want, ranks.result()


@pytest.fixture(scope="module")
def dp_grads(dp_run):
    return [r["grads"] for r in dp_run[1]]


@pytest.fixture(scope="module")
def dp_fits(dp_run):
    return [r["fits"] for r in dp_run[1]]


def test_dp_gradients_match_jax_at_the_global_batch(dp_run, dp_grads):
    """Each rank's averaged LoRA and discriminator gradients equal
    ``jax.value_and_grad`` at the global batch to 1e-4 (fp32 sums in
    another order, as in ``test_torch_train.py``), bit-equal across the
    ranks; the group's mean losses are JAX's."""
    want = dp_run[0]
    for out in dp_grads:
        for name, ab in want["lora"].items():
            for k in ("a", "b"):
                close(out["lora"][name][k], want["lora"][name][k], 1e-4, f"{name}.{k}")
        for name, g in want["disc"].items():
            close(out["disc"][name], g, 1e-4, name)
        for k in ("loss/distill", "loss/dmd", "loss/gan_g", "loss/gan_d", "loss/generator"):
            close(out["aux"][k], want["aux"][k], 1e-4, k)
    a, b = dp_grads
    assert all(torch.equal(a["lora"][n][k], b["lora"][n][k]) for n in a["lora"] for k in ("a", "b"))
    assert all(torch.equal(a["disc"][n], b["disc"][n]) for n in a["disc"])


def assert_same_state(got, want, atol, what):
    assert got.keys() == want.keys()
    for k in want:
        if atol == 0:
            assert torch.equal(got[k], want[k]), (what, k)
        else:
            close(got[k], want[k], atol, f"{what} {k}")


def assert_same_losses(got, want, what):
    """The logged losses by step, each within 1e-5 of max(1, |want|)."""
    assert len(got) == len(want), what
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), what
        for k, v in w.items():
            assert abs(g[k] - v) <= 1e-5 * max(1.0, abs(v)), (what, step, k, g[k], v)


@pytest.mark.parametrize("mode,cfg_kw,train_kw", [
    ("simultaneous", None, None),
    ("alternating", {"gan_update_mode": "alternating"}, {"gradient_accumulation_steps": 2}),
])
def test_dp_fit_equals_one_process_at_the_global_batch(dp_fits, mode, cfg_kw, train_kw):
    """Two steps over global batches of 4: the ranks' LoRA and
    discriminator bit-equal after them, and within 1e-6 of one process
    stepping on the whole batches (the same draws), the logged (group
    mean) losses within 1e-5 relative."""
    a, b = dp_fits
    assert_same_state(a[mode]["state"], b[mode]["state"], 0, mode)
    _, single = W.run_fit(cfg_kw, train_kw, sharded=False)
    assert_same_state(a[mode]["state"], single["state"], 1e-6, mode)
    assert len(a[mode]["losses"]) == len(single["losses"]) == 2
    for got, want in zip(a[mode]["losses"], single["losses"]):
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), (mode, k, got[k], v)


def test_fsdp_step_equals_replicated(dp_fits):
    """One step with the frozen modules sharded over the group equals the
    replicated data-parallel step (LoRA and discriminator within 1e-6,
    bit-equal across the ranks)."""
    a, b = dp_fits
    assert_same_state(a["fsdp_1"]["state"], b["fsdp_1"]["state"], 0, "fsdp")
    assert_same_state(a["fsdp_1"]["state"], a["replicated_1"]["state"], 1e-6, "fsdp vs replicated")
    assert a["fsdp_1"]["losses"] == pytest.approx(a["replicated_1"]["losses"], rel=1e-5)


def test_switch_teacher_merge_under_fsdp_equals_replicated(dp_fits):
    """``merge_lora_into_teacher`` writes the delta's shards into the
    sharded teacher: gathered, its weights equal the replicated merge's,
    and the merge moved them."""
    a, _ = dp_fits
    merged, want = a["merged_fsdp"], a["merged_replicated"]
    assert merged.keys() == want.keys()
    for k in want:
        close(merged[k], want[k], 1e-6, k)
    base = W.tiny_trainer().model.teacher_module.state_dict()
    assert any(not torch.allclose(want[k], base[k]) for k in want)


def test_fsdp_with_offloaded_towers_equals_replicated(dp_fits):
    """Three steps with the text towers offloaded in bursts of 2 under FSDP
    equal the replicated offloaded steps (LoRA and discriminator within
    1e-6, bit-equal across the ranks): two moves, one a burst; in each
    encode the towers' parameters are FSDP shards (a rank's local shard is
    at most half of the tensor, the two ranks' make it whole) lying in the
    offload's device copy, and after the fit on the host copy."""
    a, b = dp_fits
    rep, fsdp = a["offload_replicated"], a["offload_fsdp"]
    assert_same_state(fsdp["state"], b["offload_fsdp"]["state"], 0, "fsdp offload")
    assert_same_state(fsdp["state"], rep["state"], 1e-6, "fsdp offload vs replicated offload")
    assert_same_losses(fsdp["losses"], rep["losses"], "offload")
    assert len(fsdp["losses"]) == 3
    assert rep["moves"] == fsdp["moves"] == 2
    for r in (a, b):
        seen = r["offload_fsdp"]["seen"]
        assert len(seen) == 3 and all(s["placed"] for s in seen) and r["offload_fsdp"]["released"]
        assert all(local == whole for s in r["offload_replicated"]["seen"] for local, whole in s["sizes"])
    for sa, sb in zip(a["offload_fsdp"]["seen"], b["offload_fsdp"]["seen"]):
        for (la, whole), (lb, _) in zip(sa["sizes"], sb["sizes"]):
            assert la + lb == whole and max(la, lb) <= -(-whole // 2)
    assert sum(whole > 1 for _, whole in a["offload_fsdp"]["seen"][0]["sizes"]) > 10


@pytest.mark.parametrize("tree", ["conv", "merge"])
def test_fsdp_over_merged_weights_equals_replicated(dp_fits, tree):
    """The student on merged weights over the sharded denoiser (``conv``: a
    tree with a pair on every resnet convolution; ``merge``: the dense tree
    under ``lora_mode="merge"``): one step equals the replicated step
    (within 1e-6, bit-equal across the ranks), and ``switch_teacher``'s
    merge into the sharded teacher equals the replicated merge; the PEFT
    and kohya exports read back bit for bit (kohya's names resolved
    against the sharded student)."""
    a, b = dp_fits
    rep, fsdp = a[f"{tree}_replicated"], a[f"{tree}_fsdp"]
    assert rep["merged_student"] and fsdp["merged_student"] and rep["exports"] and fsdp["exports"]
    assert_same_state(fsdp["state"], b[f"{tree}_fsdp"]["state"], 0, tree)
    assert_same_state(fsdp["state"], rep["state"], 1e-6, f"{tree}: fsdp vs replicated")
    assert_same_losses(fsdp["losses"], rep["losses"], tree)
    assert fsdp["merged"].keys() == rep["merged"].keys()
    for k in rep["merged"]:
        close(fsdp["merged"][k], rep["merged"][k], 1e-6, k)
    if tree == "conv":
        assert any(k.startswith("lora.") and "resnets" in k for k in rep["state"])


def test_sd3_trainer_under_fsdp_equals_replicated(dp_fits):
    """``build_trainer("sd3", frozen_sharding="fsdp")`` on ``flash_sd3.yaml``
    (T5 on, the towers offloaded in bursts of 4) over tiny modules steps as
    the replicated trainer does: the LoRA within 1e-6 and bit-equal across
    the ranks, one move for the one burst."""
    a, b = dp_fits
    rep, fsdp = a["sd3"]["replicated"], a["sd3"]["fsdp"]
    assert rep["offload"] == fsdp["offload"] == 4 and rep["moves"] == fsdp["moves"] == 1
    assert_same_state(fsdp["lora"], b["sd3"]["fsdp"]["lora"], 0, "sd3 fsdp")
    assert_same_state(fsdp["lora"], rep["lora"], 1e-6, "sd3: fsdp vs replicated")
    assert_same_losses(fsdp["losses"], rep["losses"], "sd3")
    assert len(fsdp["losses"]) == 1


def test_lora_disabled_holds_on_its_own_thread_only():
    """The FSDP teacher's ``lora_disabled`` is per thread: a student forward
    on another thread meanwhile keeps its LoRA pair, and the setting holds
    in a ``remat_call``'s recompute, wherever autograd runs it."""
    import threading

    from flash_diffusion_tpu_torch.models.layers import LoraLinear, lora_disabled, remat_call

    g = torch.Generator().manual_seed(0)
    layer = LoraLinear(8, 6)
    a = torch.randn(8, 2, generator=g).requires_grad_()
    layer.lora = (a, torch.randn(2, 6, generator=g), 0.5)
    x = torch.randn(3, 8, generator=g)
    with torch.no_grad():
        plain, with_lora = torch.nn.functional.linear(x, layer.weight, layer.bias), layer(x)
    assert (with_lora - plain).abs().max() > 1e-2
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def teacher():
        with lora_disabled():
            with torch.no_grad():
                seen["teacher"] = layer(x)
            inside.set()
            release.wait(10)

    t = threading.Thread(target=teacher)
    t.start()
    inside.wait(10)
    with torch.no_grad():
        seen["student"] = layer(x)
    release.set()
    t.join(10)
    torch.testing.assert_close(seen["teacher"], plain, rtol=0, atol=0)
    torch.testing.assert_close(seen["student"], with_lora, rtol=0, atol=0)
    with lora_disabled():  # no grad reaches the pair through the teacher's recompute
        y = remat_call(layer, x.requires_grad_())
    y.sum().backward()
    assert a.grad is None and x.grad is not None
