"""HTTP inference server of the port (the counterpart of ``examples/serve.py``).

    python -m flash_diffusion_tpu_torch.serve --model sdxl --int8 \\
        [--lora adapter.safetensors] [--port 8500] [--prewarm]
    python -m flash_diffusion_tpu_torch.serve --model pixart [--int8] [--port 8500]
    python -m flash_diffusion_tpu_torch.serve --model sd3 [--t5] [--int8] [--lora adapter.safetensors]

    curl -s localhost:8500/healthz
    curl -s -X POST localhost:8500/generate \\
        -d '{"prompt": "A raccoon reading a book", "steps": 4}' > out.png
    curl -s localhost:8500/metrics
    curl -s -X POST localhost:8500/loras \\
        -d '{"action": "load", "path": "style.safetensors", "name": "style", "scale": 0.8}'

Builds ``sample.build_pipeline`` (random weights from the seed unless
``--weights-root`` holds a diffusers layout; ``--lora`` merges a PEFT
adapter, under the ``unet`` prefix, or ``transformer`` for Pixart and
SD3), optionally switches it to the int8 W8A8 mode (``--int8``: every
attention and feed-forward projection of the UNet, the DiT or the MMDiT on
the int8 GEMM kernel; the MMDiT's add_q/k/v_proj stay bf16, as in JAX) and
serves it with ``serving.InferenceServer``. ``--t5`` (sd3) adds T5-XXL over
``--t5-max-length`` tokens to SD3's two CLIP towers. Request fields: prompt
(str or list), steps, guidance_scale, seed, negative_prompt, format ("png"
| "json"), height/width (multiples of 64).

``--tp N`` serves one pipeline over N ranks, tensor-parallel
(``FlashPipeline.shard_tp``; ``serving.serve_tp_rank``): under torchrun
(``torchrun --nproc-per-node N -m flash_diffusion_tpu_torch.serve --tp N``)
each process is a rank on ``cuda:LOCAL_RANK``; without a launcher the
command spawns the N ranks itself (``parallel.spawn``, rank r on card r mod
the card count). Rank 0 binds the port. ``--dist-backend`` is the group's
backend (``nccl``; ``gloo`` for ranks that share a card). A rank's error
ends the server with a non-zero exit code. Not ported: ``--compile-cache``
(no compile step here).
"""

from __future__ import annotations

import argparse
import os

import torch

from .parallel.mesh import BACKENDS, build_kernels_once, initialize_distributed, rank, spawn, world_size
from .sample import MODELS, build_pipeline
from .serving import InferenceServer, ServingConfig, serve_tp_rank


def _pipeline(args):
    pipe = build_pipeline(args.model, args.weights_root, device=args.device, lora=args.lora,
                          lora_scale=args.lora_scale, t5=args.t5, t5_max_length=args.t5_max_length)
    if args.tp > 1:
        pipe.shard_tp()
    if args.int8:
        pipe.quantize("int8")
    if args.decode_chunk:
        pipe.decode_chunk = args.decode_chunk
    return pipe


def _config(args) -> ServingConfig:
    return ServingConfig(
        host=args.host, port=args.port, max_batch=args.max_batch, linger_ms=args.linger_ms,
        batch_sizes=tuple(sorted({1, min(4, args.max_batch), args.max_batch})), prewarm=args.prewarm,
    )


def _announce(args):
    print(f"serving {args.model}{' + T5' if args.t5 else ''}{' int8' if args.int8 else ''}"
          f"{f' over {args.tp} tensor-parallel ranks' if args.tp > 1 else ''} on http://{args.host}:{args.port}",
          flush=True)


def _tp_rank(rank, world, args):
    """One rank of ``--tp``, in a group that ``parallel.spawn`` or torchrun
    made."""
    if torch.device(args.device).type == "cuda":
        build_kernels_once()
    pipe = _pipeline(args)
    if rank == 0:
        _announce(args)
    serve_tp_rank(pipe, _config(args))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="sd15", choices=MODELS)
    ap.add_argument("--weights-root", default="")
    ap.add_argument("--lora", default=None, help="PEFT safetensors adapter to merge")
    ap.add_argument("--lora-scale", type=float, default=1.0)
    ap.add_argument("--int8", action="store_true", help="W8A8 int8 serving mode (quant.py)")
    ap.add_argument("--t5", action="store_true", help="sd3: add T5-XXL to the two CLIP towers")
    ap.add_argument("--t5-max-length", type=int, default=256)
    ap.add_argument("--decode-chunk", type=int, default=0, metavar="K",
                    help="decode the batch in serial chunks of K images (0: whole batch)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--linger-ms", type=float, default=10.0)
    ap.add_argument("--prewarm", action="store_true",
                    help="run every batch size once before accepting traffic")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks (torchrun's, or spawned here)")
    ap.add_argument("--dist-backend", default="nccl", choices=BACKENDS,
                    help="the --tp group's backend (gloo for ranks that share a card)")
    args = ap.parse_args()
    if args.t5 and args.model != "sd3":
        ap.error("--t5 is an option of --model sd3")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    if args.tp > 1:
        if os.environ.get("WORLD_SIZE"):  # torchrun: this process is one rank
            initialize_distributed(args.dist_backend)
            if world_size() != args.tp:
                raise SystemExit(f"--tp {args.tp} under a launcher of {world_size()} processes")
            _tp_rank(rank(), world_size(), args)
        else:
            spawn(_tp_rank, args.tp, args.dist_backend, args=(args,), timeout=None)
        return
    server = InferenceServer(_pipeline(args), _config(args))
    _announce(args)
    server.serve_forever()


if __name__ == "__main__":
    main()
