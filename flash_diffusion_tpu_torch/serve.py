"""HTTP inference server of the port (the counterpart of ``examples/serve.py``).

    python -m flash_diffusion_tpu_torch.serve --model sdxl --int8 \\
        [--lora adapter.safetensors] [--port 8500] [--prewarm]
    python -m flash_diffusion_tpu_torch.serve --model pixart [--port 8500]

    curl -s localhost:8500/healthz
    curl -s -X POST localhost:8500/generate \\
        -d '{"prompt": "A raccoon reading a book", "steps": 4}' > out.png
    curl -s localhost:8500/metrics
    curl -s -X POST localhost:8500/loras \\
        -d '{"action": "load", "path": "style.safetensors", "name": "style", "scale": 0.8}'

Builds ``sample.build_pipeline`` (random weights from the seed unless
``--weights-root`` holds a diffusers layout; ``--lora`` merges a PEFT
adapter), optionally switches it to the int8 W8A8 mode (``--int8``: every
attention and feed-forward projection of the UNet on the int8 GEMM kernel)
and serves it with ``serving.InferenceServer``. Request fields: prompt (str
or list), steps, guidance_scale, seed, negative_prompt, format ("png" |
"json"), height/width (multiples of 64). Not ported yet: ``--tp``,
``--compile-cache`` (no compile step here), ``--t5`` and ``--int8`` for
Pixart.
"""

from __future__ import annotations

import argparse

import torch

from .sample import MODELS, build_pipeline
from .serving import InferenceServer, ServingConfig


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="sd15", choices=MODELS)
    ap.add_argument("--weights-root", default="")
    ap.add_argument("--lora", default=None, help="PEFT safetensors adapter to merge")
    ap.add_argument("--lora-scale", type=float, default=1.0)
    ap.add_argument("--int8", action="store_true", help="W8A8 int8 serving mode (quant.py)")
    ap.add_argument("--decode-chunk", type=int, default=0, metavar="K",
                    help="decode the batch in serial chunks of K images (0: whole batch)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--linger-ms", type=float, default=10.0)
    ap.add_argument("--prewarm", action="store_true",
                    help="run every batch size once before accepting traffic")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    if args.int8 and args.model == "pixart":
        raise SystemExit("--int8 is not ported for pixart yet")
    pipe = build_pipeline(args.model, args.weights_root, device=args.device, lora=args.lora,
                          lora_scale=args.lora_scale)
    if args.int8:
        pipe.quantize("int8")
    if args.decode_chunk:
        pipe.decode_chunk = args.decode_chunk
    config = ServingConfig(
        host=args.host, port=args.port, max_batch=args.max_batch, linger_ms=args.linger_ms,
        batch_sizes=tuple(sorted({1, min(4, args.max_batch), args.max_batch})), prewarm=args.prewarm,
    )
    server = InferenceServer(pipe, config)
    print(f"serving {args.model}{' int8' if args.int8 else ''} on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
