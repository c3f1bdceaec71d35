#!/usr/bin/env python3
"""Device times of the redesigned kernels in two trees on one card, in turns.

    python3 kernel_times.py --base DIR [--order base,this,this,base] [--kernels k1,k2,k8,k10] [--sweep]

For each tree of ``--order`` in turn (``this``: the checkout; ``base``:
another checkout of the repo, such as a parent commit unpacked with ``git
archive``), one process imports that tree's port and its own
``chip_smoke.py`` and runs its phase-2 checks with timing (CUDA events
around 10 queued calls, median of 5, beside the plain version, the
library call and the bound), cut to the main-path shapes of the kernels
asked for:

- ``k1``: ``check_attention`` at the ``ATTENTION_SHAPES`` that take K1
  (the one-shot forward);
- ``k2``: ``check_attention`` at every ``ATTENTION_SHAPES*`` shape that
  takes K2 (the streaming forward: SD1.5, SDXL, Pixart, the VAE);
- ``k8``: ``check_attention_bwd`` at the ``BWD_SHAPES`` that take K8;
- ``k10``: ``check_ffn_gemm`` at ``FFN_SHAPES`` and ``FFN_DW_SHAPES``
  (K12 at ``FFN_SHAPES`` comes along, the check's other kernel).

Each process builds that tree's kernels. With ``--sweep``, the checkout's
process also times K10 at every tile width it is built for (112, 128, 160,
224, 256) at those shapes, the sweep behind ``ops/gemm.py gemm_plan``. Prints
each tree's lines and, last, a table of kernel ms per shape and tree.
Needs a CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def sweep(cs, gemm, kernels):
    """K10 at each built tile width, at its main-path shapes (this tree)."""
    import torch

    lib = kernels.library()
    g = torch.Generator(device="cuda").manual_seed(9)
    for m, k, n in cs.FFN_SHAPES + cs.FFN_DW_SHAPES:
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device="cuda") * k ** -0.5).to(torch.bfloat16)
        b = torch.zeros(n, device="cuda", dtype=torch.bfloat16)
        y = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        for bn in (112, 128, 160, 224, 256):
            run = lambda: kernels.check(lib.fdt_gemm_sm90(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                                          m, n, k, bn, stream), "gemm sweep")
            ms = cs.median_ms(run)
            tiles = -(-m // 128) * -(-n // bn)
            print(f"sweep gemm M={m:5d} K={k:5d} N={n:4d} bn={bn}: {ms:.4f} ms ({tiles} tiles)"
                  f"{' <- plan' if gemm.gemm_plan(k, n).bn == bn else ''}")


def child(root: str, which: str, do_sweep: bool) -> None:
    sys.path.insert(0, root)  # that tree's port and chip_smoke before the checkout's
    import chip_smoke as cs
    from flash_diffusion_tpu_torch.ops import attention, gemm, kernels

    kernels.library()
    print(f"card: {cs.card_line()}")
    fwd = lambda kind: [s for s in cs.ATTENTION_SHAPES + cs.ATTENTION_SHAPES_XL + cs.ATTENTION_SHAPES_PIXART
                        if attention.attention_plan(s[2], s[3])[0] == kind]
    shapes = {"k1": fwd("flash_fwd_oneshot") if "k1" in which else [],
              "k2": fwd("flash_fwd_stream") if "k2" in which else []}
    cs.ATTENTION_SHAPES = shapes["k1"] + shapes["k2"]
    cs.ATTENTION_SHAPES_XL, cs.ATTENTION_SHAPES_PIXART, cs.ATTENTION_RAGGED, cs.ATTENTION_V_SHIFTED = [], [], [], []
    names = ("flash_fwd_oneshot", "flash_fwd_stream", "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_oneshot", "gemm",
             "geglu_gemm")
    results = {n: cs.new_row("cuda", "", "") for n in names}
    if cs.ATTENTION_SHAPES:
        cs.check_attention(attention, results)
    if "k8" in which:
        cs.BWD_SHAPES = [s for s in cs.BWD_SHAPES if attention.attention_bwd_plan(s[2], s[3])[0] == "flash_bwd_oneshot"]
        cs.BWD_RAGGED = []
        cs.check_attention_bwd(attention, kernels, results)
    if "k10" in which:
        cs.FFN_RAGGED = []
        cs.check_ffn_gemm(gemm, results)
        if do_sweep:
            sweep(cs, gemm, kernels)


def kernel_ms(lines):
    """{(kind, shape text): kernel ms} from the checks' printed lines."""
    out = {}
    for line in lines:
        if "kernel " not in line or " ms" not in line:
            continue
        words = line.split()
        if line.startswith("attention"):
            kind = words[2] if words[1] == "backward" else words[1]
            shape = line[line.index("bh="):line.index(" kv_valid")]
        elif words[0] in ("gemm", "geglu_gemm"):
            kind = words[0] + (" dW" if words[1] == "dW" else "")
            shape = line[line.index("M="):line.index(":")]
        else:
            continue
        out[(kind, " ".join(shape.split()))] = float(line.split("kernel ")[1].split(" ms")[0])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="root of the other tree")
    ap.add_argument("--order", default="base,this,this,base")
    ap.add_argument("--kernels", default="k1,k2,k8,k10")
    ap.add_argument("--sweep", action="store_true", help="also sweep K10's tile width in this tree")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    if args.child:
        return child(args.child, which, args.sweep)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs an NVIDIA GPU")
    roots = {"this": str(ROOT), "base": str(Path(args.base).resolve()) if args.base else None}
    table, failed, swept = {}, False, False
    for i, tree in enumerate(args.order.split(",")):
        cmd = [sys.executable, __file__, "--child", roots[tree], "--kernels", args.kernels]
        if args.sweep and tree == "this" and not swept:
            cmd.append("--sweep")
            swept = True
        run = subprocess.run(cmd, capture_output=True, text=True, cwd=roots[tree])
        print(f"== {tree} ({roots[tree]}), run {i}, rc {run.returncode}")
        print(run.stdout)
        if run.returncode:
            print(run.stderr[-3000:])
            failed = True
        for key, ms in kernel_ms(run.stdout.splitlines()).items():
            table.setdefault(key, {}).setdefault(tree, []).append(ms)
    for (kind, shape), by in table.items():
        print(f"{kind:17s} {shape:38s} " + "  ".join(f"{w} {' / '.join(f'{x:.4f}' for x in v)}" for w, v in by.items()))
    print(json.dumps({f"{k} {s}": by for (k, s), by in table.items()}))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
