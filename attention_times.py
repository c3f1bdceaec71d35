#!/usr/bin/env python3
"""Device times of the one-shot attention kernels, K1 and K8, in two trees on one card.

    python3 attention_times.py --base DIR [--order base,this,this,base]

For each tree of ``--order`` in turn (``this``: the checkout; ``base``:
another checkout of the repo, such as a parent commit unpacked with ``git
archive``), one process imports that tree's port and its own
``chip_smoke.py`` and runs its phase-2 checks with timing
(``check_attention`` and ``check_attention_bwd``: CUDA events around 10
queued calls, median of 5, beside the plain version, SDPA and the bound),
cut to the shapes that take K1 in ``ATTENTION_SHAPES`` and that take K8 in
``BWD_SHAPES`` (BH 32 and 64). Each process builds that tree's kernels.
Prints each tree's lines and, last, a table of kernel ms per shape and
tree. Needs a CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def child(root: str) -> None:
    sys.path.insert(0, root)  # that tree's port and chip_smoke before the checkout's
    import chip_smoke as cs
    from flash_diffusion_tpu_torch.ops import attention, kernels

    kernels.library()
    fwd = [s for s in cs.ATTENTION_SHAPES if attention.attention_plan(s[2], s[3])[0] == "flash_fwd_oneshot"]
    bwd = [s for s in cs.BWD_SHAPES if attention.attention_bwd_plan(s[2], s[3])[0] == "flash_bwd_oneshot"]
    cs.ATTENTION_SHAPES, cs.ATTENTION_SHAPES_XL, cs.ATTENTION_SHAPES_PIXART, cs.ATTENTION_RAGGED = fwd, [], [], []
    cs.ATTENTION_V_SHIFTED = []
    cs.BWD_SHAPES, cs.BWD_RAGGED = bwd, []
    names = ("flash_fwd_oneshot", "flash_fwd_stream", "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_oneshot")
    results = {n: cs.new_row("cuda", "", "") for n in names}
    cs.check_attention(attention, results)
    cs.check_attention_bwd(attention, kernels, results)


def kernel_ms(lines):
    """{(kind, shape text): kernel ms} from the checks' printed lines."""
    out = {}
    for line in lines:
        if not line.startswith("attention") or "kernel " not in line:
            continue
        words = line.split()
        kind = words[2] if words[1] == "backward" else words[1]
        shape = line[line.index("bh="):line.index(" kv_valid")]
        out[(kind, " ".join(shape.split()))] = float(line.split("kernel ")[1].split(" ms")[0])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="root of the other tree")
    ap.add_argument("--order", default="base,this,this,base")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_times: needs an NVIDIA GPU")
    roots = {"this": str(ROOT), "base": str(Path(args.base).resolve()) if args.base else None}
    table, failed = {}, False
    for i, which in enumerate(args.order.split(",")):
        run = subprocess.run([sys.executable, __file__, "--child", roots[which]], capture_output=True, text=True,
                             cwd=roots[which])
        print(f"== {which} ({roots[which]}), run {i}, rc {run.returncode}")
        print(run.stdout)
        if run.returncode:
            print(run.stderr[-3000:])
            failed = True
        for key, ms in kernel_ms(run.stdout.splitlines()).items():
            table.setdefault(key, {}).setdefault(which, []).append(ms)
    for (kind, shape), by in table.items():
        print(f"{kind:17s} {shape:38s} " + "  ".join(f"{w} {' / '.join(f'{x:.4f}' for x in v)}" for w, v in by.items()))
    print(json.dumps({f"{k} {s}": by for (k, s), by in table.items()}))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
