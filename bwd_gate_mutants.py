#!/usr/bin/env python3
"""Proof on the card that the attention backward's gate catches a wrong gradient.

    python3 bwd_gate_mutants.py

Runs ``chip_smoke.check_attention_bwd`` (untimed: every ``BWD_SHAPES`` and
``BWD_RAGGED`` case held to ``attention_bwd_gate``) three times, each in its
own process with its own kernel build: on the port as it is, then on two
copies of the port made in a temporary directory outside the checkout, each
with one fault written into ``csrc/flash_bwd.cu`` (K6 and K7):

- ``P mask removed``: keys at or past ``kv_valid`` are no longer masked;
- ``dV x 1.03``: K6 scales dV by 1.03 on store.

Passes (exit 0) when the port passes every case and each copy fails at
least one. Each run's full output goes to ``build/bwd_gate/<n>.log`` (the
checkout's git-ignored build directory); the summary is printed. Needs a
CUDA card and nvcc.
"""

import argparse
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL = "csrc/flash_bwd.cu"
# (name, [(text in KERNEL, its replacement, occurrences)])
MUTANTS = [
    ("P mask removed", [("key_ok[2] = {r0 < kv_len, r0 + 8 < kv_len};", "key_ok[2] = {true, true};", 1),
                        ("key_ok = c + (e & 1) < kv_len;", "key_ok = true;", 1)]),
    ("dV x 1.03", [("store_rows(dv + at, acc_v, 1.0f,", "store_rows(dv + at, acc_v, 1.03f,", 1)]),
]


def child(package_root: str) -> None:
    sys.path.insert(0, package_root)  # the copy's port before the checkout's
    import chip_smoke
    from flash_diffusion_tpu_torch.ops import attention, kernels

    print(f"port: {Path(attention.__file__).parents[2]}")
    kernels.library()
    print(f"kernel build: nvcc {kernels.BUILD_INFO['seconds']:.2f} s -> {kernels.BUILD_INFO['path']}")
    results = {name: chip_smoke.new_row("cuda", KERNEL, "") for name in
               ("flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_oneshot")}
    try:
        chip_smoke.check_attention_bwd(attention, kernels, results, timed=False)
        print("GATE: every case passed")
    except AssertionError as e:
        print(f"GATE: {e}")


def mutated_copy(where: Path, edits) -> Path:
    shutil.copytree(ROOT / "flash_diffusion_tpu_torch", where / "flash_diffusion_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = where / "flash_diffusion_tpu_torch" / KERNEL
    text = src.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            raise SystemExit(f"{KERNEL}: expected {count} of {old!r}, found {text.count(old)}")
        text = text.replace(old, new)
    src.write_text(text)
    return where


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bwd_gate_mutants: needs an NVIDIA GPU")
    out_dir = ROOT / "build" / "bwd_gate"
    out_dir.mkdir(parents=True, exist_ok=True)
    verdicts = []
    with tempfile.TemporaryDirectory() as tmp:
        variants = [("as built", ROOT)] + [
            (name, mutated_copy(Path(tmp) / f"m{i}", edits)) for i, (name, edits) in enumerate(MUTANTS)]
        for i, (name, root) in enumerate(variants):
            run = subprocess.run([sys.executable, __file__, "--child", str(root)], capture_output=True,
                                 text=True, cwd=ROOT)
            (out_dir / f"{i}.log").write_text(run.stdout + run.stderr)
            lines = run.stdout.splitlines()
            verdict = next((l for l in lines if l.startswith("GATE: ")), None)
            print(f"== {name} (rc {run.returncode}): {verdict}")
            for line in lines:
                if line.startswith("attention backward") and "flash_bwd_oneshot" not in line:
                    print("  " + line)
            if verdict is None:
                print(run.stderr[-3000:])
            verdicts.append(verdict)
    passed = verdicts[0] == "GATE: every case passed" and all(
        v is not None and v != "GATE: every case passed" for v in verdicts[1:])
    print(f"the gate {'passes the kernels and fails every mutant' if passed else 'did NOT separate them'}")
    sys.exit(0 if passed else 1)


if __name__ == "__main__":
    main()
