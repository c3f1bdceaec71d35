#!/usr/bin/env python3
"""Proof on the card that the kernel gates catch a faulty kernel.

    python3 gate_mutants.py

Runs the phase-2 checks of ``chip_smoke.py`` untimed, each in its own
process with its own kernel build: first on the port as it is (every
check), then on copies of the port made in a temporary directory outside
the checkout, each with one fault written into one kernel source and held
to that kernel's check:

- ``check_attention`` (``attention_fwd_gate``, every ``ATTENTION_*`` case)
  for the forwards: the one-shot K1 and the streaming K2;
- ``check_attention_bwd`` (``attention_bwd_gate``, every ``BWD_SHAPES`` and
  ``BWD_RAGGED`` case) for the backward: K6 and K7, and K8;
- ``check_ffn_gemm`` (``gemm_gate``, every ``FFN_*`` case) for the
  down-projection GEMM K10.

Each attention kernel gets two faults: its key mask removed (keys at or
past ``kv_valid``, and the zero padding past KV, enter the softmax) and a
scale error on one output (K1's and K2's out × 1.01, dV × 1.03). K10 gets
three: its bias dropped, its last 64-deep K step skipped, and y × 1.01.
Passes (exit 0) when the port passes every case and each copy fails at
least one. Each run's full output goes to ``build/gate_mutants/<n>.log``
(the checkout's git-ignored build directory); the summary, with every case
of the faulted kernel's route, is printed. The patterns name lines of the
sources, so the script refuses to run (SystemExit) once they no longer
match. Needs a CUDA card and nvcc.
"""

import argparse
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (name, the check it must fail, the routes whose cases it prints, file under
# the package, [(text, its replacement, occurrences)])
MUTANTS = [
    ("K2 key mask removed", "fwd", ("flash_fwd_stream",), "csrc/flash_fwd_wgmma.cu",
     [("if (kv0 + nt * 8 + 2 * (lane % 4) + (e & 1) >= kv_len) s[nt][e] = kNegInf;",
       "if (false) s[nt][e] = kNegInf;", 1)]),
    ("K2 out x 1.01", "fwd", ("flash_fwd_stream",), "csrc/flash_fwd_wgmma.cu",
     [("__floats2bfloat162_rn(o[nd][0] / l[0], o[nd][1] / l[0]);",
       "__floats2bfloat162_rn(o[nd][0] * 1.01f / l[0], o[nd][1] * 1.01f / l[0]);", 1),
      ("__floats2bfloat162_rn(o[nd][2] / l[1], o[nd][3] / l[1]);",
       "__floats2bfloat162_rn(o[nd][2] * 1.01f / l[1], o[nd][3] * 1.01f / l[1]);", 1)]),
    ("K10 bias dropped", "gemm", ("gemm",), "csrc/gemm_sm90.cu",
     [("__fadd_rn(acc[nt][2 * half], bf.x), __fadd_rn(acc[nt][2 * half + 1], bf.y)",
       "__fadd_rn(acc[nt][2 * half], 0.0f), __fadd_rn(acc[nt][2 * half + 1], 0.0f)", 1)]),
    ("K10 last K step skipped", "gemm", ("gemm",), "csrc/gemm_sm90.cu",
     [("const int steps = k / kBK;", "const int steps = k / kBK - 1;", 1)]),
    ("K10 y x 1.01", "gemm", ("gemm",), "csrc/gemm_sm90.cu",
     [("__fadd_rn(acc[nt][2 * half], bf.x), __fadd_rn(acc[nt][2 * half + 1], bf.y)",
       "__fadd_rn(acc[nt][2 * half], bf.x) * 1.01f, __fadd_rn(acc[nt][2 * half + 1], bf.y) * 1.01f", 1)]),
    ("K1 key mask removed", "fwd", ("flash_fwd_oneshot",), "csrc/attention.cu",
     [("const float x = c < lim ? s[nt][e] * scale_log2 : kNegInf;",
       "const float x = true ? s[nt][e] * scale_log2 : kNegInf;", 1)]),
    ("K1 out x 1.01", "fwd", ("flash_fwd_oneshot",), "csrc/attention.cu",
     [("inv[r] = 1.0f / l[r];", "inv[r] = 1.01f / l[r];", 1)]),
    ("K6/K7 key mask removed", "bwd", ("flash_bwd_pair",), "csrc/flash_bwd.cu",
     [("key_ok[2] = {r0 < kv_len, r0 + 8 < kv_len};", "key_ok[2] = {true, true};", 1),
      ("key_ok = c + (e & 1) < kv_len;", "key_ok = true;", 1)]),
    ("K6 dV x 1.03", "bwd", ("flash_bwd_pair",), "csrc/flash_bwd.cu",
     [("store_rows(dv + at, acc_v, 1.0f,", "store_rows(dv + at, acc_v, 1.03f,", 1)]),
    ("K8 key mask removed", "bwd", ("flash_bwd_oneshot",), "csrc/flash_bwd_oneshot.cu",
     [("key_ok[2] = {r0 < kv_len, r0 + 8 < kv_len};", "key_ok[2] = {true, true};", 1)]),
    ("K8 dV x 1.03", "bwd", ("flash_bwd_oneshot",), "csrc/flash_bwd_oneshot.cu",
     [("dv[idx] = __float2bfloat16(sv);", "dv[idx] = __float2bfloat16(sv * 1.03f);", 1),
      ("__floats2bfloat162_rn(acc_v[nd][2 * h], acc_v[nd][2 * h + 1]);",
       "__floats2bfloat162_rn(acc_v[nd][2 * h] * 1.03f, acc_v[nd][2 * h + 1] * 1.03f);", 1)]),
]


def child(package_root: str, checks: str) -> None:
    sys.path.insert(0, package_root)  # the copy's port before the checkout's
    import chip_smoke
    from flash_diffusion_tpu_torch.ops import attention, gemm, kernels

    print(f"port: {Path(attention.__file__).parents[2]}")
    kernels.library()
    print(f"kernel build: nvcc {kernels.BUILD_INFO['seconds']:.2f} s -> {kernels.BUILD_INFO['path']}")
    names = ("flash_fwd_oneshot", "flash_fwd_stream", "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_oneshot",
             "gemm", "geglu_gemm")
    results = {name: chip_smoke.new_row("cuda", "", "") for name in names}
    failed = []
    for check in checks.split(","):
        try:
            if check == "fwd":
                chip_smoke.check_attention(attention, results, timed=False)
            elif check == "bwd":
                chip_smoke.check_attention_bwd(attention, kernels, results, timed=False)
            else:
                chip_smoke.check_ffn_gemm(gemm, results, timed=False)
        except AssertionError as e:
            failed.append(str(e))
    print("GATE: every case passed" if not failed else f"GATE: {' / '.join(failed)}")


def mutated_copy(where: Path, path: str, edits) -> Path:
    shutil.copytree(ROOT / "flash_diffusion_tpu_torch", where / "flash_diffusion_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = where / "flash_diffusion_tpu_torch" / path
    text = src.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            raise SystemExit(f"{path}: expected {count} of {old!r}, found {text.count(old)}")
        text = text.replace(old, new)
    src.write_text(text)
    return where


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--checks", default="fwd,bwd,gemm", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.checks)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gate_mutants: needs an NVIDIA GPU")
    out_dir = ROOT / "build" / "gate_mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    verdicts = []
    with tempfile.TemporaryDirectory() as tmp:
        variants = [("as built", ROOT, "fwd,bwd,gemm", ("flash_fwd_oneshot", "flash_fwd_stream", "flash_bwd_oneshot",
                                                         "flash_bwd_pair", "gemm"))] + [
            (name, mutated_copy(Path(tmp) / f"m{i}", path, edits), check, routes)
            for i, (name, check, routes, path, edits) in enumerate(MUTANTS)]
        for i, (name, root, checks, routes) in enumerate(variants):
            run = subprocess.run([sys.executable, __file__, "--child", str(root), "--checks", checks],
                                 capture_output=True, text=True, cwd=ROOT)
            (out_dir / f"{i}.log").write_text(run.stdout + run.stderr)
            lines = run.stdout.splitlines()
            verdict = next((l for l in lines if l.startswith("GATE: ")), None)
            print(f"== {name} (rc {run.returncode}): {verdict}")
            for line in lines:
                words = line.split()
                route = words[1 + (words[1] == "backward")] if line.startswith("attention") else words[0] if words else ""
                if route in routes:
                    print("  " + line)
            if verdict is None:
                print(run.stderr[-3000:])
            verdicts.append(verdict)
    passed = verdicts[0] == "GATE: every case passed" and all(
        v is not None and v != "GATE: every case passed" for v in verdicts[1:])
    print(f"the gates {'pass the kernels and fail every mutant' if passed else 'did NOT separate them'}")
    sys.exit(0 if passed else 1)


if __name__ == "__main__":
    main()
