#!/usr/bin/env python3
"""Proof on the card that the kernel gates catch a faulty kernel.

    python3 gate_mutants.py [--checks norm,...]

Runs the phase-2 checks of ``chip_smoke.py`` untimed, each in its own
process with its own kernel build: first on the port as it is (every
check), then on copies of the port made in a temporary directory outside
the checkout, each with one fault written into one kernel source and held
to that kernel's check:

- ``check_attention`` (``attention_fwd_gate``, every ``ATTENTION_*`` case)
  for the forwards: the one-shot K1 and the streaming K2;
- ``check_packed`` (``attention_fwd_gate`` without its lse term, every
  ``PACKED_*`` case) for the packed forwards: the one-shot K4 and the
  streaming K5;
- ``check_attention_bwd`` (``attention_bwd_gate``, every ``BWD_SHAPES`` and
  ``BWD_RAGGED`` case) for the backward: K6 and K7, and K8;
- ``check_ffn_gemm`` (``gemm_gate``, every ``FFN_*`` case) for the
  down-projection GEMMs K10 and K12 (one source, ``gemm_sm90.cu``);
- ``check_int8_gemm`` (int32 sums equal, bf16 within one ulp, every
  ``INT8_SHAPES`` and ``INT8_EXTRA`` case) for the int8 GEMM K11;
- ``check_layer_norm`` (``layer_norm_gate``, every ``LAYER_NORM_*`` case)
  and ``check_group_norm`` (``group_norm_gate`` and the exact checks, every
  ``GN_SHAPES`` and ``GN_RAGGED`` case in both layouts) for the norms: K3,
  and the GroupNorm (K9's statistics, the fold, the apply).

Each attention kernel gets two faults: its key mask removed (keys at or
past ``kv_valid``, and the zero padding past KV, enter the softmax) and a
scale error on one output (the forwards' out × 1.01, dV × 1.03). K10 gets
three: its bias dropped, its last 64-deep K step skipped, and y × 1.01.
K12 gets four, each in K12's instantiation only: the gelu replaced by the
identity (h = a·g), the halves swapped (h = g·gelu(a)), its last K step
skipped, and y × 1.01. K11 gets four: its last 128-byte K step skipped,
``sw`` dropped from the epilogue, the gelu dropped (the bias + gelu
cases), and one block's partial sums dropped from the split of K. Passes
(exit 0) when the port passes every case, each copy fails at least one,
each forward's out × 1.01 and K12's y × 1.01 fail every case of their
kernel, and K11's dropped partial every M = 308 case (the split ones).
Each run's full output goes to ``build/gate_mutants/<n>.log``
(the checkout's git-ignored build directory); the summary, with every case
of the faulted kernel's route, is printed. The patterns name lines of the
sources, so the script refuses to run (SystemExit) once they no longer
match. ``--checks`` runs only the named checks (of ``fwd``, ``packed``,
``bwd``, ``gemm``, ``int8``, ``norm``) and their faults. Needs a CUDA card
and nvcc.
"""

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKS = ("fwd", "packed", "bwd", "gemm", "int8", "norm")
ROUTES = ("flash_fwd_oneshot", "flash_fwd_stream", "flash_fwd_oneshot_packed", "flash_fwd_packed", "flash_bwd_oneshot",
          "flash_bwd_pair", "gemm", "geglu_gemm", "int8_gemm", "layer_norm", "group_norm")


def head_dim(line: str) -> int:
    """The head dim of an attention check's printed case line (0 for others)."""
    found = re.search(r" d=\s*(\d+)", line)
    return int(found.group(1)) if found else 0


# which of a mutant's printed cases it must fail all of: the attention cases
# that run the faulted source (up to a head dim), every case, or K11's
# split cases (M = 308)
up_to_d = lambda d: lambda line: head_dim(line) <= d
EVERY = lambda line: True
SPLIT_M = lambda line: re.search(r"M=\s*308 ", line) is not None

# (name, the check it must fail, the routes whose cases it prints, file under
# the package, [(text, its replacement, occurrences)], None where failing one
# case is enough, else which of the routes' cases it must all fail)
MUTANTS = [
    ("K2 key mask removed", "fwd", ("flash_fwd_stream",), "csrc/flash_fwd_wgmma.cu",
     [("if (kv0 + nt * 8 + 2 * (lane % 4) + (e & 1) >= kv_len) s[nt][e] = kNegInf;",
       "if (false) s[nt][e] = kNegInf;", 1)], None),
    ("K2 out x 1.01", "fwd", ("flash_fwd_stream",), "csrc/flash_fwd_wgmma.cu",
     [("__floats2bfloat162_rn(o[nd][0] / l[0], o[nd][1] / l[0]);",
       "__floats2bfloat162_rn(o[nd][0] * 1.01f / l[0], o[nd][1] * 1.01f / l[0]);", 1),
      ("__floats2bfloat162_rn(o[nd][2] / l[1], o[nd][3] / l[1]);",
       "__floats2bfloat162_rn(o[nd][2] * 1.01f / l[1], o[nd][3] * 1.01f / l[1]);", 1)], up_to_d(128)),
    ("K10 bias dropped", "gemm", ("gemm",), "csrc/gemm_sm90.cu",
     [("__fadd_rn(acc[nt][2 * half], bf.x), __fadd_rn(acc[nt][2 * half + 1], bf.y)",
       "__fadd_rn(acc[nt][2 * half], 0.0f), __fadd_rn(acc[nt][2 * half + 1], 0.0f)", 1)], None),
    ("K10 last K step skipped", "gemm", ("gemm",), "csrc/gemm_sm90.cu",
     [("const int steps = k / kBK;", "const int steps = k / kBK - 1;", 1)], None),
    ("K10 y x 1.01", "gemm", ("gemm",), "csrc/gemm_sm90.cu",
     [("__fadd_rn(acc[nt][2 * half], bf.x), __fadd_rn(acc[nt][2 * half + 1], bf.y)",
       "__fadd_rn(acc[nt][2 * half], bf.x) * 1.01f, __fadd_rn(acc[nt][2 * half + 1], bf.y) * 1.01f", 1)], None),
    ("K1 key mask removed", "fwd", ("flash_fwd_oneshot",), "csrc/attention.cu",
     [("const float x = c < lim ? s[nt][e] * scale_log2 : kNegInf;",
       "const float x = true ? s[nt][e] * scale_log2 : kNegInf;", 1)], None),
    ("K1 out x 1.01", "fwd", ("flash_fwd_oneshot",), "csrc/attention.cu",
     [("inv[r] = 1.0f / l[r];", "inv[r] = 1.01f / l[r];", 1)], up_to_d(160)),
    ("K6/K7 key mask removed", "bwd", ("flash_bwd_pair",), "csrc/flash_bwd.cu",
     [("key_ok[2] = {r0 < kv_len, r0 + 8 < kv_len};", "key_ok[2] = {true, true};", 1),
      ("key_ok = c + (e & 1) < kv_len;", "key_ok = true;", 1)], None),
    ("K6 dV x 1.03", "bwd", ("flash_bwd_pair",), "csrc/flash_bwd.cu",
     [("store_rows(dv + at, acc_v, 1.0f,", "store_rows(dv + at, acc_v, 1.03f,", 1)], None),
    ("K8 key mask removed", "bwd", ("flash_bwd_oneshot",), "csrc/flash_bwd_oneshot.cu",
     [("key_ok[2] = {r0 < kv_len, r0 + 8 < kv_len};", "key_ok[2] = {true, true};", 1)], None),
    ("K8 dV x 1.03", "bwd", ("flash_bwd_oneshot",), "csrc/flash_bwd_oneshot.cu",
     [("dv[idx] = __float2bfloat16(sv);", "dv[idx] = __float2bfloat16(sv * 1.03f);", 1),
      ("__floats2bfloat162_rn(acc_v[nd][2 * h], acc_v[nd][2 * h + 1]);",
       "__floats2bfloat162_rn(acc_v[nd][2 * h] * 1.03f, acc_v[nd][2 * h + 1] * 1.03f);", 1)], None),
    # K4 and K5 are K1's and K2's kernels on the packed layout: the same
    # faults in the same sources, held to the packed kernels' check
    ("K4 key mask removed", "packed", ("flash_fwd_oneshot_packed",), "csrc/attention.cu",
     [("const float x = c < lim ? s[nt][e] * scale_log2 : kNegInf;",
       "const float x = true ? s[nt][e] * scale_log2 : kNegInf;", 1)], None),
    ("K4 out x 1.01", "packed", ("flash_fwd_oneshot_packed",), "csrc/attention.cu",
     [("inv[r] = 1.0f / l[r];", "inv[r] = 1.01f / l[r];", 1)], up_to_d(128)),
    ("K5 key mask removed", "packed", ("flash_fwd_packed",), "csrc/flash_fwd_wgmma.cu",
     [("if (kv0 + nt * 8 + 2 * (lane % 4) + (e & 1) >= kv_len) s[nt][e] = kNegInf;",
       "if (false) s[nt][e] = kNegInf;", 1)], None),
    ("K5 out x 1.01", "packed", ("flash_fwd_packed",), "csrc/flash_fwd_wgmma.cu",
     [("__floats2bfloat162_rn(o[nd][0] / l[0], o[nd][1] / l[0]);",
       "__floats2bfloat162_rn(o[nd][0] * 1.01f / l[0], o[nd][1] * 1.01f / l[0]);", 1),
      ("__floats2bfloat162_rn(o[nd][2] / l[1], o[nd][3] / l[1]);",
       "__floats2bfloat162_rn(o[nd][2] * 1.01f / l[1], o[nd][3] * 1.01f / l[1]);", 1)], up_to_d(128)),
    # K12 is K10's kernel instantiated with kGeglu = true: its faults are
    # edits that only that instantiation compiles in
    ("K12 gelu replaced by the identity", "gemm", ("geglu_gemm",), "csrc/gemm_sm90.cu",
     [("__fmul_rn(af.x, gelu_tanh(gf.x)), __fmul_rn(af.y, gelu_tanh(gf.y))",
       "__fmul_rn(af.x, gf.x), __fmul_rn(af.y, gf.y)", 1)], None),
    ("K12 halves swapped", "gemm", ("geglu_gemm",), "csrc/gemm_sm90.cu",
     [("tma_2d(slot, map, ks * kBK, row, bar);", "tma_2d(slot, map, k + ks * kBK, row, bar);", 1),
      ("tma_2d(slot + kSliceBytes, map, k + ks * kBK, row, bar);",
       "tma_2d(slot + kSliceBytes, map, ks * kBK, row, bar);", 1)], None),
    ("K12 last K step skipped", "gemm", ("geglu_gemm",), "csrc/gemm_sm90.cu",
     [("const int steps = k / kBK;", "const int steps = k / kBK - (kGeglu ? 1 : 0);", 1)], None),
    ("K12 y x 1.01", "gemm", ("geglu_gemm",), "csrc/gemm_sm90.cu",
     [("__fadd_rn(acc[nt][2 * half], bf.x), __fadd_rn(acc[nt][2 * half + 1], bf.y)",
       "__fadd_rn(acc[nt][2 * half], bf.x) * (kGeglu ? 1.01f : 1.0f), "
       "__fadd_rn(acc[nt][2 * half + 1], bf.y) * (kGeglu ? 1.01f : 1.0f)", 1)], EVERY),
    ("K11 last K step skipped", "int8", ("int8_gemm",), "csrc/int8_gemm.cu",
     [("const int steps = (k + kBK - 1) / kBK;", "const int steps = (k + kBK - 1) / kBK - 1;", 1)], None),
    ("K11 sw dropped", "int8", ("int8_gemm",), "csrc/int8_gemm.cu",
     [("__fmul_rn(__fmul_rn(static_cast<float>(acc), xs), ws)", "__fmul_rn(static_cast<float>(acc), xs)", 1)],
     None),
    ("K11 gelu dropped", "int8", ("int8_gemm",), "csrc/int8_gemm.cu",
     [("return gelu ? gelu_tanh(v) : v;", "return v;", 1)], None),
    ("K11 one K partial dropped", "int8", ("int8_gemm",), "csrc/int8_gemm.cu",
     [("for (int p = 0; p < split; ++p) {", "for (int p = 1; p < split; ++p) {", 1)], SPLIT_M),
    ("K3 bias dropped", "norm", ("layer_norm",), "csrc/layer_norm.cu",
     [("if (b != nullptr) u += bv[j].get(e);", "if (false) u += bv[j].get(e);", 1)], None),
    ("K3 last pack of a row skipped", "norm", ("layer_norm",), "csrc/layer_norm.cu",
     [("for (int j = 0; j < PPT; ++j) ok[j] = j * tpr + lane < packs;",
       "for (int j = 0; j < PPT; ++j) ok[j] = j * tpr + lane < packs - 1;", 1)], None),
    ("K3 eps dropped", "norm", ("layer_norm",), "csrc/layer_norm.cu",
     [("return rsqrtf(var + eps);", "return rsqrtf(var);", 1)], None),
    ("K3 y x 1.01", "norm", ("layer_norm",), "csrc/layer_norm.cu",
     [("v[j].set(e, u);", "v[j].set(e, u * 1.01f);", 1)], EVERY),
    # the GroupNorm: one part of N (a part of the NHWC statistics, a warp's
    # chunk of an NCHW row, a block's rows of the resident NHWC cluster)
    # left out of the sums
    ("GroupNorm one part of N dropped", "norm", ("group_norm",), "csrc/group_norm.cu",
     [("        if (p0 + k * kQuarters < a.parts) {", "        if (p0 + k * kQuarters < a.parts - 1) {", 1),
      ("    for (int r = 0; r < a.cluster; ++r) {", "    for (int r = 1; r < a.cluster; ++r) {", 1),
      ("    for (int w = 0; w < kWarps; ++w) {", "    for (int w = 1; w < kWarps; ++w) {", 1)], None),
    ("GroupNorm group boundary shifted by one channel", "norm", ("group_norm",), "csrc/group_norm.cu",
     [("const int ch = first + j;", "const int ch = first + j + 1;", 1)], None),
    ("GroupNorm SiLU dropped", "norm", ("group_norm",), "csrc/group_norm.cu",
     [("if constexpr (SILU) u = __fdiv_rn(u, 1.0f + expf(-u));", "", 1)], None),
    ("GroupNorm y x 1.01", "norm", ("group_norm",), "csrc/group_norm.cu",
     [("return from_f<T>(u);", "return from_f<T>(u * 1.01f);", 1)], EVERY),
]


def child(package_root: str, checks: str) -> None:
    sys.path.insert(0, package_root)  # the copy's port before the checkout's
    import chip_smoke as cs
    from flash_diffusion_tpu_torch.ops import attention, gemm, kernels, norms

    print(f"port: {Path(attention.__file__).parents[2]}")
    kernels.library()
    print(f"card: {cs.card_line()}")
    print(f"kernel build: nvcc {kernels.BUILD_INFO['seconds']:.2f} s -> {kernels.BUILD_INFO['path']}")
    names = ("flash_fwd_oneshot", "flash_fwd_stream", "flash_fwd_oneshot_packed", "flash_fwd_packed", "flash_bwd_dkv",
             "flash_bwd_dq", "flash_bwd_oneshot", "gemm", "geglu_gemm", "int8_gemm", "layer_norm", "group_norm_stats",
             "group_norm_apply", "group_norm_fused")
    results = {name: cs.new_row("cuda", "", "") for name in names}
    runs = {
        "fwd": [lambda: cs.check_attention(attention, results, timed=False)],
        "packed": [lambda: cs.check_packed(attention, results, "flash_fwd_oneshot_packed", cs.PACKED_SHAPES,
                                           cs.PACKED_RAGGED, 2, timed=False),
                   lambda: cs.check_packed(attention, results, "flash_fwd_packed", cs.PACKED_STREAM_SHAPES,
                                           cs.PACKED_STREAM_RAGGED, 10, timed=False)],
        "bwd": [lambda: cs.check_attention_bwd(attention, kernels, results, timed=False)],
        "gemm": [lambda: cs.check_ffn_gemm(gemm, results, timed=False)],
        "int8": [lambda: cs.check_int8_gemm(gemm, results, timed=False)],
        "norm": [lambda: cs.check_layer_norm(norms, results, timed=False),
                 lambda: cs.check_group_norm(norms, results, timed=False)],
    }
    failed = []
    for check in checks.split(","):
        for run in runs[check]:
            try:
                run()
            except AssertionError as e:
                failed.append(str(e))
    print("GATE: every case passed" if not failed else f"GATE: {' / '.join(failed)}")


def case_route(line: str) -> str:
    """The route of a check's printed case line ("" for other lines)."""
    words = line.split()
    if line.startswith("attention") and len(words) > 2:
        return words[1 + (words[1] == "backward")]
    return words[0] if words else ""


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
    ap.add_argument("--checks", default=",".join(CHECKS), help="the checks to run, and their faults only")
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.checks)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gate_mutants: needs an NVIDIA GPU")
    out_dir = ROOT / "build" / "gate_mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        asked = args.checks.split(",")
        variants = [("as built", ROOT, args.checks, ROUTES, None)] + [
            (name, mutated_copy(Path(tmp) / f"m{i}", path, edits), check, routes, must_fail)
            for i, (name, check, routes, path, edits, must_fail) in enumerate(MUTANTS) if check in asked]
        for i, (name, root, checks, routes, must_fail) in enumerate(variants):
            run = subprocess.run([sys.executable, __file__, "--child", str(root), "--checks", checks],
                                 capture_output=True, text=True, cwd=ROOT)
            (out_dir / f"{i}.log").write_text(run.stdout + run.stderr)
            lines = run.stdout.splitlines()
            verdict = next((l for l in lines if l.startswith("GATE: ")), None)
            cases = [l for l in lines if case_route(l) in routes]
            failed = [" FAIL" in l for l in cases]
            must = [f for l, f in zip(cases, failed) if must_fail and must_fail(l)]  # the cases to fail all of
            print(f"== {name} (rc {run.returncode}): failed {sum(failed)} of {len(cases)} cases"
                  + (f", {sum(must)} of the {len(must)} it must fail" if must_fail else "") + f"; {verdict}")
            for line in cases:
                print("  " + line)
            if verdict is None:
                print(run.stderr[-3000:])
            if i == 0:
                ok &= verdict == "GATE: every case passed"
            else:
                ok &= verdict is not None and verdict != "GATE: every case passed" and any(failed)
                ok &= all(must) and (not must_fail or len(must) > 0)
    print(f"the gates {'pass the kernels and fail every mutant' if ok else 'did NOT separate them'}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
