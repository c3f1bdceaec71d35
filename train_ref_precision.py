#!/usr/bin/env python3
"""A training reference of ``chip_smoke.py`` (Pixart's phase 7d by default,
SD3's 9b with ``--model sd3``, SD1.5's 5b with ``--model sd15``) from given
rollout starts, with its CPU copy also run in bf16, on one NVIDIA GPU.

    python3 train_ref_precision.py [--model pixart|sd3|sd15] [--starts 0 1 ...]

Builds the trainer at 256² on the card and its CPU copy as the phase does,
draws the same staged batch and draws with the rollout from each start
(Pixart: 0 by default, t = 999; 7d itself starts at
``chip_smoke.TRAIN_REF_START``), and prints the losses of three runs on the
same inputs: the card (bf16, the kernels), the CPU copy in bf16 (the plain
paths, no kernel) and the CPU copy in fp32, with each one's relative error
against fp32 and the card's against CPU bf16; then the phase's gated errors
and whether they hold 5b's tolerances. A card that sits as far from fp32 as
CPU bf16 does, and close to CPU bf16, points at bf16 rounding; a card far
from both points at a kernel. SD1.5 also prints the LoRA gradients' error
of each scaled G term alone and of the student's own backward (card bf16
and CPU bf16 against CPU fp32). Prints the card's name and power limit
first.
Exits non-zero without a GPU; a reference outside 5b's tolerances is a
reading, printed, not a failure.

    python3 train_ref_precision.py --model dpt

runs phase 11c's DPT comparison (``chip_smoke.check_dpt``) with the CPU
copy also in bf16: each reading's centered relative L2 of the card, of the
faulted attentions and of CPU bf16 against fp32, and of the card against
CPU bf16 (the bf16 floor that ``DPT_REL_L2_TOL`` sits above).
"""

import argparse

import torch

import chip_smoke


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="pixart", choices=("pixart", "sd3", "sd15", "dpt"))
    ap.add_argument("--starts", type=int, nargs="+", default=[0], help="rollout start indices, one run each")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_ref_precision: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    print(f"card: {chip_smoke.card_line()}")
    if args.model == "dpt":
        try:
            chip_smoke.check_dpt(cpu_bf16=True)
            print(f"DPT: within DPT_REL_L2_TOL {chip_smoke.DPT_REL_L2_TOL}, every fault outside it")
        except AssertionError as e:
            print(f"DPT: the check fails ({e})")
        return
    for start in args.starts:
        try:
            chip_smoke.check_training_reference(args.model, start=start, cpu_bf16=True,
                                                diagnostics=args.model == "sd15")
            print(f"{args.model} training reference from start {start}: within 5b's tolerances")
        except AssertionError as e:
            print(f"{args.model} training reference from start {start}: outside 5b's tolerances ({e})")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
