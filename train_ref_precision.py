#!/usr/bin/env python3
"""Pixart's training reference (``chip_smoke.py`` phase 7d) from rollout
start 0, with its CPU copy also run in bf16, on one NVIDIA GPU.

    python3 train_ref_precision.py

Builds the trainer at 256² on the card and its CPU copy as phase 7d does,
draws the same staged batch and draws with the rollout from start 0 (t =
999; 7d itself starts at ``chip_smoke.TRAIN_REF_START``), and prints the
losses of three runs on the same inputs: the card (bf16, the kernels), the
CPU copy in bf16 (the plain paths, no kernel) and the CPU copy in fp32,
with each one's relative error against fp32 and the card's against CPU
bf16; then 7d's gated errors and whether they hold 5b's tolerances. A
card that sits as far from fp32 as CPU bf16 does, and close to CPU bf16,
points at bf16 rounding; a card far from both points at a kernel. Prints
the card's name and power limit first. Exits non-zero without a GPU; a
reference outside 5b's tolerances is a reading, printed, not a failure.
"""

import torch

import chip_smoke


def main():
    if not torch.cuda.is_available():
        raise SystemExit("train_ref_precision: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    print(f"card: {chip_smoke.card_line()}")
    try:
        chip_smoke.check_training_reference("pixart", start=0, cpu_bf16=True)
        print("pixart training reference from start 0: within 5b's tolerances")
    except AssertionError as e:
        print(f"pixart training reference from start 0: outside 5b's tolerances ({e})")


if __name__ == "__main__":
    main()
