"""Baseline unlearning CLI: the methods without the saliency mask
(counterpart of ``salun/cli/main_forget.py``; reference
Classification/main_forget.py:15-183). It is ``main_random`` with the
method dispatched mask-free (main_forget.py:135), so every step is plain
SGD and kernel K1 is never launched. It runs every one of the 17 names.

Usage: python -m salun_torch.cli.main_forget --unlearn FT \
           --model_path model.pt --unlearn_lr 0.01 --unlearn_epochs 10 \
           [--device cpu]
"""

from __future__ import annotations

from salun_torch.cli.main_random import run


def main(argv=None):
    return run(argv, use_mask=False)


if __name__ == "__main__":
    main()
