"""The FID reference set as an image folder (counterpart of
``salun/cli/ddpm_save_base.py``; reference DDPM/save_base_dataset.py:34-115):
``--per_class`` training images of every class but the forgotten one,
written as ``save_dir/<label>/<i>.png`` with i counting over the whole
set.

Usage:
  python -m salun_torch.cli.ddpm_save_base --dataset cifar10 --data data/ \
      --label_to_forget 0 --save_dir results/cifar10/base
"""

from __future__ import annotations

import argparse
import os

from salun_torch.cli.ddpm_sample import write_png
from salun_torch.data import ddpm_data


def main(argv=None):
    p = argparse.ArgumentParser(description="SalUn DDPM FID reference set")
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--data", default="./data")
    p.add_argument("--label_to_forget", type=int, default=0)
    p.add_argument("--per_class", type=int, default=500)
    p.add_argument("--save_dir", default="results/base")
    args = p.parse_args(argv)

    ds = ddpm_data.get_dataset(args.dataset, args.data, train=True)
    base = ddpm_data.save_base_dataset(ds, args.label_to_forget,
                                       args.per_class)
    os.makedirs(args.save_dir, exist_ok=True)
    for i, (img, lab) in enumerate(zip(base.data, base.targets)):
        d = os.path.join(args.save_dir, str(int(lab)))
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{i}.png"), img)
    print(f"saved {len(base)} reference images → {args.save_dir}")
    return len(base)


if __name__ == "__main__":
    main()
