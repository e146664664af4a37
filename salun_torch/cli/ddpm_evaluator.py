"""DDPM generative-quality evaluator: counterpart of
``salun/cli/ddpm_evaluator.py`` (DDPM/evaluator.py:39-101).

IS, FID, sFID, precision and recall between a reference image folder and
a sample folder, appended as a row to ``--output_csv``. Features come from
the port's InceptionV3 on the card (fp32, TF32 off); with
``--inception_weights`` (a local pytorch-fid ``pt_inception-2015-12-05``
file) they are the reference's, without it the network is seeded and the
numbers are a pipeline check only. The statistics are
``salun_torch.evalx.fid``'s.

Usage:
  python -m salun_torch.cli.ddpm_evaluator ref_dir sample_dir \
      --inception_weights pt_inception-2015-12-05.pth [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np

from salun_torch.evalx.fid import evaluate_all
from salun_torch.evalx.inception import build_inception, make_feature_fn
from salun_torch.utils.device import resolve_device, set_tf32


def read_images_folder(path: str, image_size=None) -> np.ndarray:
    """Every PNG/JPEG under ``path`` (sorted walk) → float32 [0, 1] NHWC
    (evaluator.py:719-740)."""
    from PIL import Image

    files = sorted(
        os.path.join(dp, f)
        for dp, _, fs in os.walk(path)
        for f in fs
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    imgs = []
    for f in files:
        with Image.open(f) as im:
            img = im.convert("RGB")
        if image_size:
            img = img.resize((image_size, image_size))
        imgs.append(np.asarray(img, np.uint8))
    return np.stack(imgs).astype(np.float32) / 255.0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("ref_batch")
    p.add_argument("sample_batch")
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--output_csv", type=str,
                   default="results/cifar10/forget/result.csv")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for "
                        "tests)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    set_tf32(False)
    if not args.inception_weights:
        print("WARNING: no --inception_weights; using random-init features "
              "(pipeline check only — NOT comparable to reference numbers)")
    model = build_inception(args.inception_weights, device)
    extract = make_feature_fn(model, args.batch_size)
    ref = read_images_folder(args.ref_batch)
    gen = read_images_folder(args.sample_batch)
    t0 = time.perf_counter()
    r_pool, r_spatial, _ = extract(ref)
    g_pool, g_spatial, g_softmax = extract(gen)
    seconds = time.perf_counter() - t0
    print(f"features of {len(ref) + len(gen)} images in {seconds:.3f} s")

    results = evaluate_all(r_pool, g_pool, r_spatial, g_spatial, g_softmax)
    print(results)

    os.makedirs(os.path.dirname(args.output_csv) or ".", exist_ok=True)
    write_header = not os.path.exists(args.output_csv)
    with open(args.output_csv, "a", newline="") as f:
        w = csv.writer(f)
        if write_header:
            w.writerow(["ref", "sample"] + list(results))
        w.writerow([args.ref_batch, args.sample_batch] +
                   [f"{v:.4f}" for v in results.values()])
    return results


if __name__ == "__main__":
    main()
