#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``salun_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the script (exit code 1) when it fails:

1. Device: the card's name and power limit (``nvidia-smi``) and the TF32
   settings. No CUDA device → exit 1 before any result is printed.
2. Build: every kernel under ``salun_torch/csrc`` is compiled from the
   checkout's sources (one ``nvcc`` per source, started together).
3. Kernel vs plain: K1 (fused masked SGD) against its plain PyTorch version
   at N = 11,173,962 (ResNet-18 CIFAR, the main path's shape), 50%-dense
   mask, two learning rates: bitwise equal (``torch.equal``). Times with
   CUDA events, the HBM bound, the plain version's time. Saliency masks
   on the card against the CPU's on a heavily tied input: bitwise.
4. Main path at full width: synthetic CIFAR-shaped data written in the
   CIFAR-10 file format, a seeded ResNet-18, then the port's own entry
   points ``salun_torch.cli.generate_mask`` (masks at 0.1…1.0) and
   ``salun_torch.cli.main_random --unlearn RL`` (lr 0.013, bs 256, one
   epoch) with UA/RA/TA and SVC-MIA. Checks: the 0.5 mask has exactly
   int(N/2) ones; after RL every masked-out weight equals θ₀ bitwise; K1's
   launch count equals the optimizer steps; every metric is finite.
5. A ``{"kernels": [...]}`` line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Scratch files go to ``build/chip_smoke/`` inside the checkout.
"""

from __future__ import annotations

import json
import math
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

N_K1 = 11_173_962          # ResNet-18 (CIFAR stem, 10 classes) parameters
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12         # H100 SXM fp32, outside the tensor cores

# Main-path data: CIFAR-shaped, cut in count from CIFAR-10's 50,000/10,000
N_TRAIN, N_TEST, N_FORGET = 12_000, 2_000, 1_000
BATCH, LR, EPOCHS = 256, 0.013, 1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 3


def k1_vs_plain(device) -> dict:
    import torch

    from salun_torch.kernels.masked_update import (
        masked_sgd_update, masked_sgd_update_reference)

    gen = torch.Generator(device=device).manual_seed(0)
    n = N_K1
    p0 = torch.randn(n, generator=gen, device=device)
    b0 = torch.randn(n, generator=gen, device=device)
    g = torch.randn(n, generator=gen, device=device)
    t0 = torch.randn(n, generator=gen, device=device)
    mask = (torch.rand(n, generator=gen, device=device) < 0.5).to(torch.uint8)
    max_err = 0.0
    for lr_value in (0.013, 0.0013):
        lr = torch.full((1,), lr_value, dtype=torch.float32, device=device)
        p, b = p0.clone(), b0.clone()
        masked_sgd_update(p, b, g, mask, t0, lr)
        want_p, want_b = masked_sgd_update_reference(p0, b0, g, mask, t0, lr)
        torch.cuda.synchronize()
        err = max(float((p - want_p).abs().max()),
                  float((b - want_b).abs().max()))
        max_err = max(max_err, err)
        if not (torch.equal(p, want_p) and torch.equal(b, want_b)):
            fail(f"K1 differs from its plain version at lr={lr_value}: "
                 f"max abs err {err}")
        log(f"K1 vs plain lr={lr_value}: bitwise equal over {n} elements")

    lr = torch.full((1,), 0.013, dtype=torch.float32, device=device)
    p, b = p0.clone(), b0.clone()
    ms = cuda_time_ms(lambda: masked_sgd_update(p, b, g, mask, t0, lr), 200)
    plain_ms = cuda_time_ms(
        lambda: masked_sgd_update_reference(p, b, g, mask, t0, lr), 50)
    # each input read once, each output written once: p, buf, g, θ₀ (fp32),
    # mask (uint8), lr; p and buf written
    n_bytes = n * (4 * 4 + 1) + 4 + n * 2 * 4
    n_ops = 7 * n  # 4 mul, 2 add, 1 sub per element
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS) * 1e3
    bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / FP32_FLOPS
                else "operations")
    log(f"K1: {ms:.5f} ms/launch, plain {plain_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({n_bytes} bytes), {n_bytes / ms / 1e6:.1f} GB/s")
    return {"name": "K1 masked_sgd_update", "route": "cuda",
            "source": "salun_torch/csrc/masked_sgd.cu",
            "replaces": "salun/kernels/masked_update.py:27",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def masks_card_vs_cpu(device) -> None:
    """Top-k masks on the card equal the CPU's bitwise, ties included: the
    stable sort decides ties, and its order must not depend on the device."""
    import torch

    from salun_torch.core.mask import generate_masks

    gen = torch.Generator().manual_seed(1)
    shapes = [(512, 256, 3, 3), (512,), (10, 512), (1_000_003,)]
    # a 16-level grid: masses of exact ties across tensors and thresholds
    sal = [torch.randint(0, 16, s, generator=gen).float() / 16 for s in shapes]
    on_cpu = generate_masks(sal)
    on_card = generate_masks([t.to(device) for t in sal])
    for t, masks in on_cpu.items():
        for a, b in zip(masks, on_card[t]):
            if not torch.equal(a, b.cpu()):
                fail(f"masks differ between the card and the CPU at t={t}")
    n = sum(t.numel() for t in sal)
    log(f"masks on the card equal the CPU's bitwise ({n} values, 16-level "
        f"ties, 10 thresholds)")


# ------------------------------------------------------------------ phase 4


def write_cifar10_files(data_dir: Path) -> None:
    """Synthetic CIFAR-shaped data in CIFAR-10's python-pickle format."""
    from salun_torch.data.datasets import synthetic

    base = data_dir / "cifar-10-batches-py"
    base.mkdir(parents=True, exist_ok=True)
    train = synthetic(n=N_TRAIN, seed=0)
    test = synthetic(n=N_TEST, seed=1)

    def dump(name, ds):
        rows = ds.data.transpose(0, 3, 1, 2).reshape(len(ds), -1)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rows, b"labels": ds.targets.tolist()}, f)

    per = N_TRAIN // 5
    for i in range(5):
        dump(f"data_batch_{i + 1}", train.select(slice(i * per, (i + 1) * per)))
    dump("test_batch", test)


def main_path(device, kernel_ms: float) -> dict:
    import torch

    from salun_torch.ckpt import load_mask, load_state_dict
    from salun_torch.cli import generate_mask, main_random
    from salun_torch.cli.args import parse_args
    from salun_torch.cli.setup import build_unlearn_loaders, setup_model_dataset
    from salun_torch.kernels.masked_update import masked_sgd_update
    from salun_torch.models import create_model

    shutil.rmtree(WORK, ignore_errors=True)
    data_dir, out_dir = WORK / "data", WORK / "out"
    write_cifar10_files(data_dir)
    model_path = WORK / "resnet18_seed0.pt"
    model = create_model("resnet18", 10, seed=0)
    torch.save({"state_dict": model.state_dict()}, model_path)

    common = ["--dataset", "cifar10", "--data", str(data_dir),
              "--arch", "resnet18", "--model_path", str(model_path),
              "--save_dir", str(out_dir), "--batch_size", str(BATCH),
              "--num_indexes_to_replace", str(N_FORGET),
              "--class_to_replace", "-1", "--device", str(device)]
    rl_args = common + ["--unlearn", "RL",
                        "--mask_path", str(out_dir / "with_0.5.pt"),
                        "--unlearn_lr", str(LR),
                        "--unlearn_epochs", str(EPOCHS)]

    masked_sgd_update.launches = 0
    t0 = time.perf_counter()
    masks = generate_mask.main(common)
    t_mask = time.perf_counter() - t0
    results = main_random.main(rl_args)
    launches = {"K1 masked_sgd_update": masked_sgd_update.launches}
    torch.cuda.synchronize()

    # exact-k 0.5 mask, as written to disk
    mask = load_mask(str(out_dir / "with_0.5.pt"))
    n_params = sum(v.numel() for v in mask.values())
    ones = int(sum(int(v.sum()) for v in mask.values()))
    if n_params != N_K1 or ones != int(n_params * 0.5):
        fail(f"0.5 mask has {ones} ones of {n_params}, want "
             f"{int(N_K1 * 0.5)} of {N_K1}")
    if set(masks) != {0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0}:
        fail(f"mask thresholds {sorted(masks)}")
    log(f"mask 0.5: exactly {ones} of {n_params} ones")

    # masked-out weights pinned to θ₀, bitwise; kept weights moved
    theta0 = load_state_dict(str(model_path))
    after = load_state_dict(str(out_dir / "RL_checkpoint.pt"))
    moved = 0
    for name, m in mask.items():
        out_w, in_w = after[name], theta0[name]
        if not torch.equal(out_w[m == 0], in_w[m == 0]):
            fail(f"{name}: a masked-out weight left θ₀")
        moved += int((out_w[m > 0] != in_w[m > 0]).sum())
    if moved == 0:
        fail("RL moved no kept weight")
    log(f"after RL: every masked-out weight equals θ₀ bitwise; "
        f"{moved} kept weights moved")

    # one K1 launch per optimizer step
    args = parse_args(rl_args)
    _, train, val, test, marked = setup_model_dataset(args, "cpu", 0)
    loaders, forget, retain = build_unlearn_loaders(args, train, val, test,
                                                    marked)
    steps = EPOCHS * (len(loaders["forget"]) + len(loaders["retain"]))
    if launches["K1 masked_sgd_update"] != steps:
        fail(f"K1 launched {launches['K1 masked_sgd_update']} times for "
             f"{steps} optimizer steps")
    log(f"K1 launches {launches['K1 masked_sgd_update']} = optimizer steps")

    mia = results["SVC_MIA_forget_efficacy"]
    values = [results[k] for k in ("retain", "forget", "val", "test", "UA")]
    values += [mia[k] for k in ("correctness", "confidence", "entropy",
                                "m_entropy", "prob")]
    if len(mia) != 5 or not all(math.isfinite(v) for v in values):
        fail(f"non-finite metrics: {results}")
    sec = results["seconds"]
    images = EPOCHS * (len(forget) + len(retain))
    k1_ms = kernel_ms * launches["K1 masked_sgd_update"]
    log(f"UA {results['UA']:.2f} RA {results['retain']:.2f} "
        f"TA {results['test']:.2f} MIA {json.dumps(mia)}")
    log(f"main path seconds: mask generation {t_mask:.3f} (whole CLI call), "
        f"RL {sec['unlearn']:.3f} (cold: {steps} steps, the first step's "
        f"set-up included; {images / sec['unlearn']:.1f} img/s, "
        f"{1e3 * sec['unlearn'] / steps:.3f} ms/step, "
        f"K1 {k1_ms:.3f} ms of it at the phase-3 time), "
        f"UA/RA/TA {sec['accuracy']:.3f}, SVC-MIA {sec['mia']:.3f}")
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    try:
        from salun_torch.kernels import _build
        from salun_torch.utils.device import set_tf32, tf32_settings
    except ImportError as e:
        fail(f"the salun_torch package is not beside this script: {e}")

    device = torch.device("cuda", 0)
    card = card_name_and_limit()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    set_tf32(False)  # parity checks run in full fp32
    log(f"TF32 for the K1 check: {tf32_settings()}")
    kernels = [k1_vs_plain(device)]
    masks_card_vs_cpu(device)

    launches = main_path(device, kernels[0]["ms"])  # CLIs: TF32 on
    log(f"TF32 on the main path: {tf32_settings()}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
