#!/usr/bin/env python3
"""Time K3a (flash-attention dq, ``salun_flash_bwd_dq``) on one CUDA card.

By default it times the kernel built from the checkout's
``salun_torch/csrc/flash_attention.cu``; ``--source FILE.cu`` builds and
times another version of that file instead (a variant under study, or the
parent commit's copy), with the port's own nvcc flags, into
``build/flash_variants/``. Run one version per process: libraries that
define kernels of the same names, loaded into one process, all run the
first one's kernel. ``--ptxas`` prints nvcc's ``-Xptxas -v`` report of the
K3a instantiations (registers, shared memory, spills).

At each shape [B, Nq, Nk, D] (by default the DDPM and SD paths' shapes)
it makes seeded inputs, takes lse and δ from the plain forward, checks
the kernel against ``flash_attention_bwd_dq_reference`` (1e-4 ×
max(1, max|plain|)) and times it with CUDA events (``--iters`` launches,
20 by default, after 3 warm-ups), TF32 off, printing beside it the host's
time to issue each launch (the Python wrapper's checks and the launch
call), which bounds the events' time from below at small shapes. With
``--graph`` the launches are captured in a CUDA graph and one replay is
timed, which leaves out the host's cost, so that small shapes show the
device's time. It prints one line per shape and, last, a JSON object with
the card's name and power limit::

    python3 tools/time_flash_bwd_dq.py
    python3 tools/time_flash_bwd_dq.py --source variant.cu --ptxas
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [(128, 256, 256, 256), (256, 256, 256, 256), (128, 16, 16, 256),
          (32, 4096, 4096, 40), (32, 4096, 77, 40), (32, 1024, 1024, 80),
          (32, 1024, 77, 80), (32, 256, 256, 160), (32, 256, 77, 160),
          (32, 64, 64, 160), (32, 64, 77, 160)]


def build(source: Path, ptxas: bool) -> Path:
    """Compile ``source`` with the port's flags; returns the library."""
    from salun_torch.kernels import _build

    data = source.read_bytes()
    out_dir = ROOT / "build" / "flash_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib-{hashlib.sha256(data).hexdigest()[:16]}.so"
    flags = list(_build.NVCC_FLAGS) + (["-Xptxas", "-v"] if ptxas else [])
    run = subprocess.run([_build._nvcc(), *flags, "-o", str(lib),
                          str(source)], capture_output=True, text=True)
    if run.returncode != 0:
        sys.exit(f"nvcc failed for {source}:\n{run.stdout}{run.stderr}")
    if ptxas:
        report = (run.stdout + run.stderr).splitlines()
        for i, line in enumerate(report):
            if "Compiling entry function" in line and "bwd_dq" in line:
                print(line.strip())
                for more in report[i + 1:i + 4]:
                    if "Compiling entry" in more:
                        break
                    print("  " + more.strip())
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", type=Path, default=None)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="B,Nq,Nk,D each; default: the paths' shapes")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from salun_torch.kernels import flash_attention as fa
    from salun_torch.utils.device import set_tf32

    source = args.source or ROOT / "salun_torch/csrc/flash_attention.cu"
    lib = ctypes.CDLL(str(build(source, args.ptxas)))
    fa._library = lambda: lib
    set_tf32(False)
    shapes = ([tuple(int(x) for x in s.split(",")) for s in args.shapes]
              if args.shapes else SHAPES)
    dev = torch.device("cuda")
    rows = []
    for shape in shapes:
        b, nq, nk, d = shape
        gen = torch.Generator(device=dev).manual_seed(sum(shape))
        q, do = (torch.randn(b, nq, d, generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(b, nk, d, generator=gen, device=dev)
                for _ in range(2))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd_reference(q, k, v, scale)
        delta = (do * o).sum(-1)
        bwd = (q, k, v, do, lse, delta, scale)
        want = fa.flash_attention_bwd_dq_reference(*bwd)
        got = fa.flash_attention_bwd_dq(*bwd)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(1.0, float(want.abs().max()))
        for _ in range(3):
            fa.flash_attention_bwd_dq(*bwd)

        def launches():
            for _ in range(args.iters):
                fa.flash_attention_bwd_dq(*bwd)

        run = launches
        if args.graph:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                launches()
            graph.replay()
            run = graph.replay
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        issue = time.perf_counter()
        run()
        host_ms = (time.perf_counter() - issue) * 1e3 / args.iters
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.iters
        tflops = 6 * b * nq * nk * d / ms / 1e9
        ok = rel <= 1e-4
        rows.append({"shape": list(shape), "ms": ms, "tflops": tflops,
                     "rel_err": rel, "ok": ok,
                     "host_ms": None if args.graph else host_ms})
        host = "" if args.graph else f" (host {host_ms:.5f} ms/launch)"
        print(f"K3a {list(shape)}: {ms:.5f} ms"
              f"{' (graph)' if args.graph else host}, {tflops:.2f} TFLOP/s, "
              f"error {rel:.2e} of max(1, max|plain|)"
              f"{'' if ok else ' FAILS 1e-4'}", flush=True)
        del q, k, v, do, o, lse, delta, bwd, want, got
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "source": str(source),
                      "graph": args.graph, "iters": args.iters,
                      "rows": rows}))
    if not all(r["ok"] for r in rows):
        sys.exit(1)


if __name__ == "__main__":
    main()
