#!/usr/bin/env python3
"""Time K4 and K4b (fused GroupNorm + SiLU, ``salun_gn_silu_fwd`` and
``salun_gn_silu_bwd``) on one CUDA card.

By default it times the kernels built from the checkout's
``salun_torch/csrc/groupnorm_silu.cu``; ``--source FILE.cu`` builds and
times another version of that file instead (a variant under study, or an
earlier commit's copy), with the port's own nvcc flags, into
``build/gn_variants/``. A source with the three-launch interface of the
first port (a ``chunk`` argument and a scratch buffer per warp chunk) is
driven through its own argument list, so the parent of the cluster
redesign can be timed beside it. Run one version per process: libraries
that define kernels of the same names, loaded into one process, all run
the first one's kernel. ``--ptxas`` prints nvcc's ``-Xptxas -v`` report
(registers, shared memory, spills) of every K4/K4b kernel.

At each shape [B, C, H, W] (32 groups; by default ``chip_smoke.GN_PATH``)
it makes seeded inputs, checks both kernels against their plain versions
(1e-5 forward, 1e-4 backward, × max(1, max|plain|)) and times them with
CUDA events (``--iters`` launches, 20 by default, after 3 warm-ups), TF32
off, printing beside each the host's time to issue a launch and the
achieved GB/s on the bytes bound (8 B per value forward, 12 backward).
With ``--graph`` the launches are captured in a CUDA graph and one replay
is timed, which leaves out the host's cost. ``--sd-step`` also times both
kernels at every GroupNormSiLU site of the SD random_label step
(``chip_smoke.sd_gn_sites``: seeded full-width U-Net and VAE) and prints
their sum over one step. ``--slice-target``, ``--max-cluster``,
``--stream-smem`` and ``--units-per-warp`` set the plan's constants of
those names (the new interface only).
It prints one line per shape and, last, a JSON object with the card's
name and power limit::

    python3 tools/time_groupnorm_silu.py --ptxas --sd-step
    python3 tools/time_groupnorm_silu.py --source old.cu --graph
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build(source: Path, ptxas: bool) -> Path:
    """Compile ``source`` with the port's flags; returns the library."""
    from salun_torch.kernels import _build

    data = source.read_bytes()
    out_dir = ROOT / "build" / "gn_variants"
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
            if "Compiling entry function" in line and "gn_" in line:
                print(line.strip())
                for more in report[i + 1:i + 4]:
                    if "Compiling entry" in more:
                        break
                    print("  " + more.strip())
    return lib


def use_chunked(gn, lib) -> None:
    """Point the wrappers at a library of the first port's interface:
    three launches each way, a scratch of 3 (forward) or 2 (backward)
    floats per warp chunk of ≤ 4096 values of a plane."""
    import torch

    chunk_max = 4096
    fwd, bwd = lib.salun_gn_silu_fwd, lib.salun_gn_silu_bwd
    ll, i32 = ctypes.c_longlong, ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ll, i32, ll, i32, ll,
                                            ctypes.c_float, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ll, i32, ll, i32, ll,
                                             ctypes.c_void_p]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def groupnorm_silu(x, w, b, groups=32, eps=1e-6):
        bs, c, s = gn._check(x, w, b, groups)
        chunk = min(s, chunk_max)
        units = bs * c * -(-s // chunk)
        y = torch.empty_like(x)
        mean = torch.empty((bs, groups), dtype=torch.float32,
                           device=x.device)
        rstd = torch.empty_like(mean)
        part = torch.empty(3 * units, dtype=torch.float32, device=x.device)
        if fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
               mean.data_ptr(), rstd.data_ptr(), part.data_ptr(), bs, c, s,
               groups, chunk, float(eps), stream()):
            raise RuntimeError("K4 launch failed")
        return y, mean, rstd

    def groupnorm_silu_backward(dy, x, w, b, mean, rstd, groups=32):
        bs, c, s = gn._check(x, w, b, groups, dy=dy, mean=mean, rstd=rstd)
        chunk = min(s, chunk_max)
        units = bs * c * -(-s // chunk)
        dx = torch.empty_like(x)
        dw, db = torch.empty_like(w), torch.empty_like(b)
        part = torch.empty(2 * units, dtype=torch.float32, device=x.device)
        m12 = torch.empty(2 * bs * groups, dtype=torch.float32,
                          device=x.device)
        if bwd(dy.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
               mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
               dw.data_ptr(), db.data_ptr(), part.data_ptr(), m12.data_ptr(),
               bs, c, s, groups, chunk, stream()):
            raise RuntimeError("K4b launch failed")
        return dx, dw, db

    gn.groupnorm_silu = groupnorm_silu
    gn.groupnorm_silu_backward = groupnorm_silu_backward


def time_ms(fn, iters: int, graph: bool):
    """(device ms a launch, host ms a launch or None under ``graph``)."""
    import torch

    for _ in range(3):
        fn()

    def launches():
        for _ in range(iters):
            fn()

    run = launches
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            launches()
        g.replay()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    issue = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - issue) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, None if graph else host_ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", type=Path, default=None)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--sd-step", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--slice-target", type=int, default=None)
    ap.add_argument("--max-cluster", type=int, default=None)
    ap.add_argument("--stream-smem", type=int, default=None)
    ap.add_argument("--units-per-warp", type=int, default=None)
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="B,C,H,W,eps each; default: chip_smoke.GN_PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke
    from salun_torch.kernels import groupnorm_silu as gn
    from salun_torch.utils.device import set_tf32

    source = args.source or ROOT / "salun_torch/csrc/groupnorm_silu.cu"
    lib = ctypes.CDLL(str(build(source, args.ptxas)))
    if "long long chunk" in source.read_text():
        use_chunked(gn, lib)
    else:
        gn._library = lambda: lib
        gn._fns.clear()
        if args.slice_target:
            gn.SLICE_TARGET = args.slice_target
        if args.max_cluster:
            gn.MAX_CLUSTER = args.max_cluster
        if args.stream_smem:
            gn.STREAM_SMEM = args.stream_smem
        if args.units_per_warp:
            gn.UNITS_PER_WARP = args.units_per_warp
        gn._plan.cache_clear()
    set_tf32(False)
    if args.shapes:
        shapes = [(tuple(int(v) for v in s.split(",")[:4]),
                   float(s.split(",")[4])) for s in args.shapes]
    else:
        shapes = [(shape, eps) for shape, _, eps in chip_smoke.GN_PATH]
    dev = torch.device("cuda")
    rows, ok = [], True
    times = {}
    for shape, eps in shapes:
        c = shape[1]
        gen = torch.Generator(device=dev).manual_seed(sum(shape))
        x = 2.0 * torch.randn(shape, generator=gen, device=dev) + 0.5
        dy = torch.randn(shape, generator=gen, device=dev)
        w = 1.0 + 0.3 * torch.randn(c, generator=gen, device=dev)
        b = 0.3 * torch.randn(c, generator=gen, device=dev)
        y, mean, rstd = gn.groupnorm_silu(x, w, b, 32, eps)
        want = gn.groupnorm_silu_reference(x, w, b, 32, eps)
        got_b = gn.groupnorm_silu_backward(dy, x, w, b, mean, rstd, 32)
        want_b = gn.groupnorm_silu_backward_reference(dy, x, w, b, want[1],
                                                      want[2], 32)
        torch.cuda.synchronize()
        n = math.prod(shape)
        for name, got, ref, tol, per, fn in (
                ("K4", (y, mean, rstd), want, 1e-5, 8,
                 lambda: gn.groupnorm_silu(x, w, b, 32, eps)),
                ("K4b", got_b, want_b, 1e-4, 12,
                 lambda: gn.groupnorm_silu_backward(dy, x, w, b, mean, rstd,
                                                    32))):
            rel = max(float((g - r).abs().max())
                      / max(1.0, float(r.abs().max()))
                      for g, r in zip(got, ref))
            ms, host_ms = time_ms(fn, args.iters, args.graph)
            times[(name, shape, eps)] = ms
            good = rel <= tol
            ok = ok and good
            rows.append({"name": name, "shape": list(shape), "ms": ms,
                         "gb_s": per * n / ms / 1e6, "rel_err": rel,
                         "ok": good, "host_ms": host_ms})
            host = ("" if args.graph
                    else f" (host {host_ms:.5f} ms/launch)")
            plan = ""
            if hasattr(lib, "salun_gn_silu_clusters"):
                p = gn._plan(shape[0], c, n // (shape[0] * c), 32,
                             name == "K4b")
                held = lib.salun_gn_silu_clusters(
                    p.cluster, p.smem, name == "K4b", p.path != "scalar")
                plan = (f"; {p.path}, cluster {p.cluster}, {p.smem} B, "
                        f"{held} clusters resident at once")
            print(f"{name} {list(shape)}: {ms:.5f} ms"
                  f"{' (graph)' if args.graph else host}, "
                  f"{per * n / ms / 1e6:.1f} GB/s, error {rel:.2e} of "
                  f"max(1, max|plain|){'' if good else ' FAILS'}{plan}",
                  flush=True)
        del x, dy, y, mean, rstd, want, got_b, want_b
    step = None
    if args.sd_step:
        from salun_torch.sd.config import load_sd_config

        sites = chip_smoke.sd_gn_sites(load_sd_config(
            str(chip_smoke.SD_CONFIG)), dev)
        for shape, eps in sorted({s for v in sites.values() for s in v}):
            c = shape[1]
            gen = torch.Generator(device=dev).manual_seed(7)
            x = torch.randn(shape, generator=gen, device=dev)
            dy = torch.randn(shape, generator=gen, device=dev)
            w, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            _, mean, rstd = gn.groupnorm_silu(x, w, b, 32, eps)
            times[("K4", shape, eps)] = time_ms(
                lambda: gn.groupnorm_silu(x, w, b, 32, eps), args.iters,
                args.graph)[0]
            times[("K4b", shape, eps)] = time_ms(
                lambda: gn.groupnorm_silu_backward(dy, x, w, b, mean, rstd,
                                                   32), args.iters,
                args.graph)[0]
        k4, k4b, _ = chip_smoke.sd_gn_ms(sites, times, 0)
        step = {"k4_ms": k4, "k4b_ms": k4b}
        print(f"SD random_label step at its {len(times)} (kernel, shape) "
              f"pairs: K4 {k4:.3f} ms + K4b {k4b:.3f} ms = "
              f"{k4 + k4b:.3f} ms{' (graph)' if args.graph else ''}",
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "source": str(source),
                      "graph": args.graph, "iters": args.iters,
                      "rows": rows, "sd_step": step}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
