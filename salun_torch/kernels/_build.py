"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each ``salun_torch/csrc/<name>.cu`` has a plain C interface and is compiled
on first use, on the machine with the card, into
``build/salun_torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout (``build/`` is git-ignored; :func:`_build_dir` says where an
installed package builds). The hash covers the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source, all together.

Nothing here runs at import: importing the package never needs ``nvcc``;
it is called only when a kernel is first launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def _build_dir() -> Path:
    """``$SALUN_TORCH_BUILD_DIR`` if set; else ``build/salun_torch_kernels``
    at the root of the checkout the package lies in; for an installed
    package, a per-user cache directory."""
    if os.environ.get("SALUN_TORCH_BUILD_DIR"):
        return Path(os.environ["SALUN_TORCH_BUILD_DIR"])
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").exists():
        return root / "build" / "salun_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "salun_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources() -> list:
    """Every kernel source of the port, by name."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(out_path, tmp_path, process or None)``."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def build_all(names=None) -> dict:
    """Compile every (or the named) kernel source, one nvcc each, in
    parallel. Returns ``{name: library path}``."""
    names = sources() if names is None else list(names)
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
