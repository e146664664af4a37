"""Build and load the port's native code (compiler → shared library →
ctypes).

Each ``salun_torch/csrc/<name>.cu`` (a CUDA kernel) or ``<name>.cc`` (host
C++: the spack reader) has a plain C interface and is compiled on first
use into ``build/salun_torch_kernels/lib<name>-<hash>.so`` at the root of
the checkout (``build/`` is git-ignored; :func:`_build_dir` says where an
installed package builds): ``.cu`` by ``nvcc`` for sm_90a on the machine
with the card, ``.cc`` by ``g++`` (``$CXX``) with the flags of
``salun/native/Makefile``. The hash covers the source and the flags, so
an edited source is rebuilt and a stale library is never loaded.
:func:`build_all` starts one compiler per source, all together.

Nothing here runs at import: importing the package never needs a
compiler; it is called only when a kernel is first launched on a CUDA
tensor, or the native spack reader is first opened.
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
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

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


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found:
        return found
    raise RuntimeError("no host C++ compiler (g++ or $CXX) found: the "
                       "native spack reader is built with one")


def sources() -> list:
    """Every native source of the port (kernels and host code), by name."""
    return sorted(p.stem for p in CSRC.iterdir() if p.suffix in (".cu",
                                                                 ".cc"))


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS


def library_path(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start the compiler for ``name`` unless its library exists; returns
    ``(out_path, tmp_path, process or None)``."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = _source(name)
    compiler = _nvcc() if src.suffix == ".cu" else _cxx()
    cmd = [compiler, *_flags(src), "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"building {_source(name).name} failed:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def build_all(names=None) -> dict:
    """Compile every (or the named) source, one compiler each, in
    parallel. Returns ``{name: library path}``."""
    names = sources() if names is None else list(names)
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cc``, building it if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
