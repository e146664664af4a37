"""spack — the packed-dataset format with a native reader (counterpart of
``salun/data/pack.py``; reference LMDB pipeline,
Classification/lmdb_dataset.py:22-128: ImageFolderLMDB reader + folder2lmdb
packer).

One file holds the records back to back and an O(1) index (layout in
``salun_torch/csrc/spack.cc``, the ``SPK1`` format of the JAX package: a
file written by either package reads in the other). The reader mmaps it
and a multithreaded C++ gather assembles uint8 batches with no Python per
sample. The C++ reader is the port's own copy, built with ``g++`` at
first use (``salun_torch.kernels._build``); a failed build raises. The
numpy memmap reader is its plain version, chosen only by ``native=False``.

Writer: :func:`pack_records` / :func:`pack_arrays` / :func:`pack_folder`.
Reader: :class:`SpackReader` (``get``, ``gather``, ``labels``,
``record_size``) and :class:`SpackDataset` for fixed-size raw images.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional, Tuple

import numpy as np

from salun_torch.kernels import _build

_MAGIC = b"SPK1"
_INDEX = np.dtype([("offset", "<u8"), ("size", "<u8"), ("label", "<i8")])


def _native_lib() -> ctypes.CDLL:
    """The built reader with its C signatures declared."""
    lib = _build.load("spack")
    vp, u64 = ctypes.c_void_p, ctypes.c_uint64
    lib.spack_open.restype = vp
    lib.spack_open.argtypes = [ctypes.c_char_p]
    lib.spack_count.restype = u64
    lib.spack_count.argtypes = [vp]
    lib.spack_label.restype = ctypes.c_int64
    lib.spack_label.argtypes = [vp, u64]
    lib.spack_record_size.restype = u64
    lib.spack_record_size.argtypes = [vp, u64]
    lib.spack_get.restype = u64
    lib.spack_get.argtypes = [vp, u64, vp, u64]
    lib.spack_gather.restype = None
    lib.spack_gather.argtypes = [vp, vp, u64, vp, u64, vp, ctypes.c_int]
    lib.spack_close.restype = None
    lib.spack_close.argtypes = [vp]
    return lib


# ------------------------------------------------------------------ writer


def pack_records(path: str, records, labels) -> None:
    """Write records (a list of bytes) and their labels into a spack file."""
    entries = []
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<QQ", len(records), 0))  # index offset, later
        for rec, lab in zip(records, labels):
            entries.append((f.tell(), len(rec), int(lab)))
            f.write(rec)
        index_offset = f.tell()
        for off, size, lab in entries:
            f.write(struct.pack("<QQq", off, size, lab))
        f.seek(12)
        f.write(struct.pack("<Q", index_offset))


def pack_arrays(path: str, data: np.ndarray, labels: np.ndarray) -> None:
    """Pack a uint8 array dataset (fixed-size raw records)."""
    if data.dtype != np.uint8:
        raise TypeError(f"spack records are uint8, not {data.dtype}")
    pack_records(path, [np.ascontiguousarray(x).tobytes() for x in data],
                 labels)


def pack_folder(path: str, folder: str, image_size: Optional[int] = None):
    """folder2lmdb (lmdb_dataset.py:90-128): a tree of class folders → a
    spack of raw RGB arrays; returns the class names in label order."""
    from PIL import Image

    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))
    recs, labels = [], []
    for ci, cls in enumerate(classes):
        d = os.path.join(folder, cls)
        for fn in sorted(os.listdir(d)):
            with Image.open(os.path.join(d, fn)) as im:
                img = im.convert("RGB")
            if image_size:
                img = img.resize((image_size, image_size))
            recs.append(np.asarray(img, np.uint8).tobytes())
            labels.append(ci)
    pack_records(path, recs, labels)
    return classes


# ------------------------------------------------------------------ reader


class SpackReader:
    """A spack file, read by the native C++ reader or, with
    ``native=False``, by the plain numpy memmap reader. Call :meth:`close`
    when done."""

    def __init__(self, path: str, native: bool = True):
        self.path = path
        self.native = bool(native)
        if self.native:
            self._lib = _native_lib()
            self._h = self._lib.spack_open(os.fsencode(path))
            if not self._h:
                raise ValueError(f"{path} is not a readable spack file")
            self._count = int(self._lib.spack_count(self._h))
        else:
            self._mm = np.memmap(path, np.uint8, mode="r")
            if bytes(self._mm[:4]) != _MAGIC:
                raise ValueError(f"{path} is not a spack file")
            self._count, index_offset = struct.unpack(
                "<QQ", self._mm[4:20].tobytes())
            size = len(self._mm)
            if not (20 <= index_offset <= size and self._count
                    <= (size - index_offset) // _INDEX.itemsize):
                raise ValueError(f"{path} is truncated or corrupt")
            self._index = np.frombuffer(
                self._mm[index_offset:index_offset + 24 * self._count],
                dtype=_INDEX)
            off, n = self._index["offset"], self._index["size"]
            if bool(((off > size) | (n > size - np.minimum(off, size))
                     ).any()):
                raise ValueError(f"{path} is truncated or corrupt")

    def __len__(self) -> int:
        return self._count

    def _check(self, indices: np.ndarray) -> None:
        if len(indices) and (indices.min() < 0
                             or indices.max() >= self._count):
            raise IndexError(f"record index out of [0, {self._count})")

    def labels(self) -> np.ndarray:
        if self.native:
            return np.array([self._lib.spack_label(self._h, i)
                             for i in range(self._count)], np.int64)
        return self._index["label"].copy()

    def record_size(self, i: int = 0) -> int:
        self._check(np.asarray([i]))
        if self.native:
            return int(self._lib.spack_record_size(self._h, i))
        return int(self._index["size"][i])

    def get(self, i: int) -> bytes:
        size = self.record_size(i)
        if self.native:
            buf = np.empty(size, np.uint8)
            self._lib.spack_get(self._h, i, buf.ctypes.data, size)
            return buf.tobytes()
        off = int(self._index["offset"][i])
        return self._mm[off:off + size].tobytes()

    def gather(self, indices, record_size: Optional[int] = None,
               threads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
        """Batch gather of fixed-size records → (uint8 [n, record_size],
        int64 labels [n]); the native reader copies on ``threads``
        threads."""
        indices = np.ascontiguousarray(indices, np.int64)
        self._check(indices)
        n = len(indices)
        record_size = record_size or self.record_size(0)
        out = np.empty((n, record_size), np.uint8)
        labels = np.empty(n, np.int64)
        if self.native:
            self._lib.spack_gather(self._h, indices.ctypes.data, n,
                                   out.ctypes.data, record_size,
                                   labels.ctypes.data, threads)
        else:
            for j, i in enumerate(indices):
                off = int(self._index["offset"][i])
                out[j] = np.frombuffer(self._mm[off:off + record_size],
                                       np.uint8)
                labels[j] = self._index["label"][i]
        return out, labels

    def close(self) -> None:
        if self.native:
            if self._h:
                self._lib.spack_close(self._h)
                self._h = None
        else:
            self._mm = self._index = None


class SpackDataset:
    """An ``ArrayDataset``-like view of a spack of fixed-size raw images:
    ``targets``, ``len`` and ``batch(indices)`` → (images, labels)."""

    def __init__(self, path: str, shape: Tuple[int, int, int],
                 num_classes: int, native: bool = True):
        self.reader = SpackReader(path, native=native)
        self.shape = shape
        self.num_classes = num_classes
        self.targets = self.reader.labels()

    def __len__(self) -> int:
        return len(self.reader)

    def batch(self, indices):
        flat, labels = self.reader.gather(np.asarray(indices))
        return flat.reshape((-1,) + self.shape), labels
