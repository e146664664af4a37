"""The port's CIFAR-100, SVHN and TinyImageNet readers against
``salun.data.datasets`` on synthetic files written in each dataset's own
format (python pickles and their ``.tar.gz``, ``scipy.io.savemat``, a PNG
tree): arrays and labels equal, bitwise. Also the batch iterator's
``set_epoch`` against the JAX package's."""

import io
import pickle
import tarfile

import numpy as np
import pytest
import scipy.io
from PIL import Image

from salun.data import datasets as JD
from salun.data import loader as JL
from salun_torch.data import datasets as D
from salun_torch.data import loader as L


def _same_ds(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.targets, b.targets)
    assert a.data.dtype == b.data.dtype and a.targets.dtype == b.targets.dtype
    assert (a.num_classes, a.name) == (b.num_classes, b.name)


@pytest.mark.parametrize("archived", [False, True])
def test_cifar100_reader_matches(rng, tmp_path, archived):
    files = {}
    for split, n in (("train", 9), ("test", 5)):
        files[split] = pickle.dumps({
            b"data": rng.integers(0, 256, (n, 3072), np.uint8),
            b"fine_labels": rng.integers(0, 100, n).tolist(),
            b"coarse_labels": rng.integers(0, 20, n).tolist()})
    for root in ("ours", "theirs"):
        d = tmp_path / root
        d.mkdir()
        if archived:  # only the archive: the reader extracts it
            with tarfile.open(d / "cifar-100-python.tar.gz", "w:gz") as tf:
                for split, blob in files.items():
                    info = tarfile.TarInfo(f"cifar-100-python/{split}")
                    info.size = len(blob)
                    tf.addfile(info, io.BytesIO(blob))
        else:
            (d / "cifar-100-python").mkdir()
            for split, blob in files.items():
                (d / "cifar-100-python" / split).write_bytes(blob)
    for train in (True, False):
        ours = D.load("cifar100", str(tmp_path / "ours"), train=train)
        _same_ds(ours, JD.load("cifar100", str(tmp_path / "theirs"),
                               train=train))
        assert ours.data.shape[1:] == (32, 32, 3)


def test_svhn_reader_matches(rng, tmp_path):
    for split, n in (("train", 11), ("test", 6)):
        y = rng.integers(1, 11, (n, 1)).astype(np.uint8)
        y[0] = 10  # digit 0
        scipy.io.savemat(tmp_path / f"{split}_32x32.mat", {
            "X": rng.integers(0, 256, (32, 32, 3, n), np.uint8), "y": y})
    for train in (True, False):
        ours = D.load("svhn", str(tmp_path), train=train)
        _same_ds(ours, JD.load("svhn", str(tmp_path), train=train))
        assert ours.targets[0] == 0 and ours.targets.max() <= 9


def test_tiny_imagenet_reader_matches(rng, tmp_path):
    wnids = ["n0300", "n0100", "n0200"]  # listed unsorted on purpose
    (tmp_path / "wnids.txt").write_text("\n".join(wnids) + "\n")

    def png(path, mode):
        arr = rng.integers(0, 256, (8, 8, 3), np.uint8)
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr).convert(mode).save(path)

    for i, w in enumerate(wnids):
        for j in (2, 0, 1):
            png(tmp_path / "train" / w / "images" / f"{w}_{j}.png",
                "L" if (i + j) % 3 == 0 else "RGB")
    lines = []
    for j in range(5):
        png(tmp_path / "val" / "images" / f"val_{j}.png", "RGB")
        lines.append(f"val_{j}.png\t{wnids[j % 3]}\t0\t0\t8\t8")
    (tmp_path / "val" / "val_annotations.txt").write_text(
        "\n".join(lines[::-1]) + "\n")
    for name in ("tiny_imagenet", "TinyImagenet"):
        for train in (True, False):
            ours = D.load(name, str(tmp_path), train=train)
            _same_ds(ours, JD.load(name, str(tmp_path), train=train))
            assert ours.data.shape[1:] == (8, 8, 3)
    assert list(D.load("tiny_imagenet", str(tmp_path)).targets) == [
        0, 0, 0, 1, 1, 1, 2, 2, 2]


def test_set_epoch_pins_the_shuffle_order():
    ours = L.BatchIterator(D.synthetic(n=40, seed=1), 16, seed=5)
    theirs = JL.BatchIterator(JD.synthetic(n=40, seed=1), 16, seed=5)
    for epoch in (3, 0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for a, b in zip(ours, theirs, strict=True):
            np.testing.assert_array_equal(a["label"], b["label"])
            np.testing.assert_array_equal(a["image"], b["image"])
    ours.set_epoch(3)
    first = [b["label"] for b in ours]
    ours.set_epoch(3)
    again = [b["label"] for b in ours]
    assert all(np.array_equal(x, y) for x, y in zip(first, again, strict=True))
