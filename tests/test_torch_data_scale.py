"""The port's data at scale against ``salun.data``: spack, the host
pipeline and ImageNet.

- spack: files written by either package read identically in the other,
  through the port's native reader (its own ``csrc/spack.cc``, built with
  g++ at first use) and its numpy reader: records, labels and gathers
  bitwise; ``pack_folder`` writes the same bytes as JAX's; a failed build
  raises instead of switching readers; out-of-range indices raise; a
  truncated or corrupt file is refused when it is opened, by both readers.
- ``prefetch``: the same items in the same order as JAX's, the producer's
  exception re-raised, and an abandoned consumer stops the producer
  thread (the JAX oracle is ``tests/test_aux.py:81``); ``parallel_decode``
  keeps the order over several threads at once.
- ``device_prefetch`` on the CPU (asked for): the same batches; with no
  card the default device raises. Its CUDA path is checked on the card by
  ``chip_smoke.py``.
- ImageNet: a tiny ``DatasetDict`` written with ``save_to_disk`` (mixed
  image sizes and modes) read by both ``imagenet()`` functions and both
  ``ImageNetLoader``s: arrays, labels, weights and forget/retain indices
  bitwise (the same PIL resize); then ``main_forget --dataset imagenet``
  on that folder on the CPU.
"""

import math
import threading
import time

import numpy as np
import pytest
import torch

import salun.data.datasets as jax_datasets
import salun.data.pack as jax_pack
import salun.data.pipeline as jax_pipeline
from _torch_port import one_torch_thread  # noqa: F401
from salun.data.imagenet import ImageNetLoader as JaxImageNetLoader
from salun_torch.data import datasets as D
from salun_torch.data import pack, pipeline
from salun_torch.data.imagenet import ImageNetLoader, get_x_y_from_data_dict
from salun_torch.kernels import _build

# ------------------------------------------------------------------ spack


@pytest.fixture
def arrays(rng):
    data = rng.integers(0, 256, (64, 8, 8, 3), dtype=np.uint8)
    labels = rng.integers(-3, 1000, 64).astype(np.int64)
    return data, labels


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("native", [True, False])
def test_spack_cross_reads(tmp_path, rng, arrays, writer, native):
    data, labels = arrays
    path = str(tmp_path / "x.spack")
    (jax_pack if writer == "jax" else pack).pack_arrays(path, data, labels)
    r = pack.SpackReader(path, native=native)
    assert r.native is native and len(r) == 64
    np.testing.assert_array_equal(r.labels(), labels)
    assert r.record_size(5) == 192
    assert r.get(7) == data[7].tobytes()
    idx = rng.integers(0, 64, 100)  # repeats, any order
    flat, labs = r.gather(idx, threads=3)
    np.testing.assert_array_equal(flat.reshape(-1, 8, 8, 3), data[idx])
    np.testing.assert_array_equal(labs, labels[idx])
    empty, no_labels = r.gather(np.zeros(0, np.int64))
    assert empty.shape == (0, 192) and no_labels.shape == (0,)
    with pytest.raises(IndexError):
        r.gather([0, 64])
    r.close()
    # and the JAX reader on the same file
    j = jax_pack.SpackReader(path)
    jflat, jlabs = j.gather(idx)
    np.testing.assert_array_equal(jflat, flat)
    np.testing.assert_array_equal(jlabs, labs)
    j.close()


def test_spack_dataset_and_folder(tmp_path, rng, arrays):
    from salun_torch.cli.ddpm_sample import write_png

    data, labels = arrays
    path = str(tmp_path / "x.spack")
    pack.pack_arrays(path, data, labels)
    ds = pack.SpackDataset(path, (8, 8, 3), 1000)
    imgs, labs = ds.batch(np.arange(4))
    np.testing.assert_array_equal(imgs, data[:4])
    np.testing.assert_array_equal(ds.targets, labels)
    assert len(ds) == 64
    ds.reader.close()
    for c in ("b", "a"):
        for i, size in enumerate([(10, 12), (9, 9)]):
            (tmp_path / "tree" / c).mkdir(parents=True, exist_ok=True)
            write_png(str(tmp_path / "tree" / c / f"{i}.png"),
                      rng.integers(0, 256, size + (3,)).astype(np.uint8))
    ours, theirs = tmp_path / "port.spack", tmp_path / "jax.spack"
    assert pack.pack_folder(str(ours), str(tmp_path / "tree"), 6) == [
        "a", "b"]
    jax_pack.pack_folder(str(theirs), str(tmp_path / "tree"), 6)
    assert ours.read_bytes() == theirs.read_bytes()
    with pytest.raises(TypeError):
        pack.pack_arrays(path, data.astype(np.int16), labels)


def test_spack_build_failure_raises(tmp_path, monkeypatch, arrays):
    path = str(tmp_path / "x.spack")
    pack.pack_arrays(path, *arrays)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="compiler"):
        pack.SpackReader(path)
    (tmp_path / "bad.spack").write_bytes(b"NOPE" + bytes(32))
    with pytest.raises(ValueError):
        pack.SpackReader(str(tmp_path / "bad.spack"), native=False)


def _corrupt(raw: bytes, how: str) -> bytes:
    count, index_offset = np.frombuffer(raw[4:20], "<u8")
    if how == "truncated":  # cut in the middle of the index
        return raw[:int(index_offset) + 24 * int(count) // 2]
    if how == "count":  # more records than the index holds
        return raw[:4] + np.uint64(count + 1).tobytes() + raw[12:]
    if how == "index_offset":  # the index past the end of the file
        return raw[:12] + np.uint64(len(raw) + 8).tobytes() + raw[20:]
    entry = int(index_offset) + 24 * 3  # record 3 runs past the end
    return raw[:entry + 8] + np.uint64(len(raw)).tobytes() + raw[entry + 16:]


@pytest.mark.parametrize("how", ["truncated", "count", "index_offset",
                                 "record"])
@pytest.mark.parametrize("native", [True, False])
def test_spack_rejects_a_corrupt_file(tmp_path, arrays, how, native):
    path = tmp_path / "x.spack"
    pack.pack_arrays(str(path), *arrays)
    good = path.read_bytes()
    pack.SpackReader(str(path), native=native).close()
    path.write_bytes(_corrupt(good, how))
    with pytest.raises(ValueError):
        pack.SpackReader(str(path), native=native)


def test_spack_library_lands_in_the_build_dir():
    lib = _build.library_path("spack")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libspack-")
    assert "spack" in _build.sources()
    _build.load("spack")
    assert lib.exists()


# ------------------------------------------------------------------ pipeline


def _gen(n, produced=None, fail_at=None):
    for i in range(n):
        if fail_at is not None and i == fail_at:
            raise KeyError("producer failed")
        if produced is not None:
            produced.append(i)
        yield i


def test_prefetch_matches_jax_order_and_errors():
    assert list(pipeline.prefetch(_gen(50), depth=3)) == list(
        jax_pipeline.prefetch(_gen(50), depth=3)) == list(range(50))
    for mod in (pipeline, jax_pipeline):
        got = []
        with pytest.raises(KeyError, match="producer failed"):
            for x in mod.prefetch(_gen(10, fail_at=4), depth=2):
                got.append(x)
        assert got == [0, 1, 2, 3]


def test_prefetch_abandoned_consumer_stops_producer():
    produced = []
    n_before = threading.active_count()
    it = pipeline.prefetch(_gen(1000, produced), depth=2)
    for x in it:
        if x >= 3:
            break
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before, "producer thread leaked"
    assert len(produced) < 1000


def test_parallel_decode_order_and_fanout():
    gate = threading.Barrier(4, timeout=10)
    seen = set()

    def decode(rec):
        seen.add(threading.get_ident())
        gate.wait()  # all four in flight at once, or the barrier times out
        return np.full((2, 2), rec, np.uint8)

    dec = pipeline.parallel_decode(decode, workers=4)
    out = dec.map([3, 1, 4, 1])
    dec.close()
    assert len(seen) == 4
    np.testing.assert_array_equal(out[:, 0, 0], [3, 1, 4, 1])


def test_device_prefetch_on_the_cpu(monkeypatch):
    rng = np.random.default_rng(1)
    batches = [{"x": rng.integers(0, 256, (4, 3), dtype=np.uint8),
                "y": (torch.arange(4) + i, [np.float32(i)])}
               for i in range(3)]
    got = list(pipeline.device_prefetch(iter(batches), "cpu"))
    assert len(got) == 3
    for g, b in zip(got, batches):
        assert torch.equal(g["x"], torch.from_numpy(b["x"]))
        assert torch.equal(g["y"][0], b["y"][0])
        assert float(g["y"][1][0]) == float(b["y"][1][0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pipeline.device_prefetch(iter(batches)))


# ------------------------------------------------------------------ ImageNet


@pytest.fixture(scope="module")
def imagenet_dir(tmp_path_factory):
    datasets = pytest.importorskip("datasets")
    from PIL import Image

    rng = np.random.default_rng(2)

    def split(n):
        imgs, labels = [], []
        for i in range(n):
            h, w = (int(x) for x in rng.integers(12, 40, 2))
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            img = Image.fromarray(arr)
            imgs.append(img.convert("L") if i % 5 == 0 else img)
            labels.append(int(rng.integers(0, 3)) * 300)  # classes 0/300/600
        return datasets.Dataset.from_dict(
            {"image": imgs, "label": labels},
            features=datasets.Features({
                "image": datasets.Image(),
                "label": datasets.ClassLabel(num_classes=1000)}))

    out = tmp_path_factory.mktemp("imagenet") / "imagenet-1k"
    datasets.DatasetDict({"train": split(30), "validation": split(11)}
                         ).save_to_disk(str(out))
    return str(out)


def test_imagenet_arrays_match_jax(imagenet_dir, monkeypatch):
    monkeypatch.setenv("SALUN_IMAGENET_SIZE", "16")
    for train in (True, False):
        got = D.load("imagenet", imagenet_dir, train=train)
        want = jax_datasets.imagenet(imagenet_dir, train=train)
        assert got.num_classes == want.num_classes == 1000
        assert got.data.shape == ((30 if train else 11), 16, 16, 3)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.targets, want.targets)
    with pytest.raises(FileNotFoundError):
        D.load("imagenet", imagenet_dir + "-missing")


@pytest.mark.parametrize("cls,num", [(300, None), (300, 4), (-1, 7)])
def test_imagenet_loaders_match_jax(imagenet_dir, cls, num):
    kw = dict(batch_size=4, image_size=12, seed=3, decode_workers=2,
              prefetch_depth=2)
    ours, theirs = ImageNetLoader(imagenet_dir, **kw), JaxImageNetLoader(
        imagenet_dir, **kw)
    for a, b in zip(ours.forget_retain_indices(cls, num),
                    theirs.forget_retain_indices(cls, num)):
        np.testing.assert_array_equal(a, b)
    got, want = ours.loaders(cls, num), theirs.loaders(cls, num)
    for name in ("forget", "retain", "val"):
        for _ in range(2):  # a second pass continues the in-place shuffle
            g, w = list(got[name]()), list(want[name]())
            assert len(g) == len(w) > 0, name
            for gb, wb in zip(g, w):
                assert list(gb) == list(wb) == ["image", "label", "weight"]
                for k in gb:
                    assert gb[k].dtype == wb[k].dtype
                    np.testing.assert_array_equal(gb[k], wb[k], err_msg=name)
    x, y = get_x_y_from_data_dict(g[0])
    assert x.shape == (4, 12, 12, 3) and y.dtype == np.int32
    ours.close()


def test_main_forget_on_imagenet(imagenet_dir, tmp_path, monkeypatch):
    from salun_torch.cli import main_forget

    monkeypatch.setenv("SALUN_IMAGENET_SIZE", "32")
    results = main_forget.main([
        "--dataset", "imagenet", "--data", imagenet_dir, "--arch",
        "resnet18", "--imagenet_arch", "--device", "cpu", "--batch_size",
        "8", "--unlearn", "FT", "--unlearn_epochs", "1", "--unlearn_lr",
        "0.01", "--num_indexes_to_replace", "6", "--class_to_replace", "300",
        "--save_dir", str(tmp_path)])
    for k in ("retain", "forget", "val", "test", "UA"):
        assert math.isfinite(results[k]), k
    ckpt = torch.load(tmp_path / "FT_checkpoint.pt", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    assert state["fc.weight"].shape == (1000, 512)
