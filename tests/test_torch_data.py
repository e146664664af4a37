"""The port's data path against ``salun.data``: readers, splits, the batch
iterator and augmentation. All bitwise: they are selections and the same
numpy draws; ``to_float`` is one fp32 division on both sides."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_step_draws, nchw
from salun.data import datasets as JD
from salun.data import loader as JL
from salun.data import splits as JS
from salun_torch.data import datasets as D
from salun_torch.data import loader as L
from salun_torch.data import splits as S


def _same_ds(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.targets, b.targets)
    assert a.num_classes == b.num_classes


def test_synthetic_matches():
    _same_ds(D.synthetic(n=300, seed=3), JD.synthetic(n=300, seed=3))
    _same_ds(D.load("synthetic", "."), JD.load("synthetic", "."))


def test_cifar10_reader_matches(rng, tmp_path):
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (7, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, 7).tolist()}, f)
    for train in (True, False):
        _same_ds(D.cifar10(str(tmp_path), train), JD.cifar10(str(tmp_path),
                                                            train))
    # ImageNet is ported (a local save_to_disk folder); a CIFAR folder is
    # not one, and without `datasets` the reader cannot start
    with pytest.raises((FileNotFoundError, ImportError)):
        D.load("imagenet", str(tmp_path))


@pytest.mark.parametrize("class_to_replace,num", [(-1, 40), (3, None),
                                                  (2, 5)])
def test_splits_match(class_to_replace, num):
    train = D.synthetic(n=400, seed=0)
    jtrain = JD.synthetic(n=400, seed=0)
    for a, b in zip(S.validation_split(train, seed=2),
                    JS.validation_split(jtrain, seed=2)):
        _same_ds(a, b)
    marked = S.replace_class(train, class_to_replace, num, seed=1,
                             only_mark=True)
    jmarked = JS.replace_class(jtrain, class_to_replace, num, seed=1,
                               only_mark=True)
    _same_ds(marked, jmarked)
    for a, b in zip(S.forget_retain_split(marked),
                    JS.forget_retain_split(jmarked)):
        _same_ds(a, b)
    idx = np.array([0, 5, 7])
    _same_ds(S.replace_indexes(train, idx, seed=4),
             JS.replace_indexes(jtrain, idx, seed=4))
    _same_ds(S.drop_class(train, 1), JS.drop_class(jtrain, 1))


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_matches(shuffle):
    ds = D.synthetic(n=75, seed=5)
    ours = L.BatchIterator(ds, 16, shuffle=shuffle, seed=3)
    theirs = JL.BatchIterator(JD.synthetic(n=75, seed=5), 16,
                              shuffle=shuffle, seed=3)
    assert len(ours) == len(theirs)
    for _ in range(2):   # two passes: the per-pass order advances alike
        for a, b in zip(ours, theirs, strict=True):
            for k in ("image", "label", "weight"):
                np.testing.assert_array_equal(a[k], b[k])
    last = list(ours)[-1]   # 75 = 4·16 + 11: five weight-0 padding rows
    assert last["weight"].sum() == 11 and last["image"].shape[0] == 16


def test_to_device_and_to_float(rng):
    batch = {"image": rng.integers(0, 256, (3, 32, 32, 3), np.uint8),
             "label": np.array([1, 2, 3], np.int32),
             "weight": np.array([1, 1, 0], np.float32)}
    dev = L.to_device(batch, "cpu")
    assert dev["image"].shape == (3, 3, 32, 32)
    assert dev["image"].dtype == torch.uint8 and dev["label"].dtype == torch.int64
    got = L.to_float(dev["image"]).numpy()
    want = np.asarray(JL.to_float(jnp.asarray(batch["image"])))
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


def test_augment_bitwise_with_injected_draws(rng):
    img = rng.random((6, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JL.augment(key, jnp.asarray(img)))
    # the same draws as JL.augment makes from its key
    kc, kf = jax.random.split(key)
    offsets = np.array(jax.random.randint(kc, (6, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(kf, 0.5, (6,)))
    assert flips.any() and not flips.all()
    got = L.augment(nchw(img), torch.from_numpy(offsets.astype(np.int64)),
                    torch.from_numpy(flips)).numpy()
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))
    # the helper the RL tests use reproduces the train step's draws
    o2, f2, _ = jax_step_draws(key, 6, 10)
    assert o2.shape == (6, 2) and f2.shape == (6,)


def test_draw_augment_ranges():
    gen = torch.Generator().manual_seed(0)
    offsets, flips = L.draw_augment(gen, 512)
    assert int(offsets.min()) == 0 and int(offsets.max()) == 8
    assert flips.dtype == torch.bool and 0 < int(flips.sum()) < 512
