"""Sharded checkpoints (``salun_torch.ckpt.save_sharded`` /
``restore_sharded``, ``torch.distributed.checkpoint``; the counterpart of
``tests/test_ckpt_sharded.py``) on the CPU: on two spawned gloo ranks an
FSDP-sharded tiny SD U-Net and its Adam state after one masked step are
saved, synchronously and with ``async_save`` while one more step changes
the state; both restore bitwise on the same ranks into the tensor-
parallel (1, 2) layout, and here, in one process with no group, into
whole tensors. One process alone round-trips plain tensors."""

import numpy as np
import pytest
import torch

import _sharded_workers as workers
from _torch_port import one_torch_thread  # noqa: F401
from salun_torch.ckpt import restore_sharded, save_sharded


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_sharded")
    out = workers.spawn("ckpt", str(tmp))
    for o in out:
        assert "error" not in o, o["error"]
    return tmp, out


def _whole_like(want):
    return {"unet": {n: torch.empty_like(v) for n, v in want["unet"].items()},
            "adam": {n: {k: torch.empty_like(v) for k, v in s.items()}
                     for n, s in want["adam"].items()}}


@pytest.mark.parametrize("name", ["sync", "async"])
def test_restore_whole_in_one_process(saved, name):
    tmp, _ = saved
    want = torch.load(tmp / "want.pt", weights_only=True)
    got = restore_sharded(str(tmp / name), _whole_like(want))
    assert workers._equal(got, want)
    assert len(got["adam"]) == len(got["unet"]) > 0


@pytest.mark.parametrize("name", ["sync", "async"])
def test_restore_into_the_tp_layout(saved, name):
    for o in saved[1]:
        assert o[f"tp_restore_{name}"], o


def test_async_save_keeps_the_state_at_the_call(saved):
    """The step taken while the async save wrote moved the state; the
    files hold the state of the call (the restores above)."""
    for o in saved[1]:
        assert o["step_moved_state"]


def test_one_process_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(5, 7, generator=g), "n": {"b": torch.arange(4),
                                                        "s": torch.tensor(3.)}}
    save_sharded(str(tmp_path / "c"), state).wait()
    like = {"w": torch.zeros(5, 7), "n": {"b": torch.zeros(4, dtype=torch.long),
                                          "s": torch.tensor(0.)}}
    got = restore_sharded(str(tmp_path / "c"), like)
    assert torch.equal(got["w"], state["w"])
    np.testing.assert_array_equal(got["n"]["b"], [0, 1, 2, 3])
    assert float(got["n"]["s"]) == 3.0
