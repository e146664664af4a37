"""Artifacts on disk (counterpart of ``salun/ckpt/store.py``), in the
reference's torch formats:

- masks ``with_{t}.pt``: ``{torch_param_name: 0/1 fp32 tensor}``
  (Classification/generate_mask.py:82), readable by
  ``salun.ckpt.import_mask``;
- ``{unlearn}_checkpoint.pt`` and ``model_SA_best.pt``: ``{"state_dict":
  ...}`` (utils.py:44-52), readable by ``salun.ckpt.import_resnet`` /
  ``import_vgg``;
- ``{unlearn}_eval_result.json`` as ``salun.ckpt.save_eval_results`` writes
  it;
- ``main_train``'s ``checkpoint.pt``: the model, the optimizer's
  flat momentum and step count, the step-randomness generator's state,
  ``epoch``, ``best_sa`` and the curves, all a resumed run needs to
  continue bitwise as a straight run would;
- sharded state (:func:`save_sharded`, :func:`restore_sharded`): a
  directory in ``torch.distributed.checkpoint``'s format, not the JAX
  package's orbax one. Each rank writes its own shards of DTensors (FSDP,
  tensor parallelism) and whole tensors once; a restore reads into any
  layout, one process or another mesh.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist


def mask_path(save_dir: str, threshold: float) -> str:
    return os.path.join(save_dir, f"with_{threshold}.pt")


def save_mask(path: str, mask: Dict[str, torch.Tensor]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().to("cpu", torch.float32)
                for k, v in mask.items()}, path)


def load_mask(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    md = torch.load(path, map_location="cpu", weights_only=True)
    return {(k[len("module."):] if k.startswith("module.") else k):
            v.to(device) for k, v in md.items()}


def _cpu_state_dict(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_model(path: str, model: torch.nn.Module) -> str:
    """``model`` as ``{"state_dict": ...}`` at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": _cpu_state_dict(model)}, path)
    return path


def checkpoint_path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, f"{name}_checkpoint.pt")


def save_checkpoint(save_dir: str, name: str, model: torch.nn.Module) -> str:
    return save_model(checkpoint_path(save_dir, name), model)


def save_train_state(path: str, model: torch.nn.Module, opt,
                     gen: torch.Generator, *, epoch: int, best_sa: float,
                     curves: dict) -> None:
    """The pretraining checkpoint; ``opt`` is a flat-buffer optimizer
    (``salun_torch.core.masked_opt``)."""
    torch.save({"state_dict": _cpu_state_dict(model),
                "momentum": opt.trace.detach().cpu(), "count": opt.count,
                "generator": gen.get_state(), "epoch": int(epoch),
                "best_sa": float(best_sa),
                "curves": {k: [float(x) for x in v]
                           for k, v in curves.items()}}, path)


def load_train_state(path: str, model: torch.nn.Module, opt,
                     gen: torch.Generator) -> dict:
    """Restore what :func:`save_train_state` wrote into ``model``, ``opt``
    and ``gen`` (in place); returns ``{"epoch", "best_sa", "curves"}``."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ck["state_dict"], strict=True)
    opt.trace.copy_(ck["momentum"])
    opt.count = int(ck["count"])
    gen.set_state(ck["generator"])
    return {"epoch": int(ck["epoch"]), "best_sa": float(ck["best_sa"]),
            "curves": {k: list(v) for k, v in ck["curves"].items()}}


def _floats(tree):
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    return float(tree)


def save_eval_results(save_dir: str, name: str, results: dict) -> None:
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, f"{name}_eval_result.json"), "w") as f:
        json.dump(_floats(results), f, indent=2)


_ASYNC_GROUP: list = [None, None]  # (the default group, its writers' group)


def _async_group() -> Optional[dist.ProcessGroup]:
    """A gloo group of its own for the background writes of
    :func:`save_sharded` (created once per process group, by every rank):
    their planning collectives run on a thread while training's run on the
    default group, and two threads' collectives on one group could meet
    in another order on each rank."""
    if not dist.is_initialized():
        return None
    if _ASYNC_GROUP[0] is not dist.group.WORLD:
        _ASYNC_GROUP[:] = [dist.group.WORLD, dist.new_group(backend="gloo")]
    return _ASYNC_GROUP[1]


class SaveHandle:
    """What :func:`save_sharded` returns: ``wait()`` returns once the files
    are complete (at once for a synchronous save)."""

    def __init__(self, future=None):
        self._future = future

    def wait(self) -> None:
        if self._future is None:
            return
        # torch returns a Future, or a response holding one
        fut = getattr(self._future, "upload_completion", self._future)
        fut.result()
        self._future = None


def save_sharded(path: str, state: dict, async_: bool = False
                 ) -> SaveHandle:
    """Write ``state`` (nested dicts of tensors and DTensors) to the
    directory ``path`` with ``torch.distributed.checkpoint``: every rank
    of the launch calls it and writes its own shards. ``async_`` copies
    the state to host memory, returns, and writes on a background thread
    (``dcp.async_save``): the caller may go on changing the tensors, and
    waits on the handle before it relies on the files."""
    import torch.distributed.checkpoint as dcp

    os.makedirs(path, exist_ok=True)
    if not async_:
        dcp.save(state, checkpoint_id=path)
        return SaveHandle()
    return SaveHandle(dcp.async_save(state, checkpoint_id=path,
                                     process_group=_async_group()))


def restore_sharded(path: str, like: dict) -> dict:
    """Read a :func:`save_sharded` directory into ``like`` (the same nested
    keys, or a subset), in place, and return it. Each tensor takes its
    own layout: a plain tensor reads the whole value, a DTensor its shard;
    so a state saved under FSDP restores into one process or another
    mesh."""
    import torch.distributed.checkpoint as dcp

    dcp.load(like, checkpoint_id=path)
    return like
