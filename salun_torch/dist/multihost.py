"""Multi-process runtime helpers (counterpart of ``salun/dist/multihost.py``).

The JAX package runs ``--dp N`` in one process and lets GSPMD place the
batch; the port runs N processes started by ``torchrun --nproc_per_node
N``, one shard of the batch each, and this module brings up their process
group:

- :func:`initialize` reads the torchrun environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``) and calls ``init_process_group`` with the backend
  :func:`backend_for` picks; single-process it is a no-op.
- :func:`process_shard` is the same pure function as JAX's: the
  ``[start, stop)`` of a dataset a process owns.

``host_local_to_global`` has no counterpart: a rank's tensor already is
its shard, and the collectives of ``salun_torch.dist.context`` combine
what the ranks computed.

The backend follows the placement and never falls back: NCCL when every
rank of a node has a card of its own, gloo when ranks share a card (NCCL
refuses two ranks on one device) and on the CPU. A failed init raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def launch_env() -> Optional[dict]:
    """The torchrun variables of this process, or None outside torchrun."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    return {"rank": int(os.environ["RANK"]), "world": world,
            "local_rank": int(os.environ.get("LOCAL_RANK", 0)),
            "local_world": int(os.environ.get("LOCAL_WORLD_SIZE", world))}


def rank_device(device, env: dict) -> torch.device:
    """The device rank ``env["rank"]`` runs on: ``cuda:(LOCAL_RANK mod
    device_count)`` for a CUDA device, the CPU for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the ranks on the CPU")
    return torch.device("cuda", env["local_rank"] % torch.cuda.device_count())


def backend_for(device: torch.device, env: dict) -> str:
    """NCCL when each rank of a node has a card of its own, else gloo (ranks
    that share a card, and the CPU)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if env["local_world"] <= torch.cuda.device_count() \
        else "gloo"


def initialize(device="cpu") -> Optional[str]:
    """Bring up the process group of a torchrun launch on ``device``;
    returns the backend, or None single-process (no torchrun environment,
    or a world of one). A group already up is kept when its backend is the
    one the rule picks, and raises otherwise."""
    env = launch_env()
    if env is None or env["world"] <= 1:
        return None
    dev = rank_device(device, env)
    backend = backend_for(dev, env)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is up; "
                               f"this placement needs {backend}")
        return backend
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method="env://",
                            rank=env["rank"], world_size=env["world"])
    return backend


def shutdown() -> None:
    """``destroy_process_group`` when a group is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_shard(n: int, process_id: Optional[int] = None,
                  process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) of the dataset slice this process loads.

    Disjoint and exhaustive across processes; remainder items go to the
    leading processes (sizes differ by at most 1). Without arguments the
    rank and world size come from the process group (one process when none
    is up)."""
    up = dist.is_initialized()
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    count = ((dist.get_world_size() if up else 1) if process_count is None
             else process_count)
    if not 0 <= pid < count:
        raise ValueError(f"process_id {pid} outside [0, {count})")
    base, rem = divmod(n, count)
    start = pid * base + min(pid, rem)
    return start, start + base + (1 if pid < rem else 0)
