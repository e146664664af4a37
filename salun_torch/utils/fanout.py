"""Multi-job fan-out (counterpart of ``salun/utils/fanout.py``; parity:
Classification/utils.py:337-365 ``run_commands``).

Writes one shell script a device, round-robining the commands over them,
each command under ``CUDA_VISIBLE_DEVICES=<device>`` as the reference does
(the JAX package's default is ``TPU_VISIBLE_DEVICES``), and optionally runs
the scripts side by side.
"""

from __future__ import annotations

import os
import stat
from typing import List, Sequence


def run_commands(
    devices: Sequence[str], commands: List[str], call: bool = False,
    dir: str = "commands", shuffle: bool = True, delay: float = 0.5,
    env_var: str = "CUDA_VISIBLE_DEVICES",
) -> List[str]:
    """Write per-device shell scripts round-robining ``commands``; returns
    the script paths. ``devices`` are device identifiers exported via
    ``env_var``; with ``call`` the scripts run at once and this waits for
    them all."""
    import random

    if shuffle:
        commands = list(commands)
        random.shuffle(commands)
    os.makedirs(dir, exist_ok=True)
    per_dev = {d: [] for d in devices}
    for i, cmd in enumerate(commands):
        d = devices[i % len(devices)]
        per_dev[d].append(cmd)

    paths = []
    for d, cmds in per_dev.items():
        path = os.path.join(dir, f"run_{d}.sh")
        with open(path, "w") as f:
            f.write("#!/bin/bash\n")
            for cmd in cmds:
                f.write(f"{env_var}={d} {cmd}\n")
                if delay:
                    f.write(f"sleep {delay}\n")
        os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
        paths.append(path)
    if call:
        import subprocess

        procs = [subprocess.Popen(["bash", p]) for p in paths]
        for p in procs:
            p.wait()
    return paths
