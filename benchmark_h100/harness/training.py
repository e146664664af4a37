"""What the training cells share: the program's readings of its first
checked steps, the reference's same steps, and the check between them.

A training driver subclasses :class:`TrainingDriver`. In set-up it drives
the window's own step object through its first ``checked_steps`` steps,
calling :meth:`TrainingDriver.read_first_step` after the first and
:meth:`TrainingDriver.read_change` after the last; its ``reference``
returns :func:`reference_steps`'s readings of the plain reference over the
same steps.
"""

from __future__ import annotations

import torch

from benchmark_h100.harness import compare
from benchmark_h100.reference import ops


def first_gradient(adams, model) -> dict:
    """{leaf: its first gradient as Adam took it, fp32 on the host}: after
    one step from zero state, Adam's first moment is (1 − β₁)·g."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for adam in adams:
        b1 = adam.defaults["betas"][0]
        for p, st in adam.state.items():
            if "exp_avg" in st:
                out[names[id(p)]] = (st["exp_avg"].float()
                                     / (1 - b1)).to("cpu")
    return out


@torch.no_grad()
def change_norms(model, start_leaves) -> dict:
    """{leaf: ‖θ − θ₀‖}, θ₀ the seeded start each leaf was filled with."""
    named = dict(model.named_parameters())
    return {n: float((named[n] - v).norm()) for n, v in start_leaves}


def reference_steps(model, mask: list, adam, step_grads, steps: int,
                    start_leaves) -> dict:
    """The reference's readings of ``steps`` steps: ``step_grads(i)``
    returns step i's loss and its gradients (fp32, clipped where the
    configuration clips); each is masked, then ``adam`` steps. Returns the
    mask, the losses, the first step's masked gradient (on the device) and
    the change of each leaf over the steps."""
    names = [n for n, _ in model.named_parameters()]
    losses, first = [], None
    for i in range(steps):
        loss, grads = step_grads(i)
        grads = [g * m for g, m in zip(grads, mask)]
        if i == 0:
            first = dict(zip(names, grads))
        adam.step(grads)
        losses.append(loss)
        del grads
    return {"mask": dict(zip(names, mask)), "losses": losses,
            "grad": first, "change_norms": change_norms(model, start_leaves)}


class TrainingDriver:
    """The check of a training cell, shared by its drivers."""

    kind = "train"  # what a unit is: an optimizer step or a request

    def model_under_test(self):
        raise NotImplementedError

    def adams(self) -> list:
        raise NotImplementedError

    def start_leaves(self, model):
        """(name, θ₀) of each leaf of ``model``, from the seed."""
        raise NotImplementedError

    def read_first_step(self) -> None:
        self.grad = first_gradient(self.adams(), self.model_under_test())

    def read_change(self) -> None:
        model = self.model_under_test()
        self.change = change_norms(model, self.start_leaves(model))

    def program_readings(self) -> dict:
        return {"mask": self.mask_host, "losses": self.losses,
                "grad": self.grad, "change_norms": self.change}

    def compare(self, ref: dict, prog: dict) -> compare.Checks:
        return compare.training_checks(self.limits, ref, prog)

    def check(self) -> compare.Checks:
        prog = self.program_readings()
        del self.mask_host, self.grad
        with ops.fp32_exact():
            ref = self.reference()
        return self.compare(ref, prog)
