#!/usr/bin/env python3
"""Which side drifts on the 4-step RL trajectory at batch 16: the JAX
package or the port?

Runs masked RL (CIFAR-10 regime, one epoch: two forget steps with random
labels, two retain steps) on resnet20s with perturbed BatchNorm, 24 forget
and 32 retain synthetic images at batch 16, lr 0.013, the same draws
(augment offsets and flips, random labels) replayed from one JAX key on
every run, as ``tests/test_torch_methods.py`` runs it at batch 32. Five
runs:

- ``jax32``: ``salun.core.methods.RL`` in fp32;
- ``jax64``: the same with ``jax_enable_x64`` and the model's dtype
  float64 (``randint`` and ``bernoulli`` held to their fp32-run dtypes,
  so the draws stay the same), float64 end to end: the process reads
  ``jnp.float32`` as ``float64`` in the modules that cast to it
  (``_WIDE``: BatchNorm's batch statistics, the fc layer, the input and
  the log-softmax), with the package's files unchanged;
- ``jax64c``: ``jax64`` with those fp32 casts kept, as far as the
  package itself goes in float64;
- ``port32``: ``salun_torch.core.methods.RL`` in fp32;
- ``ref64``: an independent float64 reference in torch double end to
  end: the port's resnet20s cast to double and its augment, with the
  cross-entropy and the masked momentum SGD (θ₀ pinned) written out here.
  It is not ``salun_torch.core.methods.RL``, which is fp32 by design (its
  flat-buffer optimizer, its loader's cast and its cross-entropy's cast),
  so it cannot run in double. ``jax64 vs ref64`` says whether the two
  float64 runs, written apart, agree.

For every pair it prints the worst tensor's ``max|a − b| / max|b − θ₀|``
(the measure of the trajectory tests, whose bound is 0.1) and writes them
as JSON. Run from the repository root on the CPU (about a minute)::

    JAX_PLATFORMS=cpu python3 tools/batch16_fp64.py [--batch 16] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
FORGET, RETAIN, LR, KEY, MASK_SEED = 24, 32, 0.013, 11, 0


def _setup(x64: bool):
    """(flax model, numpy params, numpy batch stats, numpy mask tree)."""
    import jax
    import jax.numpy as jnp

    from _torch_port import jax_model_and_vars

    rng = np.random.default_rng(MASK_SEED)
    model, params, stats = jax_model_and_vars("resnet20s", rng)
    mask = jax.tree.map(
        lambda p: (rng.random(p.shape) > 0.4).astype(np.float32), params)
    if x64:
        from salun.models import create_model

        model = create_model("resnet20s", 10, dtype=jnp.float64)
    return model, params, stats, mask


def _cfg(mod, bs):
    return mod.UnlearnConfig(dataset="cifar10", num_classes=10,
                             arch="resnet20s", unlearn_lr=LR,
                             unlearn_epochs=1, batch_size=bs,
                             decreasing_lr="1", seed=2)


def _loaders(mod_d, mod_l, bs):
    return {"forget": mod_l.BatchIterator(mod_d.synthetic(n=FORGET, seed=4),
                                          bs, shuffle=True, seed=2),
            "retain": mod_l.BatchIterator(mod_d.synthetic(n=RETAIN, seed=5),
                                          bs, shuffle=True, seed=2)}


# the JAX modules on RL's path that cast to jnp.float32
_WIDE = ("salun.models.layers", "salun.models.resnets", "salun.data.loader",
         "salun.core.train")


class _WideNumpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp, "float64" if name == "float32" else name)


def run_jax(bs: int, x64: bool, out: str, keep_casts: bool = False) -> None:
    import jax

    # the tests' setting (tests/conftest.py)
    jax.config.update("jax_default_matmul_precision", "highest")
    if x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    if x64:
        # x64 widens randint's and bernoulli's default dtypes, which draws
        # other numbers from the same key: keep the fp32 run's draws
        randint, uniform = jax.random.randint, jax.random.uniform
        jax.random.randint = (lambda key, shape, minval, maxval,
                              dtype=jnp.int32: randint(key, shape, minval,
                                                       maxval, dtype))
        jax.random.bernoulli = (lambda key, p=0.5, shape=None:
                                uniform(key, shape, jnp.float32) < p)

    if x64 and not keep_casts:
        import importlib

        for name in _WIDE:
            importlib.import_module(name).jnp = _WideNumpy(jnp)
    import salun.core.methods as M
    from salun.core.masked_opt import sgd
    from salun.core.train import TrainState
    from salun.data import datasets as JD
    from salun.data import loader as JL
    from salun_torch.ckpt import state_dict_from_jax

    model, params, stats, mask = _setup(x64)
    dt = jnp.float64 if x64 else jnp.float32
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dt), tree)  # noqa: E731
    state = TrainState.create({"params": cast(params),
                               "batch_stats": cast(stats)}, sgd(LR))
    state = M.RL(_loaders(JD, JL, bs), model, state, _cfg(M, bs),
                 mask=cast(mask), key=jax.random.PRNGKey(KEY))
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    sd = state_dict_from_jax(f64(state.params), f64(state.batch_stats))
    np.savez(out, **{k: v.numpy() for k, v in sd.items()})


def run_torch(bs: int, f64: bool) -> dict:
    """``port32`` (``f64`` false) or ``ref64``, as the module docstring
    says."""
    import jax
    import torch

    from _torch_port import jax_key_source, port_twin
    from salun_torch.ckpt import mask_from_jax
    from salun_torch.core import methods as P
    from salun_torch.data import datasets as D
    from salun_torch.data import loader as L

    model, params, stats, mask_tree = _setup(False)
    twin = port_twin("resnet20s", params, stats)
    mask = mask_from_jax(mask_tree)
    source = jax_key_source(jax.random.PRNGKey(KEY), 10)
    cpu = torch.device("cpu")
    if not f64:
        out, opt = P.RL(_loaders(D, L, bs), twin, _cfg(P, bs), mask=mask,
                        device=cpu, source=source)
        return {k: v.double().numpy() for k, v in out.state_dict().items()}

    twin = twin.double()
    names = [n for n, _ in twin.named_parameters()]
    theta0 = {n: p.detach().clone() for n, p in twin.named_parameters()}
    buf = {n: torch.zeros_like(p) for n, p in twin.named_parameters()}
    keep = {n: mask[n].double() for n in names}
    loaders = _loaders(D, L, bs)
    for name, random_labels in (("forget", True), ("retain", False)):
        for b in loaders[name]:
            batch = L.to_device(b, cpu)
            rand = source(batch["image"].shape[0],
                          random_labels=random_labels)
            img = L.augment(batch["image"].double() / 255.0,
                            rand["offsets"], rand["flips"])
            label = rand["labels"] if random_labels else batch["label"]
            twin.train()
            logits = twin(img)
            ll = torch.log_softmax(logits, dim=-1)
            nll = -ll.gather(-1, label.long()[:, None])[:, 0]
            w = batch["weight"].double()
            loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
            grads = torch.autograd.grad(loss, list(twin.parameters()))
            with torch.no_grad():
                for n, p, g in zip(names, twin.parameters(), grads):
                    b_new = (0.9 * buf[n] + g * keep[n]) + 5e-4 * p
                    p_new = p - LR * b_new
                    on = keep[n] > 0
                    p.copy_(torch.where(on, p_new, theta0[n]))
                    buf[n] = torch.where(on, b_new, torch.zeros_like(b_new))
    return {k: v.double().numpy() for k, v in twin.state_dict().items()}


def worst(a: dict, b: dict, theta0: dict) -> tuple:
    """The worst tensor's max|a − b| / max|b − θ₀| and its name."""
    out = (0.0, "")
    for n, w in b.items():
        if n.endswith("num_batches_tracked"):
            continue
        moved = np.abs(w - theta0[n]).max()
        out = max(out, (float(np.abs(a[n] - w).max() / moved), n))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=None)
    ap.add_argument("--jax-only", choices=["32", "64", "64c"], default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--to", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.jax_only:
        run_jax(args.batch, args.jax_only != "32", args.to,
                keep_casts=args.jax_only == "64c")
        return

    import torch

    torch.set_num_threads(1)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for bits in ("32", "64", "64c"):
            path = os.path.join(tmp, f"jax{bits}.npz")
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            subprocess.run([sys.executable, __file__, "--batch",
                            str(args.batch), "--jax-only", bits, "--to",
                            path], check=True, env=env, cwd=ROOT)
            runs[f"jax{bits}"] = dict(np.load(path))
    runs["port32"] = run_torch(args.batch, False)
    runs["ref64"] = run_torch(args.batch, True)

    from _torch_port import port_twin

    _, params, stats, _ = _setup(False)
    theta0 = {k: v.double().numpy() for k, v in
              port_twin("resnet20s", params, stats).state_dict().items()}
    pairs = [("jax64", "ref64"), ("port32", "ref64"), ("jax32", "ref64"),
             ("jax32", "jax64"), ("port32", "jax64"), ("port32", "jax32"),
             ("jax64c", "ref64"), ("jax32", "jax64c")]
    result = {"batch": args.batch}
    for a, b in pairs:
        frac, name = worst(runs[a], runs[b], theta0)
        result[f"{a} vs {b}"] = {"worst_fraction": frac, "tensor": name}
        print(f"{a} vs {b}: worst tensor {name}: {frac:.3e} of the distance "
              f"{b} moved")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
