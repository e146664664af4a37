"""SD concept-erasure trainers, the SalUn part: counterpart of
``salun/sd/trainers.py``.

- :func:`sd_generate_mask` (SD/train-scripts/generate_mask.py:8-211):
  |Σ∇| over U-Net parameters of −MSE(noise, (1+g)·e_c − g·e_∅) on the
  forget images, accumulated in fp32, exact global top-k
  (``salun_torch.core.mask``), uint8 masks.
- :func:`make_random_label_step` (random_label.py:13-156), uncached: the
  remain ``shared_step`` plus MSE(out, pseudo.detach()) with two
  independent posterior draws of the same forget images sharing t and
  noise; total = forget + α·remain; grads masked (``with_mask``), Adam over
  the ``train_method`` subset (:func:`make_sd_optimizer`).

Parameter names are CompVis's (``input_blocks.4.1...``). Random draws are
injected (``draws``) or come from a ``torch.Generator`` in the order of
JAX's keys. Gradient ascent, nsfw_removal, proximal, ESD and the cached
step are not ported yet (ROADMAP queue 1, slice D).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from salun_torch.core.mask import generate_masks
from salun_torch.core.masked_opt import mask_grads

from .clip_text import tokenize
from .ldm import SDModules

NOT_PORTED = "ROADMAP queue 1, slice D"


# ------------------------------------------------------- trainable subsets


def _subset_pred(train_method: str):
    """Name predicate for each train_method (train-esd.py:205-236), over
    CompVis U-Net parameter names."""

    def pred(name: str) -> bool:
        if train_method == "full":
            return True
        if train_method == "xattn":
            return "attn2" in name
        if train_method == "selfattn":
            return "attn1" in name
        if train_method == "noxattn":
            return not (name.startswith("out.") or "attn2" in name
                        or "time_embed" in name)
        if train_method == "notime":
            return not (name.startswith("out.") or "time_embed" in name)
        if train_method == "xlayer":
            return "attn2" in name and (
                name.startswith(("output_blocks.6.", "output_blocks.8.")))
        if train_method == "selflayer":
            return "attn1" in name and (
                name.startswith(("input_blocks.4.", "input_blocks.7.")))
        raise ValueError(train_method)

    return pred


def trainable_mask(unet: torch.nn.Module, train_method: str) -> dict:
    """``{name: bool}``: which U-Net parameters train."""
    pred = _subset_pred(train_method)
    return {n: pred(n) for n, _ in unet.named_parameters()}


class SDOptimizer:
    """Adam over the ``train_method`` subset (random_label.py:46-56), with
    the saliency grad mask (random_label.py:132-137) applied first.

    Frozen parameters are not given to Adam: they get no update and no
    moments, and their grads are never kept. A coordinate whose grad the
    mask zeroes on every step keeps m = v = 0, so its update is exactly 0:
    it stays bitwise at θ₀.
    """

    def __init__(self, unet: torch.nn.Module, lr: float,
                 train_method: str = "full", mask: Optional[dict] = None):
        which = trainable_mask(unet, train_method)
        named = dict(unet.named_parameters())
        for n, p in named.items():
            p.requires_grad_(which[n])
        self.names = [n for n in named if which[n]]
        self.params = [named[n] for n in self.names]
        self.mask = None
        if mask is not None:
            missing = set(named) - set(mask)
            if missing:
                raise KeyError(f"the mask misses {sorted(missing)[:5]}")
            self.mask = [mask[n].to(named[n].device) for n in self.names]
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
        self.adam = torch.optim.Adam(self.params, lr=lr)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        if self.mask is not None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
            for p, g in zip(self.params, mask_grads(grads, self.mask)):
                p.grad = g
        self.adam.step()


def make_sd_optimizer(unet, lr: float, train_method: str = "full"):
    """Adam over the selected subset, without a mask."""
    return SDOptimizer(unet, lr, train_method)


def with_mask(unet, lr: float, train_method: str, mask: Optional[dict]):
    """The optimizer with the saliency grad mask (``{name: 0/1}``, CompVis
    names) applied before Adam; ``mask=None`` is :func:`make_sd_optimizer`."""
    return SDOptimizer(unet, lr, train_method, mask)


# ----------------------------------------------------------- mask gen


def sd_generate_mask(sd: SDModules, forget_images: torch.Tensor, prompts,
                     *, guidance: float = 7.5, batch_size: int = 4,
                     thresholds=(0.5,), prompt_ids=None, null_ids=None,
                     draws: Optional[Sequence[dict]] = None,
                     generator: Optional[torch.Generator] = None) -> dict:
    """Saliency over U-Net parameters from loss = −MSE(noise, CFG eps)
    (generate_mask.py:34-108) over batches of ``forget_images`` ([−1, 1],
    NCHW), thresholded by exact global top-k.

    ``draws[i]`` may carry the i-th batch's ``posterior``, ``t`` and
    ``noise`` (NCHW); missing ones come from ``generator`` in that order
    (JAX's k1, k2, k3). Returns ``{threshold: {name: uint8 0/1 tensor}}``.
    """
    device = sd.device
    max_len = sd.clip.cfg.max_length
    ids_c = torch.as_tensor(tokenize(prompts, max_len)
                            if prompt_ids is None else prompt_ids)
    ids_u = torch.as_tensor(tokenize([""] * len(prompts), max_len)
                            if null_ids is None else null_ids)
    names = [n for n, _ in sd.unet.named_parameters()]
    params = [p for _, p in sd.unet.named_parameters()]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=device)
           for p in params]
    n = len(forget_images)
    for k, i in enumerate(range(0, n, batch_size)):
        given = draws[k] if draws is not None else {}
        imgs = forget_images[i:i + batch_size].to(device)
        m = imgs.shape[0]
        z0 = sd.encode_image(imgs, given.get("posterior"), generator)
        ctx_c = sd.encode_text(ids_c[i:i + m] if len(ids_c) == n
                               else ids_c[:m])
        ctx_u = sd.encode_text(ids_u[:m])
        t = given.get("t")
        t = sd.draw_t(m, generator) if t is None else t.to(device).long()
        noise = given.get("noise")
        noise = (torch.randn(z0.shape, generator=generator, device=device)
                 if noise is None else noise.to(device))
        z_t = sd.q_sample(z0, t, noise)
        e2 = sd.apply_model(torch.cat([z_t, z_t]), torch.cat([t, t]),
                            torch.cat([ctx_c, ctx_u]))
        eps = (1 + guidance) * e2[:m] - guidance * e2[m:]
        loss = -(noise - eps).square().mean()
        for a, g in zip(acc, torch.autograd.grad(loss, params)):
            a.add_(g.to(torch.float32))
    masks = generate_masks([a.abs_() for a in acc], thresholds)
    return {t: {name: m.to(torch.uint8) for name, m in zip(names, ms)}
            for t, ms in masks.items()}


# ----------------------------------------------------------- RL


def random_label_loss(sd: SDModules, batch: dict, alpha: float = 0.5, *,
                      draws: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None):
    """forget + α·remain (random_label.py:66-143, trainers.py:230-265).

    ``batch``: ``forget_images``, ``remain_images`` ([−1, 1], NCHW),
    ``forget_ids``, ``pseudo_ids``, ``remain_ids``. ``draws`` may carry
    ``remain_posterior``, ``remain_t``, ``remain_noise``,
    ``forget_posterior``, ``forget_t``, ``forget_noise`` and
    ``pseudo_posterior``; missing ones come from ``generator`` in JAX's
    key order (k1 → the remain step's three, then k2, k3, k4, k5).
    """
    d = draws or {}
    device = sd.device
    remain_loss = sd.shared_step(
        batch["remain_images"], batch["remain_ids"],
        posterior=d.get("remain_posterior"), t=d.get("remain_t"),
        noise=d.get("remain_noise"), generator=generator)
    # the reference calls get_input twice on the same forget images
    # (random_label.py:104-109): two independent posterior draws feed the
    # forget and pseudo forwards, which share t and the q_sample noise
    forget = batch["forget_images"]
    z_f = sd.encode_image(forget, d.get("forget_posterior"), generator)
    t = d.get("forget_t")
    t = (sd.draw_t(z_f.shape[0], generator) if t is None
         else t.to(device).long())
    noise = d.get("forget_noise")
    noise = (torch.randn(z_f.shape, generator=generator, device=device)
             if noise is None else noise.to(device))
    z_p = sd.encode_image(forget, d.get("pseudo_posterior"), generator)
    ctx_f = sd.encode_text(batch["forget_ids"])
    ctx_p = sd.encode_text(batch["pseudo_ids"])
    out = sd.apply_model(sd.q_sample(z_f, t, noise), t, ctx_f)
    with torch.no_grad():
        pseudo = sd.apply_model(sd.q_sample(z_p, t, noise), t, ctx_p)
    return (out - pseudo).square().mean() + alpha * remain_loss


def make_random_label_step(sd: SDModules, optimizer: SDOptimizer,
                           alpha: float = 0.5, cached=False):
    """One SalUn step: loss, backward, grad mask, Adam. ``step(batch,
    generator=None, draws=None)`` returns the loss (a device tensor)."""
    if cached:
        raise NotImplementedError(
            f"the cached random_label step is not ported yet ({NOT_PORTED}: "
            f"--cache_vae_moments)")

    def step(batch, generator=None, draws=None):
        optimizer.zero_grad()
        loss = random_label_loss(sd, batch, alpha, draws=draws,
                                 generator=generator)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _not_ported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet ({NOT_PORTED})")

    fn.__name__ = name
    return fn


make_gradient_ascent_step = _not_ported("gradient_ascent")
make_nsfw_removal_step = _not_ported("nsfw_removal")
proximal_shrink = _not_ported("proximal (kth_largest_threshold)")
make_esd_step = _not_ported("esd")
