"""SD concept-erasure trainers: counterpart of ``salun/sd/trainers.py``.

- :func:`sd_generate_mask` (SD/train-scripts/generate_mask.py:8-211):
  |Σ∇| over U-Net parameters of −MSE(noise, (1+g)·e_c − g·e_∅) on the
  forget images, accumulated in fp32, exact global top-k
  (``salun_torch.core.mask``), uint8 masks.
- :func:`make_random_label_step` (random_label.py:13-156): the remain
  ``shared_step`` plus MSE(out, pseudo.detach()) with two independent
  posterior draws of the same forget images sharing t and noise; total =
  forget + α·remain; grads masked (``with_mask``), Adam over the
  ``train_method`` subset (:func:`make_sd_optimizer`). ``cached="forget"``
  or ``"all"`` reads VAE posterior moments and CLIP contexts precomputed
  by :func:`make_cache_batch_fn` instead of re-encoding: the same draws in
  the same order, so the same loss to float rounding.
  ``make_nsfw_removal_step`` is the same step (nsfw_removal.py:83-104).
- :func:`make_gradient_ascent_step` (gradient_ascent.py:14-121):
  −shared_step(forget) + α·shared_step(remain).
- :func:`proximal_ratio` and :func:`proximal_shrink`
  (proximal_gradient.py:144-180): after each step a global soft threshold
  of the U-Net toward θ_init, τ the exact k-th value of |θ − θ₀|.
- :func:`make_esd_step` (train-esd.py:270-311): the student denoises to
  z_t under CFG, a frozen copy of the U-Net (the teacher) gives the target
  e₀ − g·(e_p − e₀), and the student's e_n on the erased prompt is fit to
  it.

Parameter names are CompVis's (``input_blocks.4.1...``). Random draws are
injected (``draws``) or come from a ``torch.Generator`` in the order of
JAX's keys.

Under a ``--dp`` mesh (``salun_torch.dist.context``) a step and each
mask-generation batch keep this rank's rows of the batch and of the draws
(drawn for the global batch), divide by the global batch, and sum the
U-Net's gradients over the ranks: the step before the grad mask and Adam,
mask generation once before ``|·|``. ESD's batch-1 chain stays whole on
every rank.

Under ``--fsdp`` the U-Net is sharded (``salun_torch.dist.fsdp``) before
the optimizer is built: Adam's moments and the mask take each parameter's
placement, FSDP sums the sharded gradients (:meth:`SDOptimizer.backward`),
and proximal's τ is the sharded exact k-th value.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch

from salun_torch.core.mask import generate_masks
from salun_torch.core.masked_opt import mask_grads
from salun_torch.diffusion.sampling import _seq_pairs, ldm_uniform_timesteps
from salun_torch.dist import context as dist_ctx
from salun_torch.dist import fsdp
from salun_torch.dist.topk import kth_largest, kth_largest_sharded
from salun_torch.utils.metrics import span

from .clip_text import tokenize
from .ldm import SDModules


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

    On an FSDP-sharded U-Net the mask takes each parameter's placement, and
    the sharded parameters and the ones FSDP left whole get an Adam each
    (``torch.optim``'s foreach kernels take no mix of the two; the update
    is elementwise either way).
    """

    def __init__(self, unet: torch.nn.Module, lr: float,
                 train_method: str = "full", mask: Optional[dict] = None):
        which = trainable_mask(unet, train_method)
        named = dict(unet.named_parameters())
        for n, p in named.items():
            p.requires_grad_(which[n])
        self.module = unet
        self.names = [n for n in named if which[n]]
        self.params = [named[n] for n in self.names]
        self.mask = None
        if mask is not None:
            missing = set(named) - set(mask)
            if missing:
                raise KeyError(f"the mask misses {sorted(missing)[:5]}")
            self.mask = [fsdp.place_like(mask[n], named[n])
                         for n in self.names]
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
        whole = fsdp.replicated_params(self.params)
        sharded = [p for p in self.params if fsdp.is_sharded(p)]
        self.adams = [torch.optim.Adam(group, lr=lr)
                      for group in (sharded, whole) if group]

    def zero_grad(self) -> None:
        for adam in self.adams:
            adam.zero_grad(set_to_none=True)

    def backward(self, loss: torch.Tensor, sharded: bool) -> None:
        """``loss.backward()`` and the gradients' sum over the ranks when
        ``sharded`` (each rank computed its rows of the batch): FSDP sums
        the sharded parameters' in its reduce-scatters, an all-reduce the
        rest. A batch that stays whole leaves every rank with the whole
        gradient (FSDP divides its sum by the rank count)."""
        mesh = dist_ctx.active_mesh()
        if mesh is not None:
            fsdp.set_grad_sum(self.module, 1.0 if sharded else mesh.data)
        loss.backward()
        if sharded:
            dist_ctx.all_reduce_grads(fsdp.replicated_params(self.params))

    @torch.no_grad()
    def step(self) -> None:
        if self.mask is not None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
            for p, g in zip(self.params, mask_grads(grads, self.mask)):
                p.grad = g
        for adam in self.adams:
            adam.step()

    def state(self) -> dict:
        """``{"unet": {name: parameter}, "adam": {name: {"exp_avg",
        "exp_avg_sq", "step"}}}``: the trained state in each tensor's own
        placement, for ``salun_torch.ckpt.save_sharded``."""
        adam = {}
        for n, p in zip(self.names, self.params):
            for opt in self.adams:
                if p in opt.state:
                    adam[n] = dict(opt.state[p])
        return {"unet": dict(zip(self.names, self.params)), "adam": adam}


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
        with span("mask.grad"):
            given = draws[k] if draws is not None else {}
            imgs = forget_images[i:i + batch_size].to(device)
            m = imgs.shape[0]
            ids = (ids_c[i:i + m] if len(ids_c) == n else ids_c[:m],
                   ids_u[:m])
            imgs, given, (id_c, id_u) = dist_ctx.ingest((imgs, given, ids))
            with dist_ctx.sharded(m):
                z0 = sd.encode_image(imgs, given.get("posterior"), generator)
                ctx_c, ctx_u = sd.encode_text(id_c), sd.encode_text(id_u)
                b = z0.shape[0]
                t = given.get("t")
                t = (sd.draw_t(b, generator) if t is None
                     else t.to(device).long())
                noise = given.get("noise")
                noise = (dist_ctx.randn(z0.shape, generator=generator,
                                        device=device)
                         if noise is None else noise.to(device))
            z_t = sd.q_sample(z0, t, noise)
            e2 = sd.apply_model(torch.cat([z_t, z_t]), torch.cat([t, t]),
                                torch.cat([ctx_c, ctx_u]))
            eps = (1 + guidance) * e2[:b] - guidance * e2[b:]
            loss = -(noise - eps).square().mean() * dist_ctx.share(m)
            grads = torch.autograd.grad(loss, params)
            if dist_ctx.skips(m):
                continue  # a whole batch counts once, on rank 0
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32))
    dist_ctx.all_reduce_(acc)
    masks = generate_masks([a.abs_() for a in acc], thresholds)
    return {t: {name: m.to(torch.uint8) for name, m in zip(names, ms)}
            for t, ms in masks.items()}


# ----------------------------------------------------------- RL / GA


def _draw(given, shape, generator, device, low=None, high=None):
    """An injected draw on ``device``, or a fresh one from ``generator``:
    normal, or integers in [low, high) when ``low`` is given."""
    if given is not None:
        given = torch.as_tensor(given).to(device)
        return given if low is None else given.long()
    if low is None:
        return dist_ctx.randn(shape, generator=generator, device=device)
    return dist_ctx.randint(low, high, shape, generator=generator,
                            device=device)


def _cached_mode(cached) -> str:
    return {True: "all", False: ""}.get(cached, cached)


def make_cache_batch_fn(sd: SDModules, mode: str = "all"):
    """``cache(batch)``: the frozen stages of a random_label batch computed
    once (trainers.py:177-209): the forget images' VAE posterior moments
    and the forget and pseudo prompts' CLIP contexts; with ``mode="all"``
    the remain side's too, with ``"forget"`` the remain images and ids
    pass through raw. The result feeds ``make_random_label_step(...,
    cached=mode)``."""

    @torch.no_grad()
    def cache(batch: dict) -> dict:
        out = {"forget_moments": sd.encode_image_moments(
                   batch["forget_images"]),
               "forget_ctx": sd.encode_text(batch["forget_ids"]),
               "pseudo_ctx": sd.encode_text(batch["pseudo_ids"])}
        if mode == "all":
            out["remain_moments"] = sd.encode_image_moments(
                batch["remain_images"])
            out["remain_ctx"] = sd.encode_text(batch["remain_ids"])
        else:
            out["remain_images"] = batch["remain_images"]
            out["remain_ids"] = batch["remain_ids"]
        return out

    return cache


def random_label_loss(sd: SDModules, batch: dict, alpha: float = 0.5, *,
                      cached=False, draws: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None):
    """forget + α·remain (random_label.py:66-143, trainers.py:230-265).

    ``batch``: ``forget_images``, ``remain_images`` ([−1, 1], NCHW),
    ``forget_ids``, ``pseudo_ids``, ``remain_ids``; cached, the fields of
    :func:`make_cache_batch_fn`. ``draws`` may carry ``remain_posterior``,
    ``remain_t``, ``remain_noise``, ``forget_posterior``, ``forget_t``,
    ``forget_noise`` and ``pseudo_posterior``; missing ones come from
    ``generator`` in JAX's key order (k1 → the remain step's three, then
    k2, k3, k4, k5), cached or not.
    """
    d = draws or {}
    device = sd.device
    cached = _cached_mode(cached)
    remain_draws = dict(posterior=d.get("remain_posterior"),
                        t=d.get("remain_t"), noise=d.get("remain_noise"),
                        generator=generator)
    if cached == "all":
        remain_loss = sd.shared_step_cached(
            batch["remain_moments"], batch["remain_ctx"], **remain_draws)
    else:
        remain_loss = sd.shared_step(batch["remain_images"],
                                     batch["remain_ids"], **remain_draws)
    # the reference calls get_input twice on the same forget images
    # (random_label.py:104-109): two independent posterior draws feed the
    # forget and pseudo forwards, which share t and the q_sample noise
    if cached:
        moments = batch["forget_moments"]
        shape = moments[0].shape
        z_f = sd.latent_from_moments(moments, _draw(
            d.get("forget_posterior"), shape, generator, device))
    else:
        z_f = sd.encode_image(batch["forget_images"],
                              d.get("forget_posterior"), generator)
    t = _draw(d.get("forget_t"), (z_f.shape[0],), generator, device, 0,
              sd.schedule.num_timesteps)
    noise = _draw(d.get("forget_noise"), z_f.shape, generator, device)
    if cached:
        z_p = sd.latent_from_moments(moments, _draw(
            d.get("pseudo_posterior"), shape, generator, device))
        ctx_f, ctx_p = batch["forget_ctx"], batch["pseudo_ctx"]
    else:
        z_p = sd.encode_image(batch["forget_images"],
                              d.get("pseudo_posterior"), generator)
        ctx_f = sd.encode_text(batch["forget_ids"])
        ctx_p = sd.encode_text(batch["pseudo_ids"])
    out = sd.apply_model(sd.q_sample(z_f, t, noise), t, ctx_f)
    with torch.no_grad():
        pseudo = sd.apply_model(sd.q_sample(z_p, t, noise), t, ctx_p)
    return (out - pseudo).square().mean() + alpha * remain_loss


def gradient_ascent_loss(sd: SDModules, batch: dict, alpha: float = 0.5, *,
                         draws: Optional[dict] = None,
                         generator: Optional[torch.Generator] = None):
    """−shared_step(forget) + α·shared_step(remain) (gradient_ascent.py:
    14-121). ``draws`` may carry ``forget_posterior``, ``forget_t``,
    ``forget_noise`` and the ``remain_`` three; missing ones come from
    ``generator``, the forget step's first (JAX's k1, then k2)."""
    d = draws or {}

    def step(side):
        return sd.shared_step(
            batch[f"{side}_images"], batch[f"{side}_ids"],
            posterior=d.get(f"{side}_posterior"), t=d.get(f"{side}_t"),
            noise=d.get(f"{side}_noise"), generator=generator)

    forget = step("forget")
    return -forget + alpha * step("remain")


def _batch_rows(batch) -> int:
    """The leading dimension of a batch's first array."""
    leaf = next(iter(batch.values()))
    while isinstance(leaf, (tuple, list)):
        leaf = leaf[0]
    return len(leaf)


def _make_step(loss_fn, optimizer: SDOptimizer):
    """``step(batch, generator=None, draws=None)``: loss, backward, grad
    mask, Adam; on ``--dp`` shards this rank's rows of the batch and of
    the (global) draws, the gradients and the loss summed over the ranks
    before the mask."""
    def step(batch, generator=None, draws=None):
        n = _batch_rows(batch)
        with span("step", rows=n):
            with span("step.zero_grad"):
                optimizer.zero_grad()
            batch, draws = dist_ctx.ingest((batch, draws))
            with span("step.forward"), dist_ctx.sharded(n):
                loss = loss_fn(batch, draws, generator) * dist_ctx.share(n)
            sharded = dist_ctx.rows(n) is not None
            with span("step.backward"):
                optimizer.backward(loss, sharded)
                loss = loss.detach()
                if sharded:
                    (loss,) = dist_ctx.sum_scalars(loss)
                    loss = loss.to(torch.float32)
            with span("step.optimizer"):
                optimizer.step()
        return loss

    return step


def make_random_label_step(sd: SDModules, optimizer: SDOptimizer,
                           alpha: float = 0.5, cached=False):
    """One SalUn step: loss, backward, grad mask, Adam. ``step(batch,
    generator=None, draws=None)`` returns the loss (a device tensor).
    ``cached``: False (re-encode every step, the reference's recompute),
    ``"forget"`` or ``"all"``/True (batches from
    :func:`make_cache_batch_fn`)."""
    return _make_step(lambda b, d, g: random_label_loss(
        sd, b, alpha, cached=cached, draws=d, generator=g), optimizer)


def make_gradient_ascent_step(sd: SDModules, optimizer: SDOptimizer,
                              alpha: float = 0.5):
    """One gradient-ascent step, masked like :func:`make_random_label_step`
    (``step(batch, generator=None, draws=None)``)."""
    return _make_step(lambda b, d, g: gradient_ascent_loss(
        sd, b, alpha, draws=d, generator=g), optimizer)


# nsfw_removal = random_label with the fixed prompt pair (nsfw_removal.py:
# 83-104)
make_nsfw_removal_step = make_random_label_step


# ----------------------------------------------------------- proximal


def proximal_ratio(mask_ratio: float, epoch: int, step_in_epoch: int,
                   n_forget_batches: int, n_remain_batches: int,
                   epochs: int, n_total_params: int) -> int:
    """The reference's decaying shrink count (proximal_gradient.py:
    144-150): ``int(mask_ratio · (total − cur)/total · n_params)`` with
    ``total = epochs·(forget + remain batches)``, a counter that advances
    per forget batch, and ``n_params`` the whole LatentDiffusion's (U-Net,
    VAE and CLIP)."""
    total = epochs * (n_forget_batches + n_remain_batches)
    cur = epoch * (n_forget_batches + n_remain_batches) + step_in_epoch + 1
    return int(mask_ratio * ((total - cur) / total) * n_total_params)


@torch.no_grad()
def proximal_shrink(params: Sequence[torch.Tensor],
                    theta_init: Sequence[torch.Tensor],
                    ratio: int) -> torch.Tensor:
    """Global soft threshold toward θ_init, in place (proximal_gradient.py:
    144-180): τ is the ``ratio``-th smallest |θ − θ₀| over every tensor
    (the exact (n − ratio + 1)-th largest, ``dist.topk.kth_largest``);
    entries with |θ − θ₀| ≤ τ are set to θ₀ exactly, the others move by
    −sign(θ − θ₀)·τ. Returns τ.

    The reference ranks over the whole model, where the frozen VAE and
    CLIP contribute zero diffs at the bottom: pass ``ratio = ratio_full −
    n_frozen``. ``ratio < 1`` means τ = 0 there, which changes nothing;
    callers skip the shrink then.

    FSDP-sharded parameters (and their θ₀) are read and written shard by
    shard: τ is then ``kth_largest_sharded`` over the ``data`` axis, each
    whole parameter counted once, and ``n`` stays the whole model's."""
    n = sum(p.numel() for p in params)
    k = max(n - int(ratio) + 1, 1)
    if any(fsdp.is_sharded(p) for p in params):
        mesh = dist_ctx.active_mesh()
        pieces = [(a - b).abs_() for a, b in zip(
            fsdp.local_pieces(params, mesh),
            fsdp.local_pieces(theta_init, mesh))]
        tau = kth_largest_sharded(pieces, k, group=mesh.group)
        del pieces
    else:
        flat = torch.empty(n, dtype=torch.float32, device=params[0].device)
        o = 0
        for p, t0 in zip(params, theta_init):
            m = p.numel()
            torch.sub(p.reshape(-1), t0.reshape(-1), out=flat[o:o + m])
            o += m
        tau = kth_largest(flat.abs_(), k)
        del flat
    for p, t0 in zip(params, theta_init):
        p, t0 = fsdp.local(p), fsdp.local(t0)
        d = (p - t0).to(torch.float32)
        moved = p.to(torch.float32) - torch.sign(d) * tau
        p.copy_(torch.where(d.abs() > tau, moved, t0.to(torch.float32)))
    return tau


# ----------------------------------------------------------- ESD


def esd_bucket(t_enc: int, ddim_steps: int, num_timesteps: int):
    """(og, og_lim): the DDPM timesteps of DDIM step ``t_enc``'s bucket,
    ``round((t_enc/ddim_steps)·T)`` in fp32 with Python's half-to-even
    rounding (train-esd.py:279-282; ``torch.round`` is half-to-even)."""
    t = torch.tensor([t_enc, t_enc + 1], dtype=torch.float32)
    og, og_lim = torch.round(t / ddim_steps * num_timesteps).to(
        torch.int64).tolist()
    return og, og_lim


def partial_denoise(sd: SDModules, ctx, t_enc: int, ddim_steps: int,
                    image_size: int, guidance: float, ctx_0, *,
                    z=None, generator=None):
    """Denoise from T down to DDIM step ``t_enc`` (quick_sample_till_t,
    train-esd.py:240-252; trainers.py:403-449) under CFG against
    ``ctx_0``: the fork's grid (ldm's +1-shifted grid without its last
    entry) with ᾱ₀ at the boundary; the steps run down to grid index
    ``t_enc − 1``, and ``t_enc = 0`` runs the whole chain. ``z`` (NCHW) is
    injected or drawn from ``generator``."""
    T = sd.schedule.num_timesteps
    step_size = T // ddim_steps
    seq = ldm_uniform_timesteps(T, ddim_steps)[:-1]
    if z is None:
        z = sd.initial_latents(ctx.shape[0], image_size, generator)
    z = z.to(sd.device, torch.float32)
    eps_fn = sd.cfg_eps_fn(ctx, ctx_0, guidance)
    final_ab = float(sd.schedule.alphas_cumprod[0])
    with torch.no_grad():
        for t, t_next in _seq_pairs(seq):
            if t < 1 + (t_enc - 1) * step_size:
                break  # every later grid point is lower
            z = sd.ddim_transition(eps_fn, z, t, t_next, final_ab)
    return z


def frozen_copy(unet: torch.nn.Module) -> torch.nn.Module:
    """ESD's teacher: a copy of the U-Net with gradients off, outside any
    optimizer and mask."""
    return copy.deepcopy(unet).requires_grad_(False).eval()


def make_esd_step(sd: SDModules, optimizer: SDOptimizer,
                  teacher: torch.nn.Module, negative_guidance: float = 1.0,
                  start_guidance: float = 3.0, ddim_steps: int = 50,
                  image_size: int = 64):
    """ESD step (train-esd.py:270-311). ``step(ctx_p, ctx_0, ctx_n,
    generator=None, draws=None)``: ``t_enc`` in [0, ddim_steps), then
    ``t_ddpm`` in [og, max(og_lim, og + 1)) (:func:`esd_bucket`), then the
    initial ``z`` of the partial chain; each injected or drawn from
    ``generator`` in that order (JAX's k1, k2, k3). Returns the loss and
    ``t_enc`` (which sets how many chain steps ran)."""
    T = sd.schedule.num_timesteps
    device = sd.device

    def step(ctx_p, ctx_0, ctx_n, generator=None, draws=None):
        d = draws or {}
        t_enc = int(_draw(d.get("t_enc"), (1,), generator, device, 0,
                          ddim_steps).reshape(-1)[0])
        og, og_lim = esd_bucket(t_enc, ddim_steps, T)
        t_ddpm = _draw(d.get("t_ddpm"), (1,), generator, device, og,
                       max(og_lim, og + 1))
        z = partial_denoise(sd, ctx_p, t_enc, ddim_steps, image_size,
                            start_guidance, ctx_0, z=d.get("z"),
                            generator=generator)
        t_f = t_ddpm.to(torch.float32)
        with torch.no_grad():
            e_0 = teacher(z, t_f, ctx_0)
            e_p = teacher(z, t_f, ctx_p)
            target = e_0 - negative_guidance * (e_p - e_0)
        optimizer.zero_grad()
        loss = (sd.apply_model(z, t_ddpm, ctx_n) - target).square().mean()
        optimizer.backward(loss, sharded=False)  # the whole chain each rank
        optimizer.step()
        return loss.detach(), t_enc

    return step
