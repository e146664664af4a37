"""DDPM workload runner (counterpart of ``salun/diffusion/runner.py``;
reference DDPM/runners/diffusion.py): the ``train``/``retrain`` step with
EMA, the Selective-Amnesia ``forget`` step and the diagonal FIM it needs,
mask generation from the CFG-scaled eps loss, the ``saliency_unlearn``
step (``rl`` | ``ga``), per-class sampling, the class grid and the
denoising trajectory.

The model is an ``nn.Module`` the methods take as an argument (JAX threads
``params``). Random draws (flips, timesteps, noise, cond-drop, dropout)
come from an explicit ``torch.Generator`` or are injected, which is how
the tests replay JAX's key chain.

Under a ``--dp`` mesh (``salun_torch.dist.context``) each loss draws for
the global batch, then runs the model on this rank's rows (the model's own
draws are the global batch's, sliced) and divides by the global batch;
the step sums the gradients over the ranks before the clip, mask
generation sums each batch's before its clip, and the FIM sums once at
the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from salun_torch.core.mask import generate_masks
from salun_torch.core.masked_opt import clip_by_global_norm, mask_grads
from salun_torch.data.ddpm_data import random_hflip
from salun_torch.data.loader import to_float
from salun_torch.dist import context as dist_ctx
from salun_torch.utils.metrics import span

from .ema import ema_init, ema_update
from .losses import eps_mse
from .sampling import sample_image
from .schedules import (DiffusionSchedule, antithetic_timesteps,
                        data_transform, q_sample)
from .unet import ConditionalUNet, UNetConfig, cfg_eps, init_unet


@dataclass
class DDPMTrainConfig:
    """The training/optim blocks of the reference YAMLs
    (DDPM/configs/*.yml)."""

    n_iters: int = 1000
    batch_size: int = 128
    lr: float = 2e-4
    beta1: float = 0.9
    eps: float = 1e-8
    grad_clip: float = 1.0
    ema: bool = False
    ema_rate: float = 0.9999
    alpha: float = 1.0           # forget vs remain weight (saliency_unlearn)
    method: str = "rl"           # ga | rl
    label_to_forget: int = 0
    cond_scale: float = 2.0
    gamma: float = 1.0           # train_forget remember weight
    lmbda: float = 100.0         # train_forget EWC weight
    snapshot_freq: int = 1000
    log_freq: int = 100
    cond_drop_prob: float = 0.1
    # data.random_flip: the train-side loaders' RandomHorizontalFlip
    # (DDPM/datasets/__init__.py:34-46)
    random_flip: bool = True


class DDPMOptimizer:
    """The optax chain of ``make_optimizer`` (``runner.py:66-74``), in its
    order: clip by global norm on the unmasked grads, then ``g *= mask``,
    then Adam(lr, β₁, β₂ = 0.999, eps).

    Adam is ``torch.optim.Adam``: the same update as optax's, rounded at
    other places (a few ulp of the update). A coordinate whose grad is
    always 0 keeps m = v = 0, so its update is exactly 0: masked-out
    weights stay bitwise at θ₀.
    """

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 cfg: DDPMTrainConfig,
                 mask: Optional[Sequence[torch.Tensor]] = None):
        self.params = list(params)
        self.grad_clip = cfg.grad_clip
        self.mask = None
        if mask is not None:
            self.mask = [m.to(p.device, p.dtype)
                         for m, p in zip(mask, self.params, strict=True)]
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr,
                                     betas=(cfg.beta1, 0.999), eps=cfg.eps)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        grads = clip_by_global_norm(grads, self.grad_clip)
        if self.mask is not None:
            grads = mask_grads(grads, self.mask)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()


def make_optimizer(model: torch.nn.Module, cfg: DDPMTrainConfig,
                   mask: Optional[dict] = None) -> DDPMOptimizer:
    """Adam + global-norm clip, with the optional grad mask
    (``{param name: 0/1 tensor}``, the reference ``.pt`` format)."""
    names = [n for n, _ in model.named_parameters()]
    if mask is not None and set(mask) != set(names):
        raise KeyError(f"the mask does not cover the model's parameters: "
                       f"missing {sorted(set(names) - set(mask))[:5]}, "
                       f"extra {sorted(set(mask) - set(names))[:5]}")
    return DDPMOptimizer(model.parameters(), cfg,
                         None if mask is None else [mask[n] for n in names])


def _batch_images(batch: dict, device) -> tuple:
    """Host batch (``image`` NHWC uint8 or [0,1] float, ``label``) → (float
    NCHW images in [0,1], int64 labels) on device."""
    with span("step.inputs"):
        img = torch.from_numpy(np.ascontiguousarray(batch["image"]))
        label = torch.from_numpy(np.asarray(batch["label"], np.int64))
        return (to_float(img.to(device).permute(0, 3, 1, 2).contiguous()),
                label.to(device))


def saliency_from_eps_loss(eps_fn, params: Sequence[torch.Tensor],
                           batches, schedule: DiffusionSchedule, device, *,
                           grad_clip: float, thresholds=(0.5,),
                           random_flip: bool = False,
                           generator: Optional[torch.Generator] = None):
    """The reference's DDPM mask-generation loop (diffusion.py:959-1039):
    per batch, antithetic t, q_sample, ``eps_fn``, ``loss = (e − eps)²
    .sum(pixels).mean(batch)``; the grads clipped by global norm BEFORE
    they are summed into an fp32 accumulator (diffusion.py:986-991); then
    |·| and the exact global top-k of ``salun_torch.core.mask``.

    Returns ``{threshold: [mask per param]}``. A batch may carry ``t``,
    ``e`` (NCHW) and ``flips`` to replay fixed draws; missing ones come
    from ``generator`` (flips, then t, then e). On a ``--dp`` shard each
    batch's gradient is summed over the ranks before its clip.
    """
    T = schedule.num_timesteps
    params = list(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params]
    for batch in batches:
        with span("mask.grad"):
            x, c = _batch_images(batch, device)
            n = x.shape[0]
            if random_flip:
                x = random_hflip(x, batch.get("flips"), generator=generator)
            t = batch.get("t")
            t = (antithetic_timesteps(n, T, generator=generator,
                                      device=device)
                 if t is None else torch.as_tensor(t).to(device).long())
            e = batch.get("e")
            e = (torch.randn(x.shape, generator=generator, device=device)
                 if e is None
                 else torch.as_tensor(e).to(device, torch.float32))
            xt = q_sample(data_transform(x), t, e, schedule)
            xt, t, c, e = dist_ctx.ingest((xt, t, c, e))
            loss = eps_mse(e, eps_fn(xt, t, c)) * dist_ctx.share(n)
            grads = torch.autograd.grad(loss, params)
            if dist_ctx.rows(n) is not None:
                dist_ctx.all_reduce_(grads)
            grads = clip_by_global_norm(grads, grad_clip)
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32))
    return generate_masks([a.abs_() for a in acc], thresholds)


class DDPMRunner:
    def __init__(self, unet_cfg: UNetConfig, schedule: DiffusionSchedule,
                 train_cfg: DDPMTrainConfig, device="cpu"):
        self.unet_cfg = unet_cfg
        self.device = torch.device(device)
        self.schedule = schedule.to(self.device)
        self.cfg = train_cfg

    def init(self, seed: int) -> ConditionalUNet:
        """A U-Net with seeded random weights, on the runner's device."""
        return init_unet(ConditionalUNet(self.unet_cfg), seed).to(self.device)

    # ------------------------------------------------------------ losses

    def _eps_loss(self, model, x01, c, t, e, generator,
                  cond_drop_prob: Optional[float] = None):
        """Conditional eps-MSE on [0,1] images in train mode
        (losses.py:21-37): to [−1,1], q_sample, predict with the train
        config's cond-drop rate (or ``cond_drop_prob``), sum of squares."""
        xt = q_sample(data_transform(x01), t, e, self.schedule)
        p_drop = (self.cfg.cond_drop_prob if cond_drop_prob is None
                  else cond_drop_prob)
        n = xt.shape[0]
        xt, t, c, e = dist_ctx.ingest((xt, t, c, e))
        with dist_ctx.sharded(n):
            out = model(xt, t.float(), c, train=True,
                        cond_drop_prob=p_drop, generator=generator)
        return eps_mse(e, out) * dist_ctx.share(n)

    def _stepper(self, model, optimizer: DDPMOptimizer, loss_fn,
                 n_batches: int):
        """``step(*batches, generator=None, draws=None)`` over
        ``n_batches`` batches (the generator may follow them
        positionally): loss, backward, clip (→ grad mask) → Adam, then the
        EMA when the config sets ``ema`` (``step.shadow``, ``{name:
        tensor}``); returns the loss (a device tensor). On ``--dp`` shards
        the gradients and the loss are summed over the ranks before the
        clip."""
        shadow = ema_init(model) if self.cfg.ema else None

        def step(*args, generator=None, draws=None):
            batches, rest = args[:n_batches], args[n_batches:]
            if rest:
                (generator,) = rest
            sharded = dist_ctx.step_sharded(*(len(b["label"])
                                              for b in batches))
            with span("step", rows=sum(len(b["label"]) for b in batches)):
                with span("step.zero_grad"):
                    optimizer.zero_grad()
                with span("step.forward"):
                    loss = loss_fn(model, *batches, generator=generator,
                                   draws=draws)
                with span("step.backward"):
                    loss.backward()
                    if sharded:
                        dist_ctx.all_reduce_grads(optimizer.params)
                        (loss,) = dist_ctx.sum_scalars(loss.detach())
                        loss = loss.to(torch.float32)
                with span("step.optimizer"):
                    optimizer.step()
                if shadow is not None:
                    ema_update(model, shadow, self.cfg.ema_rate)
            return loss.detach()

        step.shadow = shadow
        return step

    # ------------------------------------------------------------ train

    def train_loss(self, model, batch: dict, *,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None):
        """The conditional training loss (diffusion.py:194-270): flip,
        antithetic t, noise, eps-MSE at the config's cond-drop rate.
        ``draws`` injects any of ``flips``, ``t`` and ``e`` (NCHW)."""
        x, c = _batch_images(batch, self.device)
        x, t, e = self._draws(x, generator, draws)
        return self._eps_loss(model, x, c, t, e, generator)

    def make_train_step(self, model, optimizer: DDPMOptimizer):
        """One training step: ``step(batch, generator=None, draws=None)``
        (see :meth:`_stepper`)."""
        return self._stepper(model, optimizer, self.train_loss, 1)

    # ------------------------------------------------ saliency_unlearn

    def _draws(self, x, generator, given: Optional[dict]):
        """Flips, t and e for one half of the step: ``given`` entries
        first, the rest from ``generator`` in that order."""
        given = given or {}
        n = x.shape[0]
        flips = given.get("flips")
        if self.cfg.random_flip:
            x = random_hflip(x, flips, generator=generator)
        t = given.get("t")
        t = (antithetic_timesteps(n, self.schedule.num_timesteps,
                                  generator=generator, device=x.device)
             if t is None else t.to(x.device).long())
        e = given.get("e")
        e = (torch.randn(x.shape, generator=generator, device=x.device)
             if e is None else e.to(x.device, torch.float32))
        return x, t, e

    def unlearn_loss(self, model, remain: dict, forget: dict, *,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[dict] = None):
        """forget + α·remain (diffusion.py:519-595).

        ``ga``: forget = −eps-MSE. ``rl``: forget = mean over all elements
        of ``(pseudo − out)²``, where ``pseudo`` is the prediction for the
        pseudo class (label_to_forget + 1), without gradient. As in JAX,
        where both forwards share one ``rngs`` dict, ``out`` and
        ``pseudo`` see the same cond-drop and dropout masks: the generator
        state is replayed for the ``pseudo`` forward (without a
        ``generator``, the step seeds one of its own).

        ``draws`` injects ``{"remain": {...}, "forget": {...}}`` with any
        of ``flips``, ``t`` and ``e`` (NCHW).
        """
        cfg, ucfg = self.cfg, self.unet_cfg
        if generator is None:  # a generator of its own, so rl can replay it
            generator = torch.Generator(device=self.device)
            generator.seed()
        draws = draws or {}
        dr, df = draws.get("remain", {}), draws.get("forget", {})
        x_r, c_r = _batch_images(remain, self.device)
        x_r, t_r, e_r = self._draws(x_r, generator, dr)
        remain_loss = self._eps_loss(model, x_r, c_r, t_r, e_r, generator)

        x_f, c_f = _batch_images(forget, self.device)
        x_f, t_f, e_f = self._draws(x_f, generator, df)
        if cfg.method == "ga":
            forget_loss = -self._eps_loss(model, x_f, c_f, t_f, e_f,
                                          generator)
        elif cfg.method == "rl":
            xt = q_sample(data_transform(x_f), t_f, e_f, self.schedule)
            n = xt.shape[0]
            xt, tf, c_f = dist_ctx.ingest((xt, t_f.float(), c_f))
            with dist_ctx.sharded(n):
                # the model config's cond-drop rate, as JAX's model.apply
                state = generator.get_state()
                out = model(xt, tf, c_f, train=True, generator=generator)
                generator.set_state(state)
                pseudo_c = torch.full_like(c_f, (cfg.label_to_forget + 1)
                                           % ucfg.n_classes)
                with torch.no_grad():
                    pseudo = model(xt, tf, pseudo_c, train=True,
                                   generator=generator)
            forget_loss = (pseudo - out).square().mean() * dist_ctx.share(n)
        else:
            raise NotImplementedError(cfg.method)
        return forget_loss + cfg.alpha * remain_loss

    def make_saliency_unlearn_step(self, model, optimizer: DDPMOptimizer):
        """One SalUn step: ``step(remain, forget, generator=None,
        draws=None)`` (see :meth:`_stepper`)."""
        return self._stepper(model, optimizer, self.unlearn_loss, 2)

    # ------------------------------------------------ train_forget (SA)

    def forget_loss(self, model, remember: dict, fisher: Sequence[torch.Tensor],
                    theta_mle: Sequence[torch.Tensor], *,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[dict] = None):
        """The Selective-Amnesia loss (diffusion.py:273-396): eps-MSE on
        uniform-noise images labelled with the forgotten class, plus
        γ·eps-MSE on the remember batch, both at one shared antithetic t
        and cond-drop 0, plus λ·Σ F∘(θ − θ_mle)². ``fisher`` and
        ``theta_mle`` follow ``model.parameters()``.

        Draws in order (each injectable through ``draws``): ``flips``,
        ``t``, ``x_forget`` (uniform [0,1], NCHW), ``e_forget``,
        ``e_remember``; then the forget forward's dropout, then the
        remember forward's.
        """
        cfg = self.cfg
        draws = draws or {}
        x_r, c_r = _batch_images(remember, self.device)
        n = x_r.shape[0]
        if cfg.random_flip:
            x_r = random_hflip(x_r, draws.get("flips"), generator=generator)

        def draw(name, fn):
            given = draws.get(name)
            return fn() if given is None else given.to(self.device)

        t = draw("t", lambda: antithetic_timesteps(
            n, self.schedule.num_timesteps, generator=generator,
            device=self.device)).long()
        x_f = draw("x_forget", lambda: torch.rand(
            x_r.shape, generator=generator, device=self.device)).float()
        e_f = draw("e_forget", lambda: torch.randn(
            x_r.shape, generator=generator, device=self.device)).float()
        e_r = draw("e_remember", lambda: torch.randn(
            x_r.shape, generator=generator, device=self.device)).float()
        c_f = torch.full_like(c_r, cfg.label_to_forget)
        l_forget = self._eps_loss(model, x_f, c_f, t, e_f, generator, 0.0)
        l_rem = self._eps_loss(model, x_r, c_r, t, e_r, generator, 0.0)
        ewc = sum((f * (p - p0).square()).sum()
                  for f, p, p0 in zip(fisher, model.parameters(), theta_mle,
                                      strict=True))
        # every rank computes the penalty whole: 1/N of it each on shards
        ewc = ewc * dist_ctx.whole_share(n)
        return l_forget + cfg.gamma * l_rem + cfg.lmbda * ewc

    def make_train_forget_step(self, model, optimizer: DDPMOptimizer,
                               fisher: Sequence[torch.Tensor],
                               theta_mle: Sequence[torch.Tensor]):
        """One SA step: ``step(remember, generator=None, draws=None)`` (see
        :meth:`_stepper`)."""
        fisher = [f.to(self.device) for f in fisher]
        theta_mle = [p.detach().to(self.device) for p in theta_mle]

        def loss_fn(model, remember, *, generator=None, draws=None):
            return self.forget_loss(model, remember, fisher, theta_mle,
                                    generator=generator, draws=draws)

        return self._stepper(model, optimizer, loss_fn, 1)

    # ------------------------------------------------ FIM

    def compute_fim(self, model, batches, *, n_timestep_samples: int = 16,
                    generator: Optional[torch.Generator] = None) -> dict:
        """Diagonal FIM (diffusion.py:101-191): the mean over samples and
        timesteps of the squared per-sample gradients of the conditional
        eps loss (eval mode, cond-drop 0), ``{param name: tensor}``.

        Per batch: flips, then t ``[n, n_timestep_samples]`` uniform in
        [0, T), then noise ``[n_timestep_samples, n, C, H, W]`` (each
        injectable as the batch's ``flips``, ``t``, ``e``); then for each
        timestep sample one ``vmap(grad)`` over the whole batch, squared
        and summed into an fp32 accumulator. The attention inside runs K2
        and K3a/K3b once a site for the whole vmapped batch. On ``--dp``
        shards each rank takes its rows of every batch's draws (rank 0 a
        batch that does not divide) and the sums are added over the ranks
        once, at the end.
        """
        from torch.func import functional_call, grad, vmap

        T = self.schedule.num_timesteps
        names = [n for n, _ in model.named_parameters()]
        params = {n: p.detach() for n, p in model.named_parameters()}
        buffers = dict(model.named_buffers())

        def one_loss(params, x01, c, t, e):
            xt = q_sample(data_transform(x01[None]), t[None], e[None],
                          self.schedule)
            out = functional_call(model, (params, buffers),
                                  (xt, t[None].float(), c[None]),
                                  {"train": False, "cond_drop_prob": 0.0})
            return (e[None] - out).square().sum()

        per_sample = vmap(grad(one_loss), in_dims=(None, 0, 0, 0, 0))
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
        total = 0
        for batch in batches:
            x, c = _batch_images(batch, self.device)
            n = x.shape[0]
            if self.cfg.random_flip:
                x = random_hflip(x, batch.get("flips"), generator=generator)
            ts = batch.get("t")
            ts = (torch.randint(0, T, (n, n_timestep_samples),
                                generator=generator, device=self.device)
                  if ts is None else torch.as_tensor(ts).to(self.device))
            es = batch.get("e")
            es = (torch.randn((n_timestep_samples,) + tuple(x.shape),
                              generator=generator, device=self.device)
                  if es is None else torch.as_tensor(es).to(self.device,
                                                             torch.float32))
            total += n * n_timestep_samples
            if dist_ctx.skips(n):
                continue
            x, c, ts = dist_ctx.ingest((x, c, ts))
            es = dist_ctx.ingest(es, dim=1)
            for i in range(n_timestep_samples):
                g = per_sample(params, x, c, ts[:, i].long(), es[i])
                for name in names:
                    acc[name].add_(g[name].square().sum(0))
        dist_ctx.all_reduce_([acc[name] for name in names])
        return {name: a / total for name, a in acc.items()}

    # ------------------------------------------------ generate_mask

    def generate_mask(self, model, forget_batches, *, thresholds=(0.5,),
                      generator: Optional[torch.Generator] = None) -> dict:
        """Saliency from the CFG-scaled eps loss on the forget class
        (diffusion.py:959-1001), thresholded by exact global top-k.
        Returns ``{threshold: {param name: 0/1 fp32 tensor}}``."""
        cond_scale = self.cfg.cond_scale
        names = [n for n, _ in model.named_parameters()]

        def eps_fn(xt, t, c):
            return cfg_eps(model, xt, t.float(), c, cond_scale)

        masks = saliency_from_eps_loss(
            eps_fn, model.parameters(), forget_batches, self.schedule,
            self.device, grad_clip=self.cfg.grad_clip, thresholds=thresholds,
            random_flip=self.cfg.random_flip, generator=generator)
        return {t: dict(zip(names, m)) for t, m in masks.items()}

    # ------------------------------------------------ sampling

    def sample_classes(self, model, *, classes, n_per_class: int,
                       cond_scale: Optional[float] = None,
                       sample_type: str = "generalized",
                       timesteps: Optional[int] = None, eta: float = 0.0,
                       generator: Optional[torch.Generator] = None):
        """Per-class sampling (diffusion.py sample_classes/sample_fid).
        Returns images in [0,1], NCHW, ``len(classes)·n_per_class`` of
        them, class by class."""
        cond_scale = self.cfg.cond_scale if cond_scale is None else cond_scale
        ucfg = self.unet_cfg
        outs = []
        for c in classes:
            labels = torch.full((n_per_class,), int(c), dtype=torch.long,
                                device=self.device)
            x = sample_image(model, self.schedule, batch=n_per_class,
                             image_size=ucfg.image_size,
                             channels=ucfg.in_channels, classes=labels,
                             cond_scale=cond_scale, sample_type=sample_type,
                             timesteps=timesteps, eta=eta,
                             generator=generator)
            outs.append((x + 1.0) / 2.0)
        return torch.clamp(torch.cat(outs), 0.0, 1.0)

    def sample_visualization(self, model, n_per_class: int = 10,
                             cond_scale: Optional[float] = None,
                             timesteps: Optional[int] = None,
                             generator: Optional[torch.Generator] = None):
        """Class-grid snapshot (diffusion.py:877-931): ``n_per_class``
        images of every class, class by class, in [0,1], NCHW."""
        return self.sample_classes(
            model, classes=range(self.unet_cfg.n_classes),
            n_per_class=n_per_class, cond_scale=cond_scale,
            timesteps=timesteps, generator=generator)

    def sample_trajectory(self, model, *, classes,
                          cond_scale: Optional[float] = None,
                          sample_type: str = "generalized",
                          timesteps: Optional[int] = None, eta: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          x_T: Optional[torch.Tensor] = None, noise=None):
        """The per-step denoising chain of one batch, one image per entry
        of ``classes`` (denoising.py:31,93): ``(xs, x0_preds)`` in [0,1],
        each ``[steps, B, C, H, W]``."""
        cond_scale = self.cfg.cond_scale if cond_scale is None else cond_scale
        ucfg = self.unet_cfg
        labels = torch.as_tensor(list(classes), dtype=torch.long,
                                 device=self.device)
        _, xs, x0s = sample_image(
            model, self.schedule, batch=labels.shape[0],
            image_size=ucfg.image_size, channels=ucfg.in_channels,
            classes=labels, cond_scale=cond_scale, sample_type=sample_type,
            timesteps=timesteps, eta=eta, generator=generator, x_T=x_T,
            noise=noise, return_trajectory=True)
        return (torch.clamp((xs + 1.0) / 2.0, 0.0, 1.0),
                torch.clamp((x0s + 1.0) / 2.0, 0.0, 1.0))
