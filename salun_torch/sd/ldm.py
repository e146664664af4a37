"""LatentDiffusion, the SD v1 wrapper of U-Net, VAE and CLIP: counterpart
of ``salun/sd/ldm.py``.

The used subset of SD/ldm/models/diffusion/ddpm.py: ``register_schedule``
(ldm "linear" = √-space linspace), ``get_input`` (VAE encode × 0.18215 and
CLIP encode, ddpm.py:913-973), ``q_sample``, ``apply_model``,
``p_losses``/``shared_step`` (ddpm.py:1093-1096, 1286-1319) and its form
on cached posterior moments and contexts, DDIM and PLMS sampling with
classifier-free guidance (ldm/models/diffusion/ddim.py, plms.py,
SD/eval-scripts/generate-images.py) and ESD's partial chain that stops at
a timestep (train-esd.py:240-291).

:class:`SDModules` holds the three ``nn.Module``s (JAX threads a params
dict). The VAE and CLIP are frozen: they run under ``torch.no_grad()``
with ``requires_grad`` off. Random draws (VAE posterior noise, t, noise,
initial latents) are injected or come from an explicit
``torch.Generator``, in JAX's order of keys. Latents and images are NCHW.
On a shard of a ``--dp`` batch (``salun_torch.dist.context.sharded``) the
draws are the global batch's, sliced; :meth:`SDModules.sample` draws the
initial latents whole, runs its rows of the chain on each rank and returns
the whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from salun_torch.diffusion.sampling import (generalized_steps,
                                            ldm_uniform_timesteps, plms_steps)
from salun_torch.diffusion.schedules import DiffusionSchedule
from salun_torch.dist import context as dist_ctx

from .clip_text import CLIPTextConfig, CLIPTextModel, tokenize
from .unet import SDUNet, SDUNetConfig
from .vae import AutoencoderKL, VAEConfig


def sd_schedule(num_timesteps: int = 1000, linear_start: float = 0.00085,
                linear_end: float = 0.012) -> DiffusionSchedule:
    """ldm 'linear' schedule = linspace in √β space (util.py:21-45): the
    DDPM 'quad' schedule with SD's endpoints."""
    return DiffusionSchedule.create(
        beta_schedule="quad", beta_start=linear_start, beta_end=linear_end,
        num_diffusion_timesteps=num_timesteps, var_type="fixedsmall")


def _randn(shape, generator, device):
    return dist_ctx.randn(shape, generator=generator, device=device)


@dataclass
class SDModules:
    unet: SDUNet
    vae: AutoencoderKL
    clip: CLIPTextModel
    schedule: DiffusionSchedule
    scale_factor: float = 0.18215

    @classmethod
    def create(cls, unet_cfg: Optional[SDUNetConfig] = None,
               vae_cfg: Optional[VAEConfig] = None,
               clip_cfg: Optional[CLIPTextConfig] = None,
               num_timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.012, device="cpu",
               seed: Optional[int] = None) -> "SDModules":
        """The three modules built on ``device`` (PyTorch's default init,
        seeded by ``seed`` when given), VAE and CLIP frozen."""
        vae_cfg = vae_cfg or VAEConfig()
        if seed is not None:
            torch.manual_seed(seed)
        with torch.device(device):
            unet = SDUNet(unet_cfg or SDUNetConfig())
            vae = AutoencoderKL(vae_cfg)
            clip = CLIPTextModel(clip_cfg or CLIPTextConfig())
        for frozen in (vae, clip):
            frozen.requires_grad_(False).eval()
        return cls(unet, vae, clip,
                   sd_schedule(num_timesteps, linear_start,
                               linear_end).to(device),
                   vae_cfg.scale_factor)

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    # ------------------------------------------------------------ stages

    @torch.no_grad()
    def encode_text(self, input_ids) -> torch.Tensor:
        """Frozen CLIP context (ddpm.py get_learned_conditioning)."""
        ids = torch.as_tensor(input_ids, device=self.device)
        return self.clip(ids)

    @torch.no_grad()
    def encode_image_moments(self, images):
        """[−1, 1] NCHW images → posterior (mean, logvar)."""
        return self.vae.encode_moments(images)

    def latent_from_moments(self, moments, noise) -> torch.Tensor:
        """Scaled posterior draw ``(mean + exp(logvar/2)·noise)·0.18215``."""
        mean, logvar = moments
        return (mean + torch.exp(0.5 * logvar) * noise) * self.scale_factor

    def encode_image(self, images, noise=None, generator=None):
        """get_input (ddpm.py:913-973): the scaled latent sample; the
        posterior's standard-normal draw ``noise`` is injected or drawn
        from ``generator``."""
        moments = self.encode_image_moments(images)
        if noise is None:
            noise = _randn(moments[0].shape, generator, self.device)
        return self.latent_from_moments(moments, noise.to(self.device))

    @torch.no_grad()
    def decode_latent(self, z):
        return self.vae.decode(z / self.scale_factor)

    def apply_model(self, z_t, t, context):
        """eps prediction (DiffusionWrapper crossattn path, ddpm.py:1961)."""
        return self.unet(z_t, t.to(torch.float32), context)

    def q_sample(self, z0, t, noise):
        a = self.schedule.alphas_cumprod[t.long()].reshape(-1, 1, 1, 1)
        return torch.sqrt(a) * z0 + torch.sqrt(1.0 - a) * noise

    # ------------------------------------------------------------ losses

    def p_losses(self, z0, context, t, noise):
        """loss_simple: per-sample mean eps MSE, batch mean
        (ddpm.py:1286-1319, l_simple_weight 1, elbo weight 0)."""
        out = self.apply_model(self.q_sample(z0, t, noise), t, context)
        return (noise - out).square().mean(dim=(1, 2, 3)).mean()

    def draw_t(self, n, generator=None):
        return dist_ctx.randint(0, self.schedule.num_timesteps, (n,),
                                generator=generator, device=self.device)

    def shared_step(self, images, input_ids, *, posterior=None, t=None,
                    noise=None, generator=None):
        """get_input + p_losses (ddpm.py:1093-1096). Draws not given come
        from ``generator`` in JAX's key order: posterior, t, noise."""
        return self.shared_step_cached(
            self.encode_image_moments(images), self.encode_text(input_ids),
            posterior=posterior, t=t, noise=noise, generator=generator)

    def shared_step_cached(self, moments, context, *, posterior=None,
                           t=None, noise=None, generator=None):
        """``shared_step`` from cached posterior moments and CLIP context:
        the same draws in the same order, so the same loss."""
        if posterior is None:
            posterior = _randn(moments[0].shape, generator, self.device)
        z0 = self.latent_from_moments(moments, posterior.to(self.device))
        t = self.draw_t(z0.shape[0], generator) if t is None else t
        if noise is None:
            noise = _randn(z0.shape, generator, self.device)
        return self.p_losses(z0, context, t.to(self.device).long(),
                             noise.to(self.device))

    # ------------------------------------------------------------ sampling

    def cfg_eps_fn(self, cond_ctx, uncond_ctx, guidance: float):
        """One forward of the doubled batch (cond, then uncond), combined
        as e_∅ + g·(e_c − e_∅)."""
        ctx = torch.cat([cond_ctx, uncond_ctx])

        def eps_fn(z, t):
            b = z.shape[0]
            e2 = self.apply_model(torch.cat([z, z]), torch.cat([t, t]), ctx)
            e_c, e_u = e2[:b], e2[b:]
            return e_u + guidance * (e_c - e_u)

        return eps_fn

    def initial_latents(self, n: int, image_size: int, generator=None):
        """The z a sampling chain starts from: [n, z_channels, s, s]."""
        zc = self.vae.cfg.z_channels
        return _randn((n, zc, image_size, image_size), generator,
                      self.device)

    @torch.no_grad()
    def sample(self, prompts, *, negative_prompts=None, guidance: float = 7.5,
               steps: int = 50, image_size: int = 64, eta: float = 0.0,
               return_latents: bool = False, sampler: str = "ddim",
               generator=None, initial_latents=None):
        """Text → images in [0, 1], NCHW, by DDIM or PLMS with CFG against
        ``negative_prompts`` (the empty prompt by default; ddim.py /
        plms.py / generate-images.py), ᾱ₀ at the boundary. DDIM walks the
        ldm grid without its last entry (the fork's DDIMSampler,
        ddim.py:224), PLMS the whole grid (plms.py:190-216). With
        ``return_latents`` the final latents, undecoded."""
        if sampler not in ("ddim", "plms"):
            raise ValueError(f"unknown sampler {sampler!r}")
        n = len(prompts)
        max_len = self.clip.cfg.max_length
        z = (self.initial_latents(n, image_size, generator)
             if initial_latents is None
             else initial_latents.to(self.device, torch.float32))
        ids_c = tokenize(prompts, max_len)
        ids_u = tokenize(negative_prompts or [""] * n, max_len)
        z, ids_c, ids_u = dist_ctx.constrain_batch((z, ids_c, ids_u))
        ctx_c, ctx_u = self.encode_text(ids_c), self.encode_text(ids_u)
        seq = ldm_uniform_timesteps(self.schedule.num_timesteps, steps)
        if sampler == "ddim":
            seq = seq[:-1]
        final_ab = float(self.schedule.alphas_cumprod[0])
        eps_fn = self.cfg_eps_fn(ctx_c, ctx_u, guidance)
        with dist_ctx.sharded(n):
            if sampler == "plms":
                z, _ = plms_steps(eps_fn, z, seq, self.schedule,
                                  final_alpha_bar=final_ab)
            else:
                z, _ = generalized_steps(eps_fn, z, seq, self.schedule,
                                         eta=eta, generator=generator,
                                         final_alpha_bar=final_ab)
        if return_latents:
            return dist_ctx.gather_rows(z, n)
        img = self.decode_latent(z)
        return dist_ctx.gather_rows(torch.clamp((img + 1.0) / 2.0, 0.0, 1.0),
                                    n)

    def ddim_transition(self, eps_fn, z, t: int, t_next: int,
                        final_alpha_bar: float):
        """One deterministic DDIM step t → t_next (ᾱ at t_next = −1 is
        ``final_alpha_bar``)."""
        n = z.shape[0]
        sched = self.schedule
        tt = torch.full((n,), t, dtype=torch.long, device=self.device)
        at = sched.alpha_bar(tt).reshape(-1, 1, 1, 1)
        if t_next < 0:
            at_next = torch.full_like(at, final_alpha_bar)
        else:
            at_next = sched.alpha_bar(torch.full_like(tt, t_next)).reshape(
                -1, 1, 1, 1)
        et = eps_fn(z, tt.to(torch.float32))
        x0_t = (z - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
        return torch.sqrt(at_next) * x0_t + torch.sqrt(1.0 - at_next) * et

    @torch.no_grad()
    def partial_sample_latent(self, ctx, *, t_target: int, steps: int,
                              image_size: int, guidance: float = 0.0,
                              uncond_ctx=None, generator=None,
                              initial_latents=None):
        """Denoise from noise down to (not through) timestep ``t_target``
        (quick_sample_till_t, train-esd.py:240-291; ddim.py:280-281): the
        transitions seq[k] → seq[k−1] of the fork's DDIM grid (ldm's
        +1-shifted grid without its last entry) over the points at or
        above ``t_target``, so the chain stops on the lowest of them. With
        ``guidance`` and ``uncond_ctx`` each eps is CFG-combined."""
        seq = [s for s in ldm_uniform_timesteps(
            self.schedule.num_timesteps, steps)[:-1] if s >= t_target]
        z = (self.initial_latents(ctx.shape[0], image_size, generator)
             if initial_latents is None
             else initial_latents.to(self.device, torch.float32))
        if len(seq) < 2:  # nothing above the target: pure noise
            return z
        if guidance and uncond_ctx is not None:
            eps_fn = self.cfg_eps_fn(ctx, uncond_ctx, guidance)
        else:
            def eps_fn(zz, tt):
                return self.apply_model(zz, tt, ctx)
        for t, t_next in zip(reversed(seq[1:]), reversed(seq[:-1])):
            z = self.ddim_transition(eps_fn, z, t, t_next, 1.0)
        return z
