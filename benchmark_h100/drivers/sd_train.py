"""SalUn's SD unlearning step: the saliency mask in set-up, then masked
random-label steps (``salun_torch.sd.trainers``).

Set-up makes the weights, draws the forget images, builds the mask with
``sd_generate_mask`` (timed as ``mask_s``), builds ``with_mask`` and the
step of ``make_random_label_step``, and drives that step through its
first ``checked_steps`` steps; the window drives the same step on. Each
step gets a fresh batch and fresh draws, made on the device from
(seed, step), and injected as the step's ``draws``.

The check works out again, with the plain reference in fp32 (TF32 off),
the mask, the losses of the checked steps, the first step's masked
gradient and the parameters' change over the checked steps, from the same
seed, and compares:

- ``mask_mismatch``: the share of U-Net weights whose mask bit differs;
- ``loss_gap``: the first step's |loss − reference| / |reference|;
- ``grad_gap``: ‖g − g_ref‖ / ‖g_ref‖ over the weights whose mask bits
  agree, g the first step's gradient as Adam got it (its first moment /
  (1 − β₁));
- ``change_gap``: the worst leaf's gap of ‖θ − θ₀‖ after the checked
  steps.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark_h100.harness import compare, synth, training, weights
from benchmark_h100.reference import ops, sd_v1

from . import sd_common


class Driver(training.TrainingDriver):
    def __init__(self, cfg: dict, traffic: dict, limits: dict, seed: int,
                 device):
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.seed, self.device = int(seed), torch.device(device)
        self.timings = {}
        t = traffic
        self.bf, self.br = t["forget_batch"], t["remain_batch"]
        self.size = t["image_size"]
        self.latent = self.size // 8

    # ----------------------------------------------------------- inputs

    def class_ids(self):
        """One prompt per class, drawn from the seed."""
        gen = synth.generator(self.seed, "class_prompts", device=self.device)
        return synth.prompt_ids(gen, self.traffic["classes"], self.device,
                                self.cfg["clip"]["max_length"])

    def mask_batches(self):
        """The forget images of mask generation in batches, each with its
        posterior, t and noise draws."""
        n, b, z = self.traffic["mask_images"], self.bf, self.cfg["vae"][
            "z_channels"]
        for k in range(0, n, b):
            gen = synth.generator(self.seed, "mask", k, device=self.device)
            m = min(b, n - k)
            shape = (m, z, self.latent, self.latent)
            images = synth.sd_images(gen, m, self.size, self.device)
            yield images, {
                "posterior": torch.randn(shape, generator=gen,
                                         device=self.device),
                "t": torch.randint(0, self.cfg["schedule"]["timesteps"],
                                   (m,), generator=gen, device=self.device),
                "noise": torch.randn(shape, generator=gen,
                                     device=self.device)}

    def step_inputs(self, i: int, class_ids):
        """Step ``i``'s batch and draws: the pseudo and remain classes
        drawn on the host (no wait on the device), the rest on it."""
        gen = synth.generator(self.seed, "step", i, device=self.device)
        dev, T = self.device, self.cfg["schedule"]["timesteps"]
        classes = self.traffic["classes"]
        forget = self.traffic["forget_class"]
        rng = np.random.default_rng(synth.tag_seed(self.seed, "classes", i))
        pseudo = (forget + int(rng.integers(1, classes))) % classes
        remain_cls = (forget + rng.integers(1, classes, self.br)) % classes
        batch = {
            "forget_images": synth.sd_images(gen, self.bf, self.size, dev),
            "remain_images": synth.sd_images(gen, self.br, self.size, dev),
            "forget_ids": class_ids[forget].expand(self.bf, -1),
            "pseudo_ids": class_ids[pseudo].expand(self.bf, -1),
            "remain_ids": torch.stack([class_ids[int(c)]
                                       for c in remain_cls])}
        z = self.cfg["vae"]["z_channels"]

        def normal(n):
            return torch.randn((n, z, self.latent, self.latent),
                               generator=gen, device=dev)

        draws = {"remain_posterior": normal(self.br),
                 "remain_t": torch.randint(0, T, (self.br,), generator=gen,
                                           device=dev),
                 "remain_noise": normal(self.br),
                 "forget_posterior": normal(self.bf),
                 "forget_t": torch.randint(0, T, (self.bf,), generator=gen,
                                           device=dev),
                 "forget_noise": normal(self.bf),
                 "pseudo_posterior": normal(self.bf)}
        return batch, draws

    # ----------------------------------------------------------- set-up

    def setup(self, sync) -> None:
        import time

        from salun_torch.sd.trainers import (make_random_label_step,
                                             sd_generate_mask, with_mask)
        from salun_torch.utils.device import set_tf32

        set_tf32(bool(self.cfg["precision"]["tf32"]))
        self.sd = sd_common.build_program(self.cfg, self.device, self.seed)
        self.ids = self.class_ids()
        null = synth.null_ids(self.bf, self.device,
                              self.cfg["clip"]["max_length"])
        forget = self.traffic["forget_class"]
        batches = list(self.mask_batches())
        images = torch.cat([b[0] for b in batches])
        draws = [b[1] for b in batches]
        del batches
        sync()
        t0 = time.perf_counter()
        masks = sd_generate_mask(
            self.sd, images, None, guidance=self.traffic["mask_guidance"],
            batch_size=self.bf, thresholds=(self.traffic["threshold"],),
            prompt_ids=self.ids[forget].expand(len(images), -1),
            null_ids=null, draws=draws)
        sync()
        self.timings["mask_s"] = time.perf_counter() - t0
        del images, draws
        mask = masks[self.traffic["threshold"]]
        del masks
        self.optimizer = with_mask(self.sd.unet, self.traffic["lr"],
                                   self.traffic["train_method"], mask)
        self.mask_host = {n: m.to("cpu", torch.bool) for n, m in
                          mask.items()}
        del mask
        gc.collect()
        self.step = make_random_label_step(self.sd, self.optimizer,
                                           alpha=self.traffic["alpha"])
        self.losses = []
        for i in range(self.traffic["checked_steps"]):
            batch, draws = self.step_inputs(i, self.ids)
            self.losses.append(self.step(batch, draws=draws))
            if i == 0:
                self.read_first_step()
        self.read_change()
        self.losses = [float(x) for x in self.losses]
        self.next = self.traffic["checked_steps"]

    def model_under_test(self):
        return self.sd.unet

    def adams(self) -> list:
        return list(self.optimizer.adams)

    def start_leaves(self, model):
        return weights.leaves(model, self.seed, sd_common.STREAMS["unet"],
                              self.device)

    # ----------------------------------------------------------- window

    def unit(self):
        """One step; returns (rows, loss)."""
        batch, draws = self.step_inputs(self.next, self.ids)
        self.next += 1
        return self.bf + self.br, self.step(batch, draws=draws)

    def work(self):
        """One step's work: three VAE encodes and three text encodes of a
        batch, the remain and forget U-Net forwards with their backwards,
        and the pseudo forward without."""
        ref = sd_common.meta_reference(self.cfg)
        b = self.bf
        return (sd_common.encode_work(ref, self.cfg, b, self.size).times(3)
                + sd_common.text_work(ref, self.cfg, b).times(3)
                + sd_common.unet_work(ref, self.cfg, b, self.latent,
                                      True).times(2)
                + sd_common.unet_work(ref, self.cfg, b, self.latent, False))

    def release(self) -> None:
        del self.step, self.optimizer, self.sd
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- check

    def reference(self, autocast: bool = False, mask=None,
                  fault: str = "") -> dict:
        """The reference's readings (``training.reference_steps``), from
        the seed alone; ``autocast`` runs its matrix products
        in bfloat16. ``mask`` ({leaf: bool}) skips the mask's pass;
        ``fault`` plants one in the steps: ``half_batch`` (half of each
        batch left out) or ``answer_altered``
        (:func:`compare.alter_first_row` on the U-Net)."""
        dev = self.device
        ref = sd_common.build_reference(self.cfg, dev, self.seed)
        sched = ref.schedule(dev)
        unet = ref.unet.requires_grad_(True)
        params = [p for _, p in unet.named_parameters()]
        names = [n for n, _ in unet.named_parameters()]
        ids = self.class_ids()
        amp = torch.autocast(dev.type, dtype=torch.bfloat16,
                             enabled=autocast)
        if mask is None:
            mask = self.reference_mask(ref, sched, params, ids, amp)
        else:
            mask = [mask[n] for n in names]
        hook = (unet.register_forward_hook(
            compare.alter_first_row)
            if fault == "answer_altered" else None)
        adam = ops.Adam(params, self.traffic["lr"])

        def step_grads(i):
            batch, draws = self.step_inputs(i, ids)
            if fault == "half_batch":
                h = self.bf // 2
                batch = {k: v[:h] for k, v in batch.items()}
                draws = {k: v[:h] for k, v in draws.items()}
            total, grads = 0.0, None
            for part in sd_v1.random_label_parts(ref, sched, batch, draws,
                                                 self.traffic["alpha"]):
                with amp, torch.enable_grad():
                    loss = part()
                    g = torch.autograd.grad(loss, params)
                total += float(loss.detach())
                grads = (list(g) if grads is None
                         else [a.add_(b) for a, b in zip(grads, g)])
                del g, loss
            return total, [g.float() for g in grads]

        out = training.reference_steps(
            unet, mask, adam, step_grads, self.traffic["checked_steps"],
            self.start_leaves(unet))
        if hook is not None:
            hook.remove()
        return out

    def reference_mask(self, ref, sched, params, ids, amp) -> list:
        """The saliency mask of the reference, one bool tensor a leaf."""
        forget = self.traffic["forget_class"]
        null = synth.null_ids(self.bf, self.device,
                              self.cfg["clip"]["max_length"])
        acc = [torch.zeros_like(p) for p in params]
        for images, draws in self.mask_batches():
            m = len(images)
            with amp, torch.enable_grad():
                loss = sd_v1.saliency_loss(
                    ref, sched, images, ids[forget].expand(m, -1),
                    null[:m], draws, self.traffic["mask_guidance"])
                grads = torch.autograd.grad(loss, params)
            for a, g in zip(acc, grads):
                a.add_(g.float())
            del grads, loss
        mask = ops.top_fraction_mask([a.abs_() for a in acc],
                                     self.traffic["threshold"])
        del acc
        gc.collect()
        return mask
