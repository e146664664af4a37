"""SalUn's DDPM unlearning step: the saliency mask in set-up, then the
``rl`` saliency_unlearn steps of ``salun_torch.diffusion.runner``.

Set-up makes the weights and the synthetic CIFAR-shaped set (every class,
uint8 on the host, as the loader serves it), builds the mask with
``DDPMRunner.generate_mask`` over the forget class in batches of the
config's size (timed as ``mask_s``), builds the clip → grad mask → Adam
optimizer and the step of ``make_saliency_unlearn_step``, and drives that
step through its first ``checked_steps`` steps; the window drives it on.
Step i takes a remain and a forget batch drawn from (seed, i), its flips,
t and noise injected, and a generator seeded from (seed, i) for the
class drop and the dropout inside the forwards.

The check works the same out again with the plain reference in fp32
(TF32 off) and compares ``mask_mismatch``, ``loss_gap``, ``grad_gap`` and
``change_gap`` (``harness.compare.training_checks``); the gradient is the
clipped and masked one Adam got.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark_h100.harness import compare, flops, synth, training, weights
from benchmark_h100.reference import ddpm, ops


class Driver(training.TrainingDriver):
    def __init__(self, cfg: dict, traffic: dict, limits: dict, seed: int,
                 device):
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.seed, self.device = int(seed), torch.device(device)
        self.timings = {}
        self.bs = cfg["training"]["batch_size"]
        self.forget = traffic["forget_class"]
        self.ucfg = self.model_cfg()

    def model_cfg(self) -> dict:
        d, m = self.cfg["data"], self.cfg["model"]
        return {"ch": m["ch"], "out_ch": m["out_ch"],
                "ch_mult": list(m["ch_mult"]),
                "num_res_blocks": m["num_res_blocks"],
                "attn_resolutions": list(m["attn_resolutions"]),
                "dropout": m["dropout"], "in_channels": d["channels"],
                "image_size": d["image_size"], "n_classes": d["n_classes"],
                "cond_drop_prob": m["cond_drop_prob"]}

    def ref_cfg(self) -> dict:
        t = self.cfg["training"]
        return {"cond_drop_prob": self.cfg["model"]["cond_drop_prob"],
                "label_to_forget": self.forget,
                "n_classes": self.cfg["data"]["n_classes"],
                "alpha": t["alpha"]}

    # ----------------------------------------------------------- inputs

    def dataset(self):
        d = self.cfg["data"]
        images, labels = synth.class_images(
            self.seed, self.traffic["per_class"], d["n_classes"],
            d["image_size"], self.device)
        self.forget_idx = np.flatnonzero(labels == self.forget)
        self.remain_idx = np.flatnonzero(labels != self.forget)
        return images, labels

    def _draws(self, gen, n):
        T = self.cfg["diffusion"]["num_diffusion_timesteps"]
        dev, d = self.device, self.cfg["data"]
        flips = torch.rand(n, generator=gen, device=dev) < 0.5
        base = torch.randint(0, T, (n // 2 + 1,), generator=gen, device=dev)
        t = torch.cat([base, T - base - 1])[:n]
        e = torch.randn((n, d["channels"], d["image_size"], d["image_size"]),
                        generator=gen, device=dev)
        return {"flips": flips, "t": t, "e": e}

    def mask_batches(self):
        """The forget class in shuffled batches of the config's size, the
        last one filled up by repeating its rows (as the system's batch
        iterator serves it), each with its flips, t and noise."""
        rng = np.random.default_rng(synth.tag_seed(self.seed, "mask_order"))
        order = rng.permutation(self.forget_idx)
        for k in range(0, len(order), self.bs):
            idx = order[k:k + self.bs]
            if len(idx) < self.bs:
                idx = np.concatenate([idx, idx[np.resize(
                    np.arange(len(idx)), self.bs - len(idx))]])
            gen = synth.generator(self.seed, "mask", k, device=self.device)
            yield ({"image": self.images[idx], "label": self.labels[idx]},
                   self._draws(gen, self.bs))

    def step_inputs(self, i: int):
        """Step ``i``'s remain and forget batches, their draws, and the
        seed of the generator the forwards draw from."""
        rng = np.random.default_rng(synth.tag_seed(self.seed, "rows", i))
        r = rng.choice(self.remain_idx, self.bs, replace=False)
        f = rng.choice(self.forget_idx, self.bs, replace=False)
        gen = synth.generator(self.seed, "step", i, device=self.device)
        remain = {"image": self.images[r], "label": self.labels[r]}
        forget = {"image": self.images[f], "label": self.labels[f]}
        draws = {"remain": self._draws(gen, self.bs),
                 "forget": self._draws(gen, self.bs)}
        return remain, forget, draws, synth.tag_seed(self.seed, "model", i)

    def model_generator(self, tag):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(tag)
        return gen

    # ----------------------------------------------------------- set-up

    def setup(self, sync) -> None:
        import time

        from salun_torch.diffusion.runner import (DDPMRunner,
                                                  DDPMTrainConfig,
                                                  make_optimizer)
        from salun_torch.diffusion.schedules import DiffusionSchedule
        from salun_torch.diffusion.unet import ConditionalUNet, UNetConfig
        from salun_torch.utils.device import set_tf32

        set_tf32(bool(self.cfg["precision"]["tf32"]))
        u, c = self.ucfg, self.cfg
        unet_cfg = UNetConfig(
            ch=u["ch"], out_ch=u["out_ch"], ch_mult=tuple(u["ch_mult"]),
            num_res_blocks=u["num_res_blocks"],
            attn_resolutions=tuple(u["attn_resolutions"]),
            dropout=u["dropout"], in_channels=u["in_channels"],
            image_size=u["image_size"], n_classes=u["n_classes"],
            cond_drop_prob=u["cond_drop_prob"],
            resamp_with_conv=c["model"]["resamp_with_conv"])
        diff = c["diffusion"]
        schedule = DiffusionSchedule.create(
            beta_schedule=diff["beta_schedule"],
            beta_start=diff["beta_start"], beta_end=diff["beta_end"],
            num_diffusion_timesteps=diff["num_diffusion_timesteps"],
            var_type=c["model"]["var_type"])
        t, o = c["training"], c["optim"]
        train_cfg = DDPMTrainConfig(
            n_iters=t["n_iters"], batch_size=t["batch_size"], lr=o["lr"],
            beta1=o["beta1"], eps=o["eps"], grad_clip=o["grad_clip"],
            ema=c["model"]["ema"], alpha=t["alpha"], method=t["method"],
            label_to_forget=self.forget,
            cond_scale=c["sampling"]["cond_scale"],
            cond_drop_prob=c["model"]["cond_drop_prob"],
            random_flip=c["data"]["random_flip"])
        runner = DDPMRunner(unet_cfg, schedule, train_cfg, self.device)
        with torch.device("meta"):
            model = ConditionalUNet(unet_cfg)
        model.to_empty(device=self.device)
        weights.fill(model, self.seed, 0)
        self.model = model
        self.images, self.labels = self.dataset()
        batches = []
        for batch, draws in self.mask_batches():
            batch.update(draws)
            batches.append(batch)
        sync()
        t0 = time.perf_counter()
        masks = runner.generate_mask(model, batches,
                                     thresholds=(self.traffic["threshold"],))
        sync()
        self.timings["mask_s"] = time.perf_counter() - t0
        del batches
        mask = masks[self.traffic["threshold"]]
        del masks
        self.optimizer = make_optimizer(model, train_cfg, mask)
        self.mask_host = {n: m.to("cpu", torch.bool) for n, m in
                          mask.items()}
        del mask
        self.step = runner.make_saliency_unlearn_step(model, self.optimizer)
        self.losses = []
        for i in range(self.traffic["checked_steps"]):
            self.losses.append(self._step(i))
            if i == 0:
                self.read_first_step()
        self.read_change()
        self.losses = [float(x) for x in self.losses]
        self.next = self.traffic["checked_steps"]

    def _step(self, i: int):
        remain, forget, draws, tag = self.step_inputs(i)
        return self.step(remain, forget, generator=self.model_generator(tag),
                         draws=draws)

    def model_under_test(self):
        return self.model

    def adams(self) -> list:
        return [self.optimizer.adam]

    def start_leaves(self, model):
        return weights.leaves(model, self.seed, 0, self.device)

    # ----------------------------------------------------------- window

    def unit(self):
        """One step; returns (rows, loss)."""
        loss = self._step(self.next)
        self.next += 1
        return 2 * self.bs, loss

    def work(self):
        """One step's work: the remain and forget forwards with their
        backwards, and the pseudo forward without."""
        with torch.device("meta"):
            ref = ddpm.ConditionalUNet(self.ucfg)
        s, ch = self.ucfg["image_size"], self.ucfg["in_channels"]

        def fwd():
            ref(flops.meta((self.bs, ch, s, s)), flops.meta((self.bs,)),
                flops.meta((self.bs,), torch.long),
                keep=flops.meta((self.bs,), torch.bool))

        return flops.count(fwd, True).times(2) + flops.count(fwd, False)

    def release(self) -> None:
        del self.step, self.optimizer, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- check

    def reference(self, autocast: bool = False, mask=None,
                  fault: str = "") -> dict:
        """The reference's readings (``training.reference_steps``), from
        the seed alone; ``autocast``, ``mask`` and ``fault`` as for the SD
        training cell."""
        dev = self.device
        if not hasattr(self, "images"):
            self.images, self.labels = self.dataset()
        with torch.device("meta"):
            model = ddpm.ConditionalUNet(self.ucfg)
        model.to_empty(device=dev)
        weights.fill(model, self.seed, 0)
        d = self.cfg["diffusion"]
        sched = ops.Schedule(d["beta_schedule"], d["beta_start"],
                             d["beta_end"], d["num_diffusion_timesteps"], dev)
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        clip = self.cfg["optim"]["grad_clip"]
        amp = torch.autocast(dev.type, dtype=torch.bfloat16,
                             enabled=autocast)
        if mask is None:
            mask = self.reference_mask(model, sched, params, amp)
        else:
            mask = [mask[n] for n in names]
        hook = (model.register_forward_hook(
            compare.alter_first_row)
            if fault == "answer_altered" else None)
        o = self.cfg["optim"]
        adam = ops.Adam(params, o["lr"], (o["beta1"], 0.999), o["eps"])
        h = self.bs // 2 if fault == "half_batch" else self.bs

        def step_grads(i):
            remain, forget, draws, tag = self.step_inputs(i)
            sides = [{"x01": ddpm.images01(b["image"][:h], dev),
                      "labels": torch.as_tensor(b["label"][:h]).to(
                          dev).long()} for b in (remain, forget)]
            draws = {side: {k: v[:h] for k, v in dr.items()}
                     for side, dr in draws.items()}
            with amp:
                loss = ddpm.random_label_loss(
                    model, sched, sides[0], sides[1], draws,
                    self.model_generator(tag), self.ref_cfg())
                grads = torch.autograd.grad(loss, params)
            return float(loss.detach()), ops.global_norm_clip(
                [g.float() for g in grads], clip)

        out = training.reference_steps(
            model, mask, adam, step_grads, self.traffic["checked_steps"],
            self.start_leaves(model))
        if hook is not None:
            hook.remove()
        return out

    def reference_mask(self, model, sched, params, amp) -> list:
        """The reference's saliency mask: each batch's gradient clipped by
        its global norm, summed, |·|, the exact top share."""
        dev, clip = self.device, self.cfg["optim"]["grad_clip"]
        guidance = self.cfg["sampling"]["cond_scale"]
        acc = [torch.zeros_like(p) for p in params]
        for batch, draws in self.mask_batches():
            x01 = ddpm.images01(batch["image"], dev)
            labels = torch.as_tensor(batch["label"]).to(dev)
            with amp:
                loss = ddpm.saliency_loss(model, sched, x01, labels, draws,
                                          guidance)
                grads = torch.autograd.grad(loss, params)
            for a, g in zip(acc, ops.global_norm_clip(
                    [g.float() for g in grads], clip)):
                a.add_(g)
        mask = ops.top_fraction_mask([a.abs_() for a in acc],
                                     self.traffic["threshold"])
        del acc
        return mask
