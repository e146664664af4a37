"""SD image generation as SalUn's evaluation runs it: requests of one
prompt and ``images`` images each through ``SDModules.sample`` (DDIM, CFG
against the empty prompt) and the VAE decode, one after the other.

A request's prompt is drawn from the traffic's list of class prompts and
its initial latents from (seed, request), both on the device; the prompts
go through the system's own tokenizer with the benchmark's copy of the
synthetic CLIP merges. Set-up warms up every shape of a request with a
two-step chain.

The check draws ``check_images`` images from the seed among those the
window produced, one from each stratum of a request's rows, denoises the
same latents under the same prompt with the plain reference in fp32 (TF32
off), decodes them, and compares ``image_gap``: the largest |pixel −
reference| in [0, 1].
"""

from __future__ import annotations

import gc
import os
from pathlib import Path

import numpy as np
import torch

from benchmark_h100.harness import compare, synth
from benchmark_h100.reference import ops, sd_v1

from . import sd_common

MERGES = Path(__file__).resolve().parents[1] / "clip_merges.txt"


class Driver:
    kind = "sample"  # what a unit is: an optimizer step or a request

    def __init__(self, cfg: dict, traffic: dict, limits: dict, seed: int,
                 device):
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.seed, self.device = int(seed), torch.device(device)
        self.timings = {}
        self.n = traffic["images"]
        self.latent = traffic["image_size"] // 8
        os.environ["SALUN_CLIP_BPE"] = str(MERGES)

    def request(self, r: int):
        """Request ``r``'s prompt and initial latents."""
        gen = synth.generator(self.seed, "request", r, device=self.device)
        prompts = self.traffic["prompts"]
        pick = int(np.random.default_rng(synth.tag_seed(
            self.seed, "prompt", r)).integers(len(prompts)))
        z = torch.randn((self.n, self.cfg["vae"]["z_channels"], self.latent,
                         self.latent), generator=gen, device=self.device)
        return prompts[pick], z

    def _sample(self, prompt, z, steps):
        return self.sd.sample([prompt] * self.n, guidance=self.traffic[
            "guidance"], steps=steps, image_size=self.latent,
            sampler="ddim", initial_latents=z)

    def setup(self, sync) -> None:
        from salun_torch.utils.device import set_tf32

        set_tf32(bool(self.cfg["precision"]["tf32"]))
        self.sd = sd_common.build_program(self.cfg, self.device, self.seed)
        prompt, z = self.request(-1)
        self._sample(prompt, z, 2)  # every shape: one transition, a decode
        self.outputs = []
        self.next = 0

    def unit(self):
        """One request; returns (images, images)."""
        prompt, z = self.request(self.next)
        self.next += 1
        out = self._sample(prompt, z, self.traffic["steps"])
        self.outputs.append(out)
        return self.n, out

    def work(self):
        """One request's work: the prompt and the empty prompt through
        CLIP, one CFG-doubled U-Net forward a DDIM transition, a decode."""
        ref = sd_common.meta_reference(self.cfg)
        T, steps = self.cfg["schedule"]["timesteps"], self.traffic["steps"]
        transitions = len(range(0, T, T // steps)) - 1
        return (sd_common.text_work(ref, self.cfg, self.n).times(2)
                + sd_common.unet_work(ref, self.cfg, 2 * self.n,
                                      self.latent, False).times(transitions)
                + sd_common.decode_work(ref, self.cfg, self.n, self.latent))

    def release(self) -> None:
        del self.sd
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def picks(self, done: int):
        """(request, row) of the images checked, drawn from the seed: the
        rows of a request cut into ``check_images`` equal strata, one image
        from each, of a request drawn afresh, so that every check covers
        the first and the last rows of a request."""
        gen = synth.generator(self.seed, "check", done)
        k = min(self.traffic["check_images"], self.n)
        out = []
        for j in range(k):
            lo, hi = j * self.n // k, (j + 1) * self.n // k
            r = int(torch.randint(done, (1,), generator=gen))
            out.append((r, lo + int(torch.randint(hi - lo, (1,),
                                                  generator=gen))))
        return sorted(out)

    def reference(self, picks, autocast: bool = False):
        """The reference's images at ``picks``, [k, 3, H, W]."""
        dev = self.device
        ref = sd_common.build_reference(self.cfg, dev, self.seed)
        sched = ref.schedule(dev)
        tok = sd_v1.Tokenizer(str(MERGES))
        prompts, zs = [], []
        for r, row in picks:
            prompt, z = self.request(r)
            prompts.append(prompt)
            zs.append(z[row])
        ids_c = tok(prompts, self.cfg["clip"]["max_length"]).to(dev)
        ids_u = tok([""] * len(prompts),
                    self.cfg["clip"]["max_length"]).to(dev)
        with torch.autocast(dev.type, dtype=torch.bfloat16,
                            enabled=autocast):
            return sd_v1.ddim_sample(ref, sched, ids_c, ids_u,
                                     torch.stack(zs), self.traffic["steps"],
                                     self.traffic["guidance"]).float()

    def compare(self, ref, prog) -> compare.Checks:
        checks = compare.Checks(self.limits)
        gap = (prog.to(ref.device) - ref).abs().amax(dim=(1, 2, 3))
        worst = int(gap.argmax())
        checks.add("image_gap", float(gap[worst]), f"image {worst}")
        return checks

    def check(self) -> compare.Checks:
        picks = self.picks(len(self.outputs))
        prog = torch.stack([self.outputs[r][row] for r, row in picks])
        del self.outputs
        with ops.fp32_exact():
            ref = self.reference(picks)
        return self.compare(ref, prog)
