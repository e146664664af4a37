"""The port's SD networks (``salun_torch.sd``) against ``salun.sd`` on the
tiny LatentDiffusion of ``tests/test_sd.py``: CLIP text, the VAE's
``encode_moments``/``decode`` and the U-Net, each with the JAX weights
carried over by ``sd_state_dict_from_jax`` (whose names must equal
``export_compvis``'s), plus the pieces around them: the timestep
embedding, the tokenizer, the yaml config, the schedule, the DDIM grid
and boundary, and the data helpers.

Tolerances: fp32 on both sides (JAX at "highest" matmul precision,
``tests/conftest.py``), summed in other orders, with flax's GroupNorm
taking E[x²] − μ² where the port takes a two-pass variance: outputs agree
to 1e-4 of their largest value. The U-Net with remat recomputes the same
ops on the CPU, so its gradients equal those without remat bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import nchw, nhwc, sd_perturbed_params, sd_tiny_jax, sd_twin
from salun.diffusion.sampling import generalized_steps as jax_ddim
from salun.diffusion.sampling import ldm_uniform_timesteps as jax_grid
from salun.sd import AutoencoderKL as JaxVAE
from salun.sd.config import load_sd_config as jax_load_sd_config
from salun.sd.data import _resize_center_crop as jax_resize_crop
from salun.sd.import_ckpt import export_compvis
from salun.sd.ldm import sd_schedule as jax_sd_schedule
from salun.sd.tokenizer import load_clip_tokenizer as jax_tokenizer
from salun.sd.unet import openai_timestep_embedding as jax_temb
from salun_torch.ckpt import sd_state_dict_from_jax
from salun_torch.ckpt.sd_import import compvis_state_dict
from salun_torch.diffusion.sampling import (generalized_steps,
                                            ldm_uniform_timesteps)
from salun_torch.sd import data as sd_data
from salun_torch.sd.config import load_sd_config
from salun_torch.sd.ldm import sd_schedule
from salun_torch.sd.tokenizer import load_clip_tokenizer
from salun_torch.sd.unet import openai_timestep_embedding

YAML = "configs/sd/v1-inference.yaml"


@pytest.fixture(scope="module")
def jax_modules():
    return sd_tiny_jax()


@pytest.fixture(scope="module")
def params(jax_modules):
    return sd_perturbed_params(jax_modules)


@pytest.fixture(scope="module")
def port(jax_modules, params):
    return sd_twin(jax_modules, params)


def _close(got, want, frac=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * float(np.abs(want).max()))


def test_bridge_names_equal_export_compvis(params, port):
    want = export_compvis(params)
    got = sd_state_dict_from_jax(params)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    assert set(compvis_state_dict(port)) == set(want)


def test_clip_text_matches_flax(jax_modules, params, port):
    ids = np.random.default_rng(2).integers(0, 49408, (2, 8)).astype(
        np.int32)
    want = jax_modules.encode_text(params, jnp.asarray(ids))
    got = port.encode_text(torch.from_numpy(ids))
    _close(got.numpy(), want)


def test_vae_encode_moments_and_decode_match_flax(jax_modules, params, port):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want_mean, want_logvar = jax_modules.vae.apply(
        {"params": params["vae"]}, jnp.asarray(x),
        method=JaxVAE.encode_moments)
    mean, logvar = port.encode_image_moments(nchw(x))
    _close(nhwc(mean), want_mean)
    _close(nhwc(logvar), want_logvar)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = jax_modules.decode_latent(params, jnp.asarray(z))
    _close(nhwc(port.decode_latent(nchw(z))), want)


def test_unet_matches_flax(jax_modules, params, port):
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 31], np.int32)
    ctx = rng.standard_normal((2, 8, 24)).astype(np.float32)
    want = jax_modules.apply_model(params, jnp.asarray(z), jnp.asarray(t),
                                   jnp.asarray(ctx))
    with torch.no_grad():
        got = port.apply_model(nchw(z), torch.from_numpy(t),
                               torch.from_numpy(ctx))
    _close(nhwc(got), want)


def test_unet_with_remat_gives_the_same_gradients(jax_modules, params):
    rng = np.random.default_rng(5)
    z = nchw(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    t = torch.tensor([5, 17])
    ctx = torch.from_numpy(rng.standard_normal((2, 8, 24)).astype(
        np.float32))
    grads = []
    for remat in (False, True):
        unet = sd_twin(jax_modules, params, remat=remat).unet
        loss = unet(z, t.float(), ctx).square().mean()
        grads.append(torch.autograd.grad(loss, list(unet.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_openai_timestep_embedding_matches(rng):
    """cos and sin of arguments up to ~1000 rad: the two libraries reduce
    them differently, within an ulp of the argument (6e-5 at 999): 1e-4.
    The DDPM ordering (sin first) would differ by O(1)."""
    t = rng.uniform(0, 999, 5).astype(np.float32)
    for dim in (320, 33):
        _close(openai_timestep_embedding(torch.from_numpy(t), dim).numpy(),
               jax_temb(jnp.asarray(t), dim), 1e-4)


def test_tokenizer_gives_jax_ids():
    prompts = ["an image of a tench", "Hello, World! 42 the cat's",
               "", "a photo of a nude person"]
    assert np.array_equal(load_clip_tokenizer()(prompts, 77),
                          jax_tokenizer()(prompts, 77))


def test_tokenizer_fails_loudly_without_assets(monkeypatch, tmp_path):
    monkeypatch.delenv("SALUN_CLIP_BPE", raising=False)
    with pytest.raises(FileNotFoundError):
        load_clip_tokenizer(str(tmp_path / "missing.txt"))


def test_yaml_config_parses_as_jax():
    got, want = load_sd_config(YAML), jax_load_sd_config(YAML)
    for part in ("unet", "vae", "clip"):
        g, w = dataclasses.asdict(getattr(got, part)), dataclasses.asdict(
            getattr(want, part))
        w.pop("dtype")
        assert g == w, part
    assert got.unet.remat  # use_checkpoint: True
    assert (got.timesteps, got.linear_start, got.linear_end,
            got.scale_factor) == (want.timesteps, want.linear_start,
                                  want.linear_end, want.scale_factor)


def test_sd_schedule_matches():
    np.testing.assert_array_equal(
        sd_schedule().alphas_cumprod.numpy(),
        np.asarray(jax_sd_schedule().alphas_cumprod, np.float32))


@pytest.mark.parametrize("steps", [50, 7])
def test_ddim_grid_and_final_alpha_bar_match_jax(steps):
    """``ldm_uniform_timesteps`` and ``generalized_steps(...,
    final_alpha_bar=ᾱ₀)`` against JAX with the same eps function (a fixed
    linear map of x and t), eta 0; default 1.0 leaves DDPM unchanged."""
    assert ldm_uniform_timesteps(1000, steps) == jax_grid(1000, steps)
    seq = ldm_uniform_timesteps(1000, steps)[:-1]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    port_s, jax_s = sd_schedule(), jax_sd_schedule()
    final = float(port_s.alphas_cumprod[0])

    def eps(xx, t):
        return 0.3 * xx + 1e-3 * t.reshape(-1, 1, 1, 1)

    want, _ = jax_ddim(eps, jnp.asarray(x), seq, jax_s, eta=0.0,
                       final_alpha_bar=final)
    got, _ = generalized_steps(eps, nchw(x), seq, port_s, eta=0.0,
                               final_alpha_bar=final)
    _close(nhwc(got), want, 1e-5)
    want1, _ = jax_ddim(eps, jnp.asarray(x), seq, jax_s, eta=0.0)
    got1, _ = generalized_steps(eps, nchw(x), seq, port_s, eta=0.0)
    _close(nhwc(got1), want1, 1e-5)
    assert not np.allclose(nhwc(got1), nhwc(got))


def test_data_helpers_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(7)
    img = Image.fromarray(rng.integers(0, 256, (90, 70, 3)).astype(np.uint8))
    got = sd_data._resize_center_crop(img, 64)
    assert np.array_equal(got, jax_resize_crop(img, 64))
    batch = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        sd_data.to_pm1(batch).numpy(),
        (batch.astype(np.float32) / 127.5 - 1.0).transpose(0, 3, 1, 2))
    csv = tmp_path / "p.csv"
    csv.write_text("case_number,prompt,evaluation_seed\n0,a cat,42\n")
    assert sd_data.read_prompts_csv(str(csv)) == [
        {"case_number": "0", "prompt": "a cat", "evaluation_seed": "42"}]
