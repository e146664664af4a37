"""Helpers shared by the ``test_torch_*`` files: build a JAX model and the
port's twin with the same weights (through the port's own bridge), and
replay the JAX train step's random draws so both sides see the same ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# torch imports torch._dynamo lazily, at the first optimizer it builds. A
# test elsewhere patches os.path.exists while a library probes an optional
# import (tests/test_tokenizer.py::test_loader_fails_loudly); a first import
# of torch._dynamo inside that window fails halfway and leaves it broken
# for the rest of the process. Importing it here, while the test modules
# are collected (every worker collects every file), keeps it out of it.
import torch._dynamo  # noqa: F401

from salun.models import create_model as jax_create_model
from salun_torch.ckpt import state_dict_from_jax
from salun_torch.models import create_model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one CPU thread for a test module (import it into the
    module to use it). The suite runs several workers at once; torch's
    default of one OpenMP thread a core then oversubscribes the host, and
    a run of many small ops (a batch-1 gradient stream, a CLI call)
    measured 100× slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model_and_vars(arch, rng, num_classes=10, seed=0):
    """Flax model plus numpy (params, batch_stats) with non-trivial BN."""
    model = jax_create_model(arch, num_classes)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 32, 32, 3)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    return model, _perturb_bn_params(params, rng), _perturb_stats(stats, rng)


def _perturb_bn_params(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "scale" in v:
            out[k] = {"scale": (1.0 + 0.1 * rng.standard_normal(
                v["scale"].shape)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(
                    v["bias"].shape)).astype(np.float32)}
        elif isinstance(v, dict):
            out[k] = _perturb_bn_params(v, rng)
        else:
            out[k] = v
    return out


def _perturb_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "mean" in v:
            out[k] = {"mean": (0.1 * rng.standard_normal(
                v["mean"].shape)).astype(np.float32),
                "var": (1.0 + 0.5 * rng.random(v["var"].shape)).astype(
                    np.float32)}
        else:
            out[k] = _perturb_stats(v, rng)
    return out


def port_twin(arch, params, batch_stats, num_classes=10):
    """The port's model carrying the JAX weights (strict load)."""
    model = create_model(arch, num_classes)
    model.load_state_dict(state_dict_from_jax(params, batch_stats),
                          strict=True)
    return model


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def jax_step_draws(sub, batch_size, num_classes):
    """The draws of ``salun.core.train.make_train_step`` for step key
    ``sub``: crop offsets and flips (augment) and random labels."""
    ka, kl = jax.random.split(sub)
    kc, kf = jax.random.split(ka)
    offsets = np.array(jax.random.randint(kc, (batch_size, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(kf, 0.5, (batch_size,)))
    labels = np.array(jax.random.randint(kl, (batch_size,), 0, num_classes))
    return offsets, flips, labels


def jax_key_source(key, num_classes):
    """A randomness source for ``salun_torch.core.train`` that replays the
    JAX run_epoch key discipline (one split per step) from ``key``."""
    state = {"key": key}

    def draw(batch_size, *, random_labels=False):
        state["key"], sub = jax.random.split(state["key"])
        offsets, flips, labels = jax_step_draws(sub, batch_size, num_classes)
        out = {"offsets": torch.from_numpy(offsets.astype(np.int64)),
               "flips": torch.from_numpy(flips)}
        if random_labels:
            out["labels"] = torch.from_numpy(labels.astype(np.int64))
        return out

    return draw


def jax_augment_draws(k, batch_size):
    """The crop offsets and flips ``salun.data.loader.augment(k, ·)``
    draws for a batch, as a port source returns them."""
    kc, kf = jax.random.split(k)
    offsets = np.array(jax.random.randint(kc, (batch_size, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(kf, 0.5, (batch_size,)))
    return {"offsets": torch.from_numpy(offsets.astype(np.int64)),
            "flips": torch.from_numpy(flips)}


def jax_augment_source(key, calls=None):
    """A source for the port's augment-only draws that replays the JAX
    chain ``key, k = split(key); augment(k, ·)``, one link a call (the
    FIM and gradient streams of fisher and wfisher). ``calls``, a list,
    gets each call's batch size."""
    state = {"key": key}

    def draw(batch_size, *, random_labels=False):
        assert not random_labels
        if calls is not None:
            calls.append(batch_size)
        state["key"], k = jax.random.split(state["key"])
        return jax_augment_draws(k, batch_size)

    return draw


def ddpm_twin(jax_unet_cfg, params):
    """The port's U-Net for a JAX ``UNetConfig`` carrying the JAX params,
    through the port's bridge (strict load)."""
    from dataclasses import fields

    from salun_torch.ckpt import ddpm_state_dict_from_jax
    from salun_torch.diffusion import ConditionalUNet, UNetConfig

    cfg = UNetConfig(**{f.name: getattr(jax_unet_cfg, f.name)
                        for f in fields(UNetConfig)})
    model = ConditionalUNet(cfg)
    model.load_state_dict(ddpm_state_dict_from_jax(params), strict=True)
    return model


def perturb_vectors(params, rng, scale=0.1):
    """Numpy copy of a param tree with every 1-D leaf (biases, GroupNorm
    scales, the null embedding) moved off its init value, so that layout
    and naming faults in those leaves show."""
    return jax.tree.map(
        lambda p: (np.asarray(p) + scale * rng.standard_normal(p.shape)
                   ).astype(np.float32) if np.ndim(p) == 1
        else np.asarray(p), params)


def nhwc(t):
    return np.asarray(t.detach().cpu().numpy()).transpose(0, 2, 3, 1)


# ------------------------------------------------------------- SD (tiny)


def sd_tiny_jax(num_timesteps=40):
    """The tiny LatentDiffusion of ``tests/test_sd.py:17-25`` (U-Net ch 32,
    VAE ch 32, CLIP width 24 with 2 layers, latents 8×8)."""
    from salun.sd import CLIPTextConfig, SDModules, SDUNetConfig, VAEConfig

    unet = SDUNetConfig(in_channels=4, out_channels=4, model_channels=32,
                        num_res_blocks=1, attention_resolutions=(1, 2),
                        channel_mult=(1, 2), num_heads=2, context_dim=24,
                        transformer_depth=1)
    vae = VAEConfig(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1,
                    z_channels=4, embed_dim=4)
    clip = CLIPTextConfig(vocab_size=49408, hidden_size=24, num_layers=2,
                          num_heads=2, max_length=8)
    return SDModules.create(unet, vae, clip, num_timesteps=num_timesteps)


def sd_perturbed_params(jax_modules, seed=0, scale=0.05):
    """Numpy params of ``jax_modules`` with every leaf moved by
    ``scale``·N(0, 1): no layer stays at its zero (or unit) init, so the
    U-Net's zero-initialised output convs pass gradients and every name
    and layout fault shows."""
    params = jax_modules.init(jax.random.PRNGKey(seed), image_size=8)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda p: (np.asarray(p) + scale * rng.standard_normal(p.shape)
                   ).astype(np.float32), params)


def sd_twin(jax_modules, params, remat=False):
    """The port's ``SDModules`` for the same configs, carrying ``params``
    through the port's bridge (strict load)."""
    from dataclasses import fields

    from salun_torch.ckpt import load_sd_modules, sd_state_dict_from_jax
    from salun_torch.sd import (CLIPTextConfig, SDModules, SDUNetConfig,
                                VAEConfig)

    def same(cls, cfg, **kw):
        args = {f.name: getattr(cfg, f.name) for f in fields(cls)
                if hasattr(cfg, f.name)}
        return cls(**{**args, **kw})

    sd = SDModules.create(
        same(SDUNetConfig, jax_modules.unet.cfg, remat=remat),
        same(VAEConfig, jax_modules.vae.cfg),
        same(CLIPTextConfig, jax_modules.clip.cfg),
        num_timesteps=jax_modules.schedule.num_timesteps)
    load_sd_modules(sd, sd_state_dict_from_jax(params))
    return sd
