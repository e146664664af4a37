"""Seeded weights, made on the device in a few large draws.

Every model's parameters, in ``named_parameters()`` order, are one flat
sequence of standard normals drawn in chunks of ``CHUNK`` values, chunk
``k`` from its own generator seeded by (seed, stream, k), so any leaf can
be drawn again without the others. Each leaf then takes its scale:

- a norm's weight 1 + 0.1·z and bias 0.1·z (GroupNorm, LayerNorm and the
  fused GroupNorm → SiLU modules, found by type name);
- a weight of two or more dimensions z·fan_in^−½ (convolutions, linears,
  embeddings), fan_in the product of its trailing dimensions;
- any other vector 0.02·z (biases, the null class embedding).

No layer is left at zero: the published zero-initialised output
convolutions would zero every gradient upstream of them.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 25
NORM_TYPES = ("GroupNorm", "LayerNorm", "GroupNormSiLU")


def norm_params(module: torch.nn.Module) -> set:
    """Names of the parameters that belong to a norm layer."""
    out = set()
    for prefix, m in module.named_modules():
        if type(m).__name__ in NORM_TYPES or isinstance(
                m, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
            for name, _ in m.named_parameters(recurse=False):
                out.add(f"{prefix}.{name}" if prefix else name)
    return out


def _chunk(seed: int, stream: int, k: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream * 7_919 + k)
                    % (1 << 63))
    return torch.randn(CHUNK, generator=gen, device=device)


def _scale(name: str, t: torch.Tensor, norms: set) -> None:
    if name in norms:
        if name.endswith("weight"):
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1)
    elif t.dim() >= 2:
        t.mul_(t[0].numel() ** -0.5)
    else:
        t.mul_(0.02)


def leaves(module: torch.nn.Module, seed: int, stream: int, device):
    """Yield ``(name, tensor)``: each parameter's seeded value, in order,
    as fresh tensors on ``device``."""
    params = list(module.named_parameters())
    norms = norm_params(module)
    offset, k, buf = 0, -1, None
    for name, p in params:
        n = p.numel()
        out = torch.empty(n, dtype=torch.float32, device=device)
        done = 0
        while done < n:
            pos = offset + done
            if pos // CHUNK != k:
                k = pos // CHUNK
                buf = _chunk(seed, stream, k, device)
            lo = pos - k * CHUNK
            m = min(n - done, CHUNK - lo)
            out[done:done + m].copy_(buf[lo:lo + m])
            done += m
        out = out.reshape(p.shape)
        _scale(name, out, norms)
        offset += n
        yield name, out


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int, stream: int) -> None:
    """Write the seeded values into every parameter of ``module``, on the
    device the parameters lie on."""
    named = dict(module.named_parameters())
    device = next(iter(named.values())).device
    for name, value in leaves(module, seed, stream, device):
        named[name].copy_(value)
        del value
