"""K1 on the card against its plain PyTorch version (``-m cuda``).

Skips where no CUDA device is present. The decision is taken inside the
fixture, never at import, so every pytest worker collects the same tests.
This file imports neither ``jax`` nor ``salun``; on a machine without JAX
run it with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda
--noconftest -p no:cacheprovider``.
"""

import pytest
import torch

from salun_torch.kernels.masked_update import (masked_sgd_update,
                                               masked_sgd_update_reference)
from salun_torch.utils.device import set_tf32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU or interpret mode)")
    set_tf32(False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4096 + 3, 11_173_962])
@pytest.mark.parametrize("offset", [0, 1])
def test_k1_bitwise_equals_plain_on_card(cuda, n, offset):
    """Bitwise: both do the same explicitly rounded fp32 operations in the
    same order. ``offset=1`` makes every pointer unaligned (scalar path)."""
    gen = torch.Generator(device=cuda).manual_seed(n)

    def vec():
        return torch.randn(n + offset, generator=gen, device=cuda)[offset:]

    p, b, g, t0 = vec(), vec(), vec(), vec()
    mask = (torch.rand(n + offset, generator=gen, device=cuda) < 0.5).to(
        torch.uint8)[offset:]
    lr = torch.full((1,), 0.013, device=cuda)
    want_p, want_b = masked_sgd_update_reference(p, b, g, mask, t0, lr)
    before = masked_sgd_update.launches
    masked_sgd_update(p, b, g, mask, t0, lr)
    torch.cuda.synchronize()
    assert masked_sgd_update.launches == before + 1
    assert torch.equal(p, want_p)
    assert torch.equal(b, want_b)


@pytest.mark.cuda
def test_masked_sgd_on_card_equals_cpu_bitwise(cuda):
    """The whole optimizer path (flat buffers, lr tensor, milestone, θ₀
    pin) with K1 on the card vs the plain version on the CPU, fed the same
    gradients: the same fp32 operations, so bitwise equal; one launch per
    step."""
    from salun_torch.core.masked_opt import FlatParams, MaskedSGD
    from salun_torch.core.train import multistep_lr

    gen = torch.Generator().manual_seed(0)
    shapes = [(64, 3, 3, 3), (64,), (10, 64), (10,)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    mask = [(torch.rand(s, generator=gen) < 0.5).float() for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(6)]
    sides = {}
    for dev in ("cpu", cuda):
        params = [torch.nn.Parameter(t.clone().to(dev)) for t in init]
        flat = FlatParams(params)
        opt = MaskedSGD(flat, multistep_lr(0.05, [1], 3), 0.9, 5e-4,
                        mask=flat.flatten(mask),
                        theta0=flat.flatten(init))
        before = masked_sgd_update.launches
        for step_grads in grads:
            opt.zero_grad()
            for p, g in zip(params, step_grads):
                p.grad.copy_(g.to(dev))
            opt.step()
        launches = masked_sgd_update.launches - before
        sides[str(dev)] = (flat.flat.cpu(), opt.trace.cpu(), launches)
    cpu, card = sides["cpu"], sides[str(cuda)]
    assert cpu[2] == 0 and card[2] == len(grads)
    assert torch.equal(cpu[0], card[0]) and torch.equal(cpu[1], card[1])
