"""Host offload (``salun_torch.dist.host_offload``) on the CPU: ``offloaded``
Adam over 5 steps bitwise against plain Adam (bucket by bucket and in one
bucket), against the JAX package's eager ``to_host``/``to_device``
pattern (``tests/test_host_offload.py``) on the same inputs, the moves'
round trip; and on two spawned gloo ranks, over FSDP-sharded parameters
whose state parks as host shards."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _sharded_workers as workers
from _torch_port import one_torch_thread  # noqa: F401
from salun.dist import make_mesh as jax_make_mesh
from salun.dist.host_offload import to_device as jax_to_device
from salun.dist.host_offload import to_host as jax_to_host
from salun_torch.dist import host_offload
from salun_torch.dist.host_offload import (HostTensor, offloaded, to_device,
                                           to_host)

STEPS, LR = 5, 1e-2
# optax.adam and torch.optim.Adam round in other orders (bias correction
# before or after the square root): parameters of order 1 after 5 steps
JAX_TOL = 1e-6


def _params():
    return {"w": torch.linspace(-1, 1, 24 * 50).reshape(24, 50),
            "b": torch.zeros(4), "v": torch.linspace(0, 2, 3000)}


def _grad(x, i):
    return torch.cos(x + i)


def _run(wrap):
    ps = {k: torch.nn.Parameter(v.clone()) for k, v in _params().items()}
    opt = torch.optim.Adam(list(ps.values()), lr=LR)
    opt = wrap(opt)
    for i in range(STEPS):
        for p in ps.values():
            p.grad = _grad(p.detach(), i)
        opt.step()
    return ps, opt


@pytest.mark.parametrize("bucket_bytes", [4096, 1 << 30])
def test_offloaded_adam_is_bitwise_plain_adam(bucket_bytes, monkeypatch):
    monkeypatch.setattr(host_offload, "BUCKET_BYTES", bucket_bytes)
    plain, _ = _run(lambda o: o)
    off, opt = _run(lambda o: offloaded(o, min_size=1024))
    for k in plain:
        assert torch.equal(plain[k], off[k]), k
    # the large state parks on the host; the bias's (4 < 1024) never moves
    st = opt.state[off["w"]]
    assert st["exp_avg"].device.type == "cpu" and st["exp_avg"].numel() > 0


def test_offloaded_adam_matches_jax_eager_pattern(monkeypatch):
    mesh = jax_make_mesh(data=8, model=1)
    params = {k: jnp.asarray(v.numpy()) for k, v in _params().items()}
    tx = optax.adam(LR)
    s_host = jax_to_host(tx.init(params), mesh)

    @jax.jit
    def step(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for i in range(STEPS):
        g = jax.tree.map(lambda x: jnp.cos(x + i), params)
        params, s_dev = step(params, jax_to_device(s_host, mesh), g)
        s_host = jax_to_host(s_dev, mesh)
    monkeypatch.setattr(host_offload, "BUCKET_BYTES", 4096)
    off, _ = _run(lambda o: offloaded(o))
    for k, v in params.items():
        np.testing.assert_allclose(off[k].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=JAX_TOL, err_msg=k)


def test_to_host_and_back():
    xs = [torch.randn(3, 5), torch.arange(7)]
    hosted = to_host(xs)
    assert all(h.device.type == "cpu" and h is not x
               for h, x in zip(hosted, xs))
    back = to_device(hosted, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, xs))
    # written into the buffers it is given
    again = to_host([x + 1 for x in xs], hosted)
    assert all(a is b for a, b in zip(again, hosted))
    assert torch.equal(hosted[1], xs[1] + 1)


@pytest.fixture(scope="module")
def two_ranks():
    out = workers.spawn("offload")
    for o in out:
        assert "error" not in o, o["error"]
    return out


def test_offloaded_adam_on_fsdp_shards(two_ranks):
    for o in two_ranks:
        assert o["offload_bitwise"], o
        assert o["offload_state_on_host"] == HostTensor.__name__
        assert o["host_roundtrip"], o
