"""Worker of ``tests/test_torch_dist.py``: one rank of a 2-process gloo
group on the CPU (spawned, no JAX), running the collectives of
``salun_torch.dist.context`` against their one-process meaning. Results go
back through a queue as ``{check: value}``."""

import os

import torch
from torch import nn

from salun_torch.dist import context as dist_ctx
from salun_torch.dist import multihost


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _bn_case(mesh, out: dict) -> None:
    """GlobalBatchNorm2d on this rank's half of a batch of 8 (3 pad rows of
    weight 0) against nn.BatchNorm2d on the whole batch, over two train
    steps, then eval."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 5, 6, 7, generator=gen) * 1.5 + 0.4
    w = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.float32)
    proj = torch.randn(5, 6, 7, generator=gen)
    ref = nn.BatchNorm2d(5, eps=1e-5, momentum=0.1)
    glob = dist_ctx.GlobalBatchNorm2d(5, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        ref.weight.uniform_(0.5, 1.5, generator=gen)
        ref.bias.uniform_(-0.5, 0.5, generator=gen)
    glob.load_state_dict(ref.state_dict())
    sl = dist_ctx.rows(8)
    errs = {k: 0.0 for k in ("forward", "input_grad", "weight_grad",
                             "bias_grad", "running_mean", "running_var",
                             "eval")}
    for step in range(2):
        xs = (x + step).clone().requires_grad_()
        y_ref = ref(xs)
        loss = ((y_ref * proj).sum(dim=(1, 2, 3)) * w).sum() / w.sum()
        ref.zero_grad()
        loss.backward()
        xl = (x + step)[sl].clone().requires_grad_()
        glob.zero_grad()
        with dist_ctx.sharded(8):
            y = glob(xl)
            part = ((y * proj).sum(dim=(1, 2, 3)) * w[sl]).sum() / w.sum()
            part.backward()
        dist_ctx.all_reduce_([glob.weight.grad, glob.bias.grad])
        for k, a, b in (("forward", y, y_ref[sl]),
                        ("input_grad", xl.grad, xs.grad[sl]),
                        ("weight_grad", glob.weight.grad, ref.weight.grad),
                        ("bias_grad", glob.bias.grad, ref.bias.grad),
                        ("running_mean", glob.running_mean, ref.running_mean),
                        ("running_var", glob.running_var, ref.running_var)):
            errs[k] = max(errs[k], _rel(a, b))
    out["bn_batches_tracked"] = (int(glob.num_batches_tracked),
                                 int(ref.num_batches_tracked))
    glob.eval()
    ref.eval()
    errs["eval"] = _rel(glob(x[sl]), ref(x)[sl])
    out["bn"] = errs


def _collective_cases(mesh, out: dict) -> None:
    r = mesh.rank

    def tensors(rank):
        g = torch.Generator().manual_seed(100 + rank)
        return [torch.randn(3, 5, generator=g), torch.randn(17, generator=g),
                torch.randint(-50, 50, (4, 4), generator=g),
                torch.randn(2, 3, 4, generator=g).double(),
                torch.randn(40, generator=g)[::2]]

    mine = tensors(r)
    want = [a + b for a, b in zip(tensors(0), tensors(1))]
    for bucket in (dist_ctx.BUCKET_BYTES, 64):
        got = [t.clone() for t in mine]
        dist_ctx.all_reduce_(got, bucket_bytes=bucket)
        out[f"all_reduce_{bucket}"] = all(
            torch.equal(a, b) for a, b in zip(got, want))
    # the rows of a global batch back on every rank
    full = torch.arange(24.0).reshape(8, 3)
    out["gather_rows"] = torch.equal(
        dist_ctx.gather_rows(full[dist_ctx.rows(8)], 8), full)
    # rank 0's state everywhere, then the replica check passes; a changed
    # bit on rank 1 fails it on that rank
    model = nn.Linear(4, 3)
    with torch.no_grad():
        model.weight.fill_(float(r))
    dist_ctx.place_replicated(model)
    out["place_replicated"] = bool((model.weight == 0).all())
    dist_ctx.check_replicas(model.parameters(), "parameters")
    if r == 1:
        with torch.no_grad():
            model.bias[0] = model.bias[0].nextafter(torch.tensor(9.0))
    try:
        dist_ctx.check_replicas(model.parameters(), "parameters")
        out["replica_check_fails"] = False
    except RuntimeError:
        out["replica_check_fails"] = True
    # draws within a shard are the global batch's rows
    g = torch.Generator().manual_seed(7)
    whole = torch.rand(8, 3, generator=g)
    g.manual_seed(7)
    with dist_ctx.sharded(8):
        part = dist_ctx.rand((4, 3), generator=g)
    out["sharded_draw"] = torch.equal(part, whole[dist_ctx.rows(8)])


def run(rank: int, port: int, queue) -> None:
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2")
    out = {"rank": rank}
    mesh = None
    try:
        mesh = dist_ctx.mesh_from_flags(2, "cpu")
        out["backend"] = mesh.backend
        with dist_ctx.activate(mesh):
            _bn_case(mesh, out)
            _collective_cases(mesh, out)
    except Exception as e:  # reported to the test, which fails on it
        out["error"] = repr(e)
    finally:
        multihost.shutdown()
        queue.put(out)
