"""The port's data-parallel layer (``salun_torch.dist``) on the CPU:
``process_shard`` against ``salun.dist.multihost``, the ``--dp`` flag's
launch checks, batch slicing, and, across two spawned gloo ranks, the
global BatchNorm against ``nn.BatchNorm2d`` over the whole batch and the
bucketed all-reduce against the sum of the ranks' tensors; the ``(data,
model)`` mesh in both layouts of two ranks; the sharded exact k-th value
bitwise against the one-card sort and ``salun.dist.topk.kth_largest``."""

import multiprocessing as mp
import socket

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from salun.dist.multihost import process_shard as jax_process_shard
from salun_torch.core.train import cross_entropy
from salun_torch.dist import context as dist_ctx
from salun_torch.dist.mesh import Mesh, make_mesh
from salun_torch.dist.multihost import backend_for, process_shard
from salun_torch.dist.topk import kth_largest, kth_largest_sharded

BN_TOL = 1e-6  # relative, the global batch's moments against one process


@pytest.mark.parametrize("n", [0, 1, 7, 100, 257])
@pytest.mark.parametrize("count", [1, 2, 3, 8])
def test_process_shard_matches_jax(n, count):
    for pid in range(count):
        assert process_shard(n, pid, count) == jax_process_shard(n, pid,
                                                                 count)
    with pytest.raises(ValueError, match="outside"):
        process_shard(n, count, count)


@pytest.fixture
def no_launch(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_dp_flag_needs_a_launch_of_that_size(no_launch):
    assert dist_ctx.mesh_from_flags(0, "cpu") is None
    assert dist_ctx.mesh_from_flags(1, "cpu") is None
    with pytest.raises(ValueError, match="torchrun"):
        dist_ctx.mesh_from_flags(2, "cpu")  # no torchrun environment
    no_launch.setenv("WORLD_SIZE", "2")
    no_launch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="started 2"):
        dist_ctx.mesh_from_flags(3, "cpu")
    # a model axis is ported (two ranks below); any mesh needs a group up
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(1, model=2)


def test_backend_follows_the_placement(monkeypatch):
    env = {"rank": 0, "world": 2, "local_rank": 0, "local_world": 2}
    assert backend_for(torch.device("cpu"), env) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backend_for(torch.device("cuda", 0), env) == "gloo"  # shared
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert backend_for(torch.device("cuda", 1), env) == "nccl"


def _fake_mesh(rank):
    """A rank's view of a 2-rank mesh, without a process group (slicing
    needs none)."""
    return Mesh(data=2, rank=rank, device=torch.device("cpu"),
                backend="gloo")


def test_ingest_and_constrain_batch_semantics():
    """Divisible batch axes are sliced to the rank's rows, others stay whole
    (the port's form of test_cli_mesh.py::test_constrain_batch_semantics);
    without a mesh nothing changes."""
    x = torch.arange(16.0).reshape(8, 2)
    odd = torch.zeros(7, 2)
    batch = {"image": np.arange(24).reshape(8, 3), "label": torch.arange(8),
             "pair": (x, odd), "scalar": 3}
    assert dist_ctx.constrain_batch(x) is x
    assert dist_ctx.ingest(batch) is batch
    for rank in (0, 1):
        with dist_ctx.activate(_fake_mesh(rank)):
            rows = slice(4 * rank, 4 * rank + 4)
            assert torch.equal(dist_ctx.constrain_batch(x), x[rows])
            assert dist_ctx.constrain_batch(odd) is odd
            got = dist_ctx.ingest(batch)
            np.testing.assert_array_equal(got["image"],
                                          batch["image"][rows])
            assert torch.equal(got["label"], batch["label"][rows])
            assert torch.equal(got["pair"][0], x[rows])
            assert got["pair"][1] is odd and got["scalar"] == 3
            assert torch.equal(dist_ctx.constrain_batch(x.T, dim=1),
                               x.T[:, rows])
            assert dist_ctx.share(8) == 0.5 and dist_ctx.share(7) == 1.0
            assert dist_ctx.skips(7) == (rank == 1)
            assert dist_ctx.whole_share(8) == 0.5
            with pytest.raises(ValueError, match="must all divide"):
                dist_ctx.step_sharded(8, 7)
    assert dist_ctx.active_mesh() is None


def test_shard_losses_sum_to_the_global_loss():
    """Each rank's CE over its rows with the global batch's weight as the
    denominator: the ranks' sum is the one-process loss (weight-0 pad rows
    included)."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(8, 10, generator=g)
    labels = torch.randint(0, 10, (8,), generator=g)
    w = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.float32)
    whole = cross_entropy(logits, labels, w)
    denom = torch.clamp(w.sum(), min=1.0)
    parts = sum(cross_entropy(logits[s], labels[s], w[s], denom)
                for s in (slice(0, 4), slice(4, 8)))
    torch.testing.assert_close(parts, whole, rtol=1e-6, atol=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks():
    """Both ranks' results of ``tests/_dist_workers.run``."""
    import _dist_workers

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_dist_workers.run, args=(r, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = sorted((queue.get(timeout=120) for _ in procs),
                     key=lambda o: o["rank"])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for o in out:
        assert "error" not in o, o
    return out


def test_global_batchnorm_matches_whole_batch(two_ranks):
    """Forward, input/weight/bias grads and running stats within 1e-6
    relative of nn.BatchNorm2d over the concatenated batch, on both ranks,
    over two steps with weight-0 pad rows; eval mode unchanged."""
    for o in two_ranks:
        assert o["backend"] == "gloo"
        assert o["bn_batches_tracked"] == (2, 2)
        for k, err in o["bn"].items():
            assert err <= BN_TOL, (o["rank"], k, err)


def test_bucketed_all_reduce_is_the_exact_sum(two_ranks):
    """Bitwise the sum of both ranks' tensors (fp32, fp64, int64, a strided
    view), in one bucket and in 64-byte buckets, on every rank."""
    for o in two_ranks:
        assert o["all_reduce_268435456"] and o["all_reduce_64"], o


def test_rows_replicas_and_draws_across_ranks(two_ranks):
    for o in two_ranks:
        assert o["gather_rows"] and o["place_replicated"], o
        assert o["sharded_draw"], o
    # the changed bit shows on rank 1 only
    assert [o["replica_check_fails"] for o in two_ranks] == [False, True]


@pytest.fixture(scope="module")
def mesh_ranks():
    """Both ranks' results of ``tests/_sharded_workers`` case ``mesh``: the
    (2, 1) and (1, 2) meshes, and the sharded k-th value."""
    import _sharded_workers

    out = _sharded_workers.spawn("mesh")
    for o in out:
        assert "error" not in o, o["error"]
    return out


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
def test_make_mesh_lays_out_data_and_model(mesh_ranks, layout):
    data, model = map(int, layout.split("x"))
    for o in mesh_ranks:
        m = o[f"mesh_{layout}"]
        assert m["shape"] == {"data": data, "model": model}
        assert m["sub_sizes"] == [data, model] and m["backend"] == "gloo"
        # rank r at (r // model, r % model): its rows of a batch of 4
        index = o["rank"] // model
        assert m["data_index"] == index
        assert m["rows"] == [index * 4 // data, (index + 1) * 4 // data]


def test_sharded_kth_value_across_ranks(mesh_ranks):
    """Pieces split unevenly (one rank three, one of them empty) over ties,
    ±0, negatives and denormals, int and tensor k: bitwise the sort's."""
    for o in mesh_ranks:
        assert all(o["kth_bitwise"]), o["kth_bitwise"]


def _tricky(n=4099, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g)
    x[::5] = 0.0
    x[1::9] = -0.0
    x[2::6] = -1.0
    x[3::11] = 2.0 ** -140  # a denormal
    return x


@pytest.mark.parametrize("k", [1, 3, 820, 2050, 4098, 4099])
def test_sharded_kth_value_matches_sort_and_jax(k):
    import jax.numpy as jnp

    from salun.dist.topk import kth_largest as jax_kth

    x = _tricky()
    pieces = [x[:1000], x[1000:1000], x[1000:3333], x[3333:]]
    got = kth_largest_sharded(pieces, k)
    want = kth_largest(x, k)
    ref = np.asarray(jax_kth(jnp.asarray(x.numpy()), k))
    assert got.view(torch.int32) == want.view(torch.int32)
    assert np.asarray(got).view(np.int32) == ref.view(np.int32)
    with pytest.raises(ValueError, match="outside"):
        kth_largest_sharded(pieces, x.numel() + 1)
