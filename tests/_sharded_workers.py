"""Workers of the sharded-state tests (``test_torch_{fsdp,tp,ckpt_sharded,
host_offload}.py``, ``test_torch_dist.py``) and of the sequence-, expert-
and pipeline-parallel ones (their cases in ``_parallel_workers.py``, the
2-D mesh cases on four ranks): two ranks of a gloo group on
the CPU (spawned, no JAX), each case run against its one-process meaning
on the tiny SD model of ``tests/_torch_port.sd_tiny_jax`` (U-Net ch 32, 2
heads, context 24; VAE ch 32; CLIP width 24, 2 layers, 8 tokens; 64×64
images, 8×8 latents). Results go back through a queue as ``{check:
value}``; a case that raises reports ``error``."""

import os

import torch

from salun_torch.dist import context as dist_ctx
from salun_torch.dist import fsdp, multihost, sharding
from salun_torch.dist.mesh import make_mesh


def tiny_sd(seed=0, remat=False):
    """The tiny SD modules with every weight moved off its init by
    0.05·N(0, 1) (so the zero-initialised output convs pass gradients)."""
    from salun_torch.sd import (CLIPTextConfig, SDModules, SDUNetConfig,
                                VAEConfig)

    sd = SDModules.create(
        SDUNetConfig(in_channels=4, out_channels=4, model_channels=32,
                     num_res_blocks=1, attention_resolutions=(1, 2),
                     channel_mult=(1, 2), num_heads=2, context_dim=24,
                     transformer_depth=1, remat=remat),
        VAEConfig(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1,
                  z_channels=4, embed_dim=4),
        CLIPTextConfig(vocab_size=49408, hidden_size=24, num_layers=2,
                       num_heads=2, max_length=8),
        num_timesteps=40, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for part in (sd.unet, sd.vae, sd.clip):
            for t in part.parameters():
                t.add_(0.05 * torch.randn(t.shape, generator=gen))
    return sd


def rl_batch(b, seed=3):
    g = torch.Generator().manual_seed(seed)
    img = lambda: torch.rand(b, 3, 64, 64, generator=g) * 2 - 1  # noqa: E731
    ids = lambda: torch.randint(0, 49408, (b, 8), generator=g)  # noqa: E731
    return {"forget_images": img(), "remain_images": img(),
            "forget_ids": ids(), "pseudo_ids": ids(), "remain_ids": ids()}


def half_mask(unet, seed=5):
    g = torch.Generator().manual_seed(seed)
    return {n: (torch.rand(p.shape, generator=g) < 0.5).to(torch.uint8)
            for n, p in unet.named_parameters()}


LR = 1e-4  # Adam's, as the --dp CLI tests
NOISE = 1e-6  # × the largest entry: below it a gradient is float noise


def rel_errs(got: dict, want: dict) -> float:
    """max over tensors of max|got − want| over the tensor's own max|want|;
    a tensor whose max|want| is below NOISE × the largest entry of all
    (a gradient that is zero in exact arithmetic, such as a bias in front
    of a GroupNorm: float noise near 1e-9) over that largest entry."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        w = w.double()
        scale = float(w.abs().max())
        d = float((got[k].double() - w).abs().max())
        worst = max(worst, d / (scale if scale > NOISE * top else top))
    return worst


def drift(got: dict, want: dict, rtol=1e-4, atol=1e-5) -> tuple:
    """(share of entries beyond atol + rtol·|want|, max |got − want|)."""
    bad = total = 0
    worst = 0.0
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        bad += int((d > atol + rtol * w.double().abs()).sum())
        total += w.numel()
        worst = max(worst, float(d.max()))
    return bad / total, worst


def _rl_run(batch_size, steps, remat, mesh):
    """``steps`` masked random_label steps of the tiny SD model at global
    batch ``batch_size`` (FSDP-sharded when ``mesh``); returns the
    gradients before Adam at each step, the losses and the final U-Net,
    all whole."""
    from salun_torch.sd.trainers import make_random_label_step, with_mask

    sd = tiny_sd(remat=remat)
    mask = half_mask(sd.unet)
    shapes = None
    if mesh is not None:
        specs = fsdp.fsdp_pspecs(sd.unet, mesh)
        fsdp.shard_fsdp(sd.unet, mesh, specs)
        shapes = {n: (list(fsdp.local(p).shape), specs[n], list(p.shape))
                  for n, p in sd.unet.named_parameters()}
    opt = with_mask(sd.unet, LR, "full", mask)
    grads = []
    inner = opt.step

    def step_and_keep():
        grads.append({n: fsdp.full_tensor(p.grad).detach().clone()
                      for n, p in zip(opt.names, opt.params)})
        inner()

    opt.step = step_and_keep
    step = make_random_label_step(sd, opt)
    gen = torch.Generator().manual_seed(11)
    losses = [float(step(rl_batch(batch_size, 3 + i), gen))
              for i in range(steps)]
    return {"grads": grads, "losses": losses, "shapes": shapes,
            "unet": fsdp.full_state_dict(sd.unet)}


def case_fsdp(mesh, out):
    """FSDP random_label steps against one process (without remat, which
    recomputes the same values), at a sharded batch of 2 (with and without
    remat) and a whole batch of 1; and the local shard shapes against the
    layout rule."""
    refs = {}
    for name, bs, remat in (("bs2", 2, False), ("bs2_remat", 2, True),
                            ("bs1_whole", 1, False)):
        if bs not in refs:  # remat recomputes the same values
            with dist_ctx.activate(None):
                refs[bs] = _rl_run(bs, 2, False, None)
        ref = refs[bs]
        with dist_ctx.activate(mesh):
            got = _rl_run(bs, 2, remat, mesh)
        start = tiny_sd().unet.state_dict()
        out[name] = {
            "grad_err": [rel_errs(g, r) for g, r in zip(got["grads"],
                                                        ref["grads"])],
            "loss": (got["losses"], ref["losses"]),
            "weights": drift(got["unet"], ref["unet"]),
            "weights_moved": max(float((v - start[k]).abs().max())
                                 for k, v in ref["unet"].items())}
        if name == "bs2":
            bad = [n for n, (loc, d, full) in got["shapes"].items()
                   if loc != [f // mesh.data if i == d else f
                              for i, f in enumerate(full)]]
            out["shapes_bad"] = bad
            out["n_sharded"] = sum(d is not None
                                   for _, d, _ in got["shapes"].values())


def _unet_loss(unet, b=2, seed=7):
    """A random_label-shaped loss of the U-Net alone: its output on noised
    latents fit to a fixed target, plus α·(noise prediction)."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(b, 4, 8, 8, generator=g)
    t = torch.randint(0, 40, (b,), generator=g).float()
    ctx = torch.randn(b, 8, 24, generator=g)
    target = torch.randn(b, 4, 8, 8, generator=g)
    noise = torch.randn(b, 4, 8, 8, generator=g)
    out = unet(z, t, ctx)
    return (out - target).square().mean() + 0.5 * (
        unet(z + noise, t, ctx) - noise).square().mean()


def case_tp(out):
    """make_mesh(1, 2): the mesh's axes; the TP U-Net's loss and gathered
    gradients against the unsharded U-Net's; its gathered state equals the
    weights it started from (the GEGLU permutation undone)."""
    mesh = make_mesh(data=1, model=2)
    out["mesh"] = {"shape": mesh.shape, "data_index": mesh.data_index,
                   "backend": mesh.backend, "rows": str(mesh.rows(4)),
                   "model_size": mesh.model_mesh.size(),
                   "data_size": mesh.data_mesh.size()}
    ref = tiny_sd().unet
    loss_ref = _unet_loss(ref)
    loss_ref.backward()
    grads_ref = {n: p.grad.clone() for n, p in ref.named_parameters()}
    tp = tiny_sd().unet
    sharding.shard_params(tp, mesh)
    local_q = tp.input_blocks[1][1].transformer_blocks[0].attn1.to_q.weight
    out["local_q"] = list(fsdp.local(local_q).shape)
    loss = _unet_loss(tp)
    loss.backward()
    out["loss"] = (float(loss), float(loss_ref))
    out["grad_err"] = rel_errs(sharding.full_grads(tp), grads_ref)
    start = tiny_sd().unet.state_dict()
    gathered = sharding.full_state_dict(tp)
    out["state_bitwise"] = all(torch.equal(gathered[k], v)
                               for k, v in start.items())
    from torch.distributed.tensor import Shard

    specs = sharding.sd_unet_pspecs(tp)
    out["n_sharded"] = sharding.count_sharded(specs)
    out["placements_as_specs"] = all(
        (fsdp.is_sharded(p) and p.placements == (Shard(specs[n]),))
        if specs[n] is not None
        else not any(isinstance(q, Shard)
                     for q in getattr(p, "placements", ()))
        for n, p in tp.named_parameters())


def case_mesh(out):
    """Both layouts of two ranks: (2, 1) and (1, 2)."""
    for data, model in ((2, 1), (1, 2)):
        m = make_mesh(data=data, model=model)
        out[f"mesh_{data}x{model}"] = {
            "shape": m.shape, "data_index": m.data_index,
            "rows": [m.rows(4).start, m.rows(4).stop],
            "sub_sizes": [m.data_mesh.size(), m.model_mesh.size()],
            "backend": m.backend}


def case_kth(out):
    """The sharded k-th value over pieces split unevenly across the ranks
    (one rank holding three pieces, one empty) against the sort of the
    whole buffer."""
    from salun_torch.dist.topk import kth_largest, kth_largest_sharded

    g = torch.Generator().manual_seed(0)
    x = torch.randn(5003, generator=g)
    x[::7] = 0.0
    x[1::11] = -0.0
    x[2::13] = 1.5
    x[3::17] = -2.25
    x[10], x[11] = 1e-40, -1e-40
    rank = torch.distributed.get_rank()
    pieces = ([x[:1200]] if rank == 0
              else [x[1200:1201], x[1201:1201], x[1201:]])
    same = []
    for k in (1, 2, 7, 700, 2501, 4999, 5003):
        a = kth_largest(x, k)
        b = kth_largest_sharded(pieces, k)
        c = kth_largest_sharded(pieces, torch.tensor(k))
        same.append(bool(a.view(torch.int32) == b.view(torch.int32)
                         == c.view(torch.int32)))
    out["kth_bitwise"] = same


def _save_state(opt):
    """The optimizer's state, whole, on every rank (keyed as
    :meth:`SDOptimizer.state`)."""
    st = opt.state()
    return {"unet": {n: fsdp.full_tensor(p).detach().clone()
                     for n, p in st["unet"].items()},
            "adam": {n: {k: fsdp.full_tensor(v).clone()
                         for k, v in s.items()}
                     for n, s in st["adam"].items()}}


def _like_tp(unet):
    """What a TP-sharded U-Net and its Adam state restore into: each tensor
    in the parameter's placement; the GEGLU's, whose rows are permuted,
    whole (then written in by ``sharding.load_full``)."""
    geglu = sharding._geglu_names(unet)
    like = {"unet": {}, "adam": {}}
    for n, p in unet.named_parameters():
        whole = n in geglu
        like["unet"][n] = torch.empty(p.shape) if whole else p.data
        like["adam"][n] = {
            "exp_avg": torch.empty(p.shape) if whole else torch.zeros_like(p),
            "exp_avg_sq": (torch.empty(p.shape) if whole
                           else torch.zeros_like(p)),
            "step": torch.zeros(())}
    return like


def _gather_tp(unet, like):
    geglu = sharding._geglu_names(unet)
    sharding.load_full(unet, {n: like["unet"][n] for n in geglu
                              if n in like["unet"]})
    state = sharding.full_state_dict(unet)
    adam = {}
    for n, s in like["adam"].items():
        adam[n] = {k: (v if n in geglu else fsdp.full_tensor(v))
                   for k, v in s.items()}
    return {"unet": {n: state[n] for n in like["unet"]}, "adam": adam}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a.float(), b.float())


def case_ckpt(out, tmp):
    """FSDP-sharded U-Net and Adam state (after one masked step) saved
    synchronously and asynchronously (a step taken while it writes), then
    restored into the tensor-parallel layout on the same two ranks."""
    from salun_torch.ckpt import restore_sharded, save_sharded
    from salun_torch.sd.trainers import make_random_label_step, with_mask

    mesh = make_mesh(data=2, model=1)
    with dist_ctx.activate(mesh):
        sd = tiny_sd()
        fsdp.shard_fsdp(sd.unet, mesh,
                        fsdp.fsdp_pspecs(sd.unet, mesh, min_size=256))
        opt = with_mask(sd.unet, 1e-3, "full", half_mask(sd.unet))
        step = make_random_label_step(sd, opt)
        gen = torch.Generator().manual_seed(11)
        step(rl_batch(2), gen)
        want = _save_state(opt)
        save_sharded(os.path.join(tmp, "sync"), opt.state())
        handle = save_sharded(os.path.join(tmp, "async"), opt.state(),
                              async_=True)
        step(rl_batch(2, 4), gen)  # changes the state while it writes
        handle.wait()
        after = _save_state(opt)
    out["step_moved_state"] = not _equal(after["unet"], want["unet"])
    if torch.distributed.get_rank() == 0:
        torch.save(want, os.path.join(tmp, "want.pt"))
    tp_mesh = make_mesh(data=1, model=2)
    for name in ("sync", "async"):
        unet = tiny_sd(seed=9).unet
        sharding.shard_params(unet, tp_mesh)
        like = restore_sharded(os.path.join(tmp, name), _like_tp(unet))
        out[f"tp_restore_{name}"] = _equal(_gather_tp(unet, like), want)


def case_offload(mesh, out):
    """``offloaded`` Adam over FSDP-sharded parameters (DTensor state
    parked as host shards) bitwise against plain Adam on the same shards;
    ``to_host``/``to_device`` keep a DTensor's placement."""
    from salun_torch.dist import host_offload
    from salun_torch.dist.host_offload import offloaded, to_device, to_host

    host_offload.BUCKET_BYTES = 64 << 10  # several buckets of tiny tensors
    with dist_ctx.activate(mesh):
        units = []
        for _ in range(2):
            u = tiny_sd().unet
            fsdp.shard_fsdp(u, mesh, fsdp.fsdp_pspecs(u, mesh, min_size=256))
            units.append(u)
        sharded = [[p for p in u.parameters() if fsdp.is_sharded(p)]
                   for u in units]
        plain = torch.optim.Adam(sharded[0], lr=1e-2)
        off = offloaded(torch.optim.Adam(sharded[1], lr=1e-2))
        for i in range(3):
            for a, b in zip(*sharded):
                g = torch.cos(fsdp.local(a).detach() * (i + 1))
                for p in (a, b):
                    p.grad = torch.zeros_like(p)
                    fsdp.local(p.grad).copy_(g)
            plain.step()
            off.step()
        out["offload_bitwise"] = all(
            torch.equal(fsdp.local(a), fsdp.local(b)) for a, b in
            zip(*sharded))
        st = off.optimizer.state[sharded[1][0]]
        out["offload_state_on_host"] = type(st["exp_avg"]).__name__
        t = sharded[0][0]
        back = to_device(to_host([t]), "cpu")[0]
        out["host_roundtrip"] = (fsdp.is_sharded(back)
                                 and back.placements == t.placements
                                 and torch.equal(fsdp.local(back),
                                                 fsdp.local(t)))


def run(case: str, rank: int, port: int, queue, tmp: str = "",
        world: int = 2) -> None:
    from _parallel_workers import CASES

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    out = {"rank": rank}
    try:
        mesh = dist_ctx.mesh_from_flags(world, "cpu")
        if case in CASES:
            CASES[case](out)
        elif case == "fsdp":
            case_fsdp(mesh, out)
        elif case == "offload":
            case_offload(mesh, out)
        elif case == "tp":
            case_tp(out)
        elif case == "mesh":
            case_mesh(out)
            case_kth(out)
        elif case == "ckpt":
            case_ckpt(out, tmp)
        else:
            raise ValueError(case)
    except Exception as e:  # reported to the test, which fails on it
        import traceback

        out["error"] = repr(e) + "\n" + traceback.format_exc()
    finally:
        multihost.shutdown()
        queue.put(out)


def spawn(case: str, tmp: str = "", timeout: float = 240,
          world: int = 2) -> list:
    """Every rank's result of ``run(case)`` in a gloo group of ``world``
    ranks, rank 0 first."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=run, args=(case, r, port, queue, tmp, world))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        out = sorted((queue.get(timeout=timeout) for _ in procs),
                     key=lambda o: o["rank"])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return out
