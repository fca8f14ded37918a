"""Rank bodies for the multi-device tests: the port's multi-device layer on
several gloo ranks of this CPU (tests/test_torch_dist.py), or on several
cards under NCCL, one rank each (tests/test_torch_cuda.py).

`torch.multiprocessing.spawn` re-imports this module in every child, so it
imports neither jax nor gnngls_tpu: the JAX package's single-device results
come as numpy (`run`'s `want`), computed by the parent or read from a
fixture it wrote.  Each rank checks its own outputs and raises on a
mismatch; spawn re-raises in the parent with the rank's traceback.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.models import regret_gat as TM
from gnngls_tpu_torch.models.convert import state_from_jax_numpy
from gnngls_tpu_torch.ops import gat as tgat
from gnngls_tpu_torch.ops import gat_ring, gat_sharded, tp
from gnngls_tpu_torch.ops.linear import Linear
from gnngls_tpu_torch.parallel import eval_shard, mesh as pm, multihost, train_dp
from gnngls_tpu_torch.search import batched
from gnngls_tpu_torch.train import step as tstep


DEV = torch.device("cpu")  # this rank's device, set by `run`


def t(a):
    """A numpy array as a tensor on this rank's device."""
    return torch.as_tensor(a, device=DEV)


def close(got, want, rtol, atol, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def raises(exc, fn, what):
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{what}: no {exc.__name__}")


def gat_params(arrays):
    return tgat.GATParams(*(t(a) for a in arrays))


def model_from(blobs, cfg_kw):
    model = TM.RegretGNN(TM.RegretGNNConfig(**cfg_kw))
    model.load_state_dict(state_from_jax_numpy(blobs), strict=True)
    return model.to(DEV)


def leaves_close(port: dict, want: dict, tol: float, vanishing: float, vanishing_tol: float,
                 what: str):
    """tests/test_torch_train.py's bar: each leaf within tol of its largest
    value, or, where that is below `vanishing` of the largest over all
    leaves, within vanishing_tol of that largest."""
    top = max(float(np.abs(v).max()) for v in want.values())
    for key, w in want.items():
        scale = float(np.abs(w).max())
        bar = vanishing_tol * top if scale < vanishing * top else tol * scale
        err = float(np.abs(port[key].detach().cpu().numpy() - w).max())
        if err > bar:
            raise AssertionError(f"{what} {key}: {err:.3e} > {bar:.3e}")


def check_sharded(world, w):
    mesh = pm.make_mesh(axes=("model",))
    c = w["sharded"]
    got = gat_sharded.gat_conv_sharded(gat_params(c["params"]), build_topology(c["n"]),
                                       t(c["x"]), c["H"], mesh)
    close(got, c["want"], 2e-4, 2e-4, "gat_conv_sharded")
    bad = build_topology(c["n_uneven"])
    raises(ValueError, lambda: gat_sharded.gat_conv_sharded(
        gat_params(c["params"]), bad, t(np.zeros((bad.n_edges, c["x"].shape[-1]))), c["H"],
        mesh), "uneven city split")


def check_ring(world, w):
    mesh = pm.make_mesh(axes=("model",))
    c = w["ring"]
    topo = build_topology(c["n"])
    xp = gat_ring.ring_pad(t(c["x"]), world)
    assert xp.shape[-2] == gat_ring.padded_edges(topo.n_edges, world)
    out = gat_ring.gat_conv_ring(gat_params(c["params"]), topo,
                                 gat_ring.edge_sharding(xp, mesh), c["H"], mesh, city_chunk=2)
    full = pm.all_gather_cat(out, mesh.get_group("model"), dim=-2)
    close(gat_ring.ring_unpad(full, topo.n_edges), c["want"], 2e-5, 2e-5, "gat_conv_ring")

    m = w["ring_model"]
    model = model_from(m["blobs"], m["cfg"]).eval()
    xp = gat_ring.ring_pad(t(m["x"]), world)
    out = TM.forward_ring(model, gat_ring.edge_sharding(xp, mesh), m["n"], mesh=mesh,
                          city_chunk=2)
    full = pm.all_gather_cat(out, mesh.get_group("model"), dim=-2)
    close(gat_ring.ring_unpad(full, build_topology(m["n"]).n_edges), m["want"], 3e-5, 3e-5,
          "forward_ring")


def check_tp(world, w):
    mesh = pm.make_mesh(axes=("model",))
    c = w["tp"]
    f1, f2 = Linear(*c["w1"].shape), Linear(*c["w2"].shape)
    with torch.no_grad():
        for lin, wt, b in ((f1, c["w1"], c["b1"]), (f2, c["w2"], c["b2"])):
            lin.w.copy_(torch.as_tensor(wt))
            lin.b.copy_(torch.as_tensor(b))
    s1, s2 = tp.shard_ffn_params(f1.to(DEV), f2.to(DEV), mesh)
    assert s1.w.shape[1] == c["w1"].shape[1] // world
    with torch.no_grad():
        got = tp.ffn_tp(s1, s2, t(c["x"]), mesh)
    close(got, c["want"], 1e-5, 1e-6, "ffn_tp")
    odd = Linear(8, c["odd_hidden"]), Linear(c["odd_hidden"], 8)
    raises(ValueError, lambda: tp.shard_ffn_params(*odd, mesh), "indivisible hidden width")

    m = w["tp_model"]
    model = model_from(m["blobs"], m["cfg"]).train()
    model_tp = TM.shard_params_tp(model, mesh)
    got = TM.forward_tp(model_tp, t(m["x"]), mesh=mesh)
    close(got, m["want"], 2e-4, 1e-5, "forward_tp")
    stats = {k: v for k, v in model_tp.state_dict().items() if k.endswith((".mean", ".var"))}
    for key, want in m["bn"].items():
        close(stats[key], want, 2e-4, 1e-5, f"forward_tp running statistic {key}")


def check_dp(world, w):
    mesh = pm.make_mesh(axes=("data",))
    c = w["dp"]
    model = model_from(c["blobs"], c["cfg"])
    opt = tstep.make_optimizer(model)
    train_step, eval_step = train_dp.make_dp_train_step(model, opt, mesh)
    sh = train_dp.shard_batch(mesh, {"x": c["x"], "y": c["y"]})
    assert sh["x"].shape[0] == c["x"].shape[0] // world
    loss = train_step(sh["x"], sh["y"])
    assert abs(float(loss) - c["loss"]) <= 1e-5 * abs(c["loss"]), (float(loss), c["loss"])
    grads = {name: p.grad for name, p in model.named_parameters()}
    leaves_close(grads, c["grads"], 1e-4, 1e-4, 1e-5, "dp grad")
    stats = {k: v for k, v in model.state_dict().items() if k.endswith((".mean", ".var"))}
    leaves_close(stats, c["bn"], 1e-4, 0.0, 0.0, "dp bn state")
    # the statistics follow the global batch: this rank's shard alone gives others
    local = model_from(c["blobs"], c["cfg"]).train()
    with torch.no_grad():
        local(sh["x"], gat_impl="fast")
    if world > 1:
        key = "layers.0.bn1.mean"
        mean = local.state_dict()[key].cpu().numpy()
        err = float(np.abs(mean - c["bn"][key]).max())
        assert err > 1e-4 * float(np.abs(c["bn"][key]).max()), "shard statistics match"
    assert np.isfinite(float(eval_step(sh["x"], sh["y"])))


def check_eval_shard(world, w):
    mesh = pm.make_mesh(axes=("data",))
    c = w["gls"]
    run = eval_shard.make_sharded_gls(mesh, n_iters=c["n_iters"], perturbation_moves=c["pm"])
    tours, costs, moves = run(c["D"], c["D"][:, None], c["init"])
    ref = batched.run_fixed_kernel(c["D"], c["D"][:, None], c["init"], n_iters=c["n_iters"],
                                   perturbation_moves=c["pm"], device=DEV)
    np.testing.assert_array_equal(tours, ref.best_tours)
    np.testing.assert_array_equal(costs, ref.best_costs.astype(np.float32))
    np.testing.assert_array_equal(moves, ref.chunk_moves[:, -1])
    np.testing.assert_array_equal(tours, c["jax_tours"])
    odd = c["D"][:world + 1]
    raises(ValueError, lambda: run(odd, odd[:, None], c["init"][:world + 1]), "uneven batch")


def check_mesh_and_hosts(world, rank):
    multihost.initialize()  # the group exists: a no-op
    mesh = pm.make_mesh(axes=("data", "model"))
    model = pm.balanced_model_size(world)
    assert (mesh["data"].size(), mesh["model"].size()) == (world // model, model)
    raises(ValueError, lambda: pm.make_mesh(n_devices=world + 1), "n_devices past the world")
    raises(ValueError, lambda: pm.data_sharding(mesh, np.zeros(world + 1)), "uneven data")
    assert multihost.host_local_batch_slice(4 * world) == (4 * rank, 4 * rank + 4)
    raises(ValueError, lambda: multihost.host_local_batch_slice(4 * world + 1), "uneven batch")
    hm = multihost.make_host_mesh(model_axis_size=2 if world % 2 == 0 else 1)
    assert hm["data"].size() * hm["model"].size() == world
    raises(ValueError, lambda: multihost.make_host_mesh(model_axis_size=3), "8 % 3 analogue")
    local = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 6 * rank
    full = multihost.global_array_from_host_shards(pm.make_mesh(), local).full_tensor()
    close(full, np.arange(6 * world, dtype=np.float32).reshape(2 * world, 3), 0, 0, "DTensor")


def run(rank: int, world: int, init_file: str, want: dict, device: str = "cpu") -> None:
    """One rank: set up the process group from `init_file` (gloo on the
    CPU; NCCL with device "cuda", card `rank`), run every scenario against
    `want` (JAX's results), tear the group down."""
    global DEV
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
        DEV = torch.device("cuda", rank)
    # a collective that waits longer than this fails the rank instead of hanging
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{init_file}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=2))
    try:
        check_mesh_and_hosts(world, rank)
        check_sharded(world, want)
        check_ring(world, want)
        check_tp(world, want)
        check_dp(world, want)
        check_eval_shard(world, want)
    finally:
        dist.destroy_process_group()
