"""The port's multi-device layer (gnngls_tpu_torch/parallel, ops/gat_sharded.py,
ops/gat_ring.py, ops/tp.py, forward_ring, forward_tp) on gloo ranks of this
CPU, against gnngls_tpu's single-device functions.

The ranks start with torch.multiprocessing.spawn (init_method file:// under
tmp_path, one torch thread each) and run `tests/torch_dist_ranks.py`, which
imports neither jax nor gnngls_tpu; this parent computes JAX's results and
hands them over as numpy.  All scenarios of one world size run in one spawn.

Tolerances are those of the JAX package's own tests of each module:
  * gat_conv_sharded against gat_conv: rtol = atol = 2e-4 (tests/test_dist.py);
  * gat_conv_ring against gat_conv: 2e-5, forward_ring against forward: 3e-5
    (tests/test_gat_ring.py), at an n whose edge count needs padding;
  * ffn_tp: rtol 1e-5, atol 1e-6; forward_tp (train mode) and its BatchNorm
    running statistics: rtol 2e-4, atol 1e-5 (tests/test_tp.py);
  * the data-parallel train step against JAX's single-device gradient on the
    same tsp10 batch: the loss within 1e-5 relative, gradients and running
    statistics within 1e-4 of each leaf's scale (a vanishing leaf: 1e-5 of
    the largest), the bar tests/test_torch_train.py holds one process to;
    the statistics of one rank's shard alone miss it;
  * make_sharded_gls: tours, costs and moves equal to one process's
    run_fixed_kernel, tours equal to JAX's run_fixed (tests/test_dist.py).
Each rank also checks the ValueErrors: an uneven city split, an indivisible
hidden width, a batch that does not divide, a model axis of 3.

The same JAX results, written by the `slow` test_write_jax_dist_fixture into
gnngls_tpu_torch/testdata/jax_dist_results.pkl, hold the ranks on several
cards under NCCL (tests/test_torch_cuda.py); the gloo test checks that the
fixture still holds what JAX computes (rtol 1e-6).
"""

import pathlib
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from gnngls_tpu.core.graph import build_topology as jtopo
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.ops import gat as jgat
from gnngls_tpu.ops.linear import init_linear, linear
from gnngls_tpu.parallel import mesh as jmesh
from gnngls_tpu.search import batched as jbatched
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu.train import step as jstep
from gnngls_tpu_torch.ops import gat_ring
from gnngls_tpu_torch.parallel import mesh as pm
from gnngls_tpu_torch.parallel import multihost

import torch_dist_ranks
from test_torch_train import tsp10_batch

DIST_FIXTURE = (pathlib.Path(__file__).resolve().parent.parent
                / "gnngls_tpu_torch/testdata/jax_dist_results.pkl")


def blobs(params, bn):
    out = {f"params::{k}": np.asarray(v) for k, v in jck._flatten(params).items()}
    out.update({f"bn_state::{k}": np.asarray(v) for k, v in jck._flatten(bn).items()})
    return out


def port_keys(flat):
    return {k.replace("/", "."): np.asarray(v) for k, v in flat.items()}


def np_gat(params):
    return tuple(np.asarray(a) for a in params)


def jax_results(world: int) -> dict:
    """Everything the ranks compare with, from gnngls_tpu on one device."""
    out = {}
    # city-sharded conv (tests/test_dist.py's case)
    n, H, F = 16, 4, 8
    p = jgat.init_gat_params(jax.random.PRNGKey(0), H * F, H, F)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, jtopo(n).n_edges, H * F))
    out["sharded"] = dict(n=n, H=H, params=np_gat(p), x=np.asarray(x), n_uneven=11,
                          want=np.asarray(jgat.gat_conv(p, jtopo(n), x, H)))
    # ring conv at an n whose edges need padding over `world` ranks
    n = {2: 10, 4: 12}[world]
    p = jgat.init_gat_params(jax.random.PRNGKey(0), 5, H, F)
    x = jax.random.normal(jax.random.PRNGKey(1), (3, jtopo(n).n_edges, 5))
    assert gat_ring.padded_edges(jtopo(n).n_edges, world) > jtopo(n).n_edges
    out["ring"] = dict(n=n, H=H, params=np_gat(p), x=np.asarray(x),
                       want=np.asarray(jgat.gat_conv(p, jtopo(n), x, H)))
    # the whole model through the rings (tests/test_gat_ring.py's case)
    cfg_kw = dict(in_dim=1, embed_dim=16, n_heads=4, n_layers=2, hidden_dim=32,
                  depth_from_heads=False)
    params, bn = JM.init_params(jax.random.PRNGKey(2), JM.RegretGNNConfig(**cfg_kw))
    n = 16
    x = jax.random.uniform(jax.random.PRNGKey(3), (jtopo(n).n_edges, 1))
    want, _ = JM.forward(params, bn, jtopo(n), x, n_heads=4, train=False, gat_impl="fast")
    out["ring_model"] = dict(n=n, cfg=cfg_kw, blobs=blobs(params, bn), x=np.asarray(x),
                             want=np.asarray(want))
    # tensor-parallel FFN and model (tests/test_tp.py's cases)
    f1 = init_linear(jax.random.PRNGKey(0), 16, 64)
    f2 = init_linear(jax.random.PRNGKey(1), 64, 16)
    x = jax.random.normal(jax.random.PRNGKey(2), (5, 16))
    out["tp"] = dict(w1=np.asarray(f1.w), b1=np.asarray(f1.b), w2=np.asarray(f2.w),
                     b2=np.asarray(f2.b), x=np.asarray(x), odd_hidden=9,
                     want=np.asarray(linear(f2, jax.nn.relu(linear(f1, x)))))
    cfg_kw = dict(in_dim=1, embed_dim=32, n_heads=4, hidden_dim=64)
    params, bn = JM.init_params(jax.random.PRNGKey(0), JM.RegretGNNConfig(**cfg_kw))
    x = jax.random.uniform(jax.random.PRNGKey(1), (3, jtopo(12).n_edges, 1))
    want, want_bn = JM.forward(params, bn, jtopo(12), x, n_heads=4, train=True)
    out["tp_model"] = dict(cfg=cfg_kw, blobs=blobs(params, bn), x=np.asarray(x),
                           want=np.asarray(want), bn=port_keys(jck._flatten(want_bn)))
    # one data-parallel train step: tests/test_torch_train.py's first case
    cfg_kw = dict(embed_dim=16, n_heads=2, hidden_dim=32)
    params, bn = JM.init_params(jax.random.PRNGKey(0), JM.RegretGNNConfig(**cfg_kw))
    batch = tsp10_batch(np.arange(8))
    xb, yb = batch["features"], batch["regret"]

    def loss(p):
        pred, new_bn = JM.forward(p, bn, jtopo(10), jnp.asarray(xb), n_heads=2, train=True)
        return jstep.mse_loss(pred, yb), new_bn

    (jloss, jbn), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out["dp"] = dict(cfg=cfg_kw, blobs=blobs(params, bn), x=xb, y=yb, loss=float(jloss),
                     grads=port_keys(jck._flatten(jgrad)), bn=port_keys(jck._flatten(jbn)))
    # instance-sharded search (tests/test_dist.py's case)
    rng = np.random.default_rng(0)
    pos = rng.random((16, 12, 2))
    Ds = np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1).astype(np.float32)
    init = np.asarray(jbatched.nearest_neighbor_batch(jnp.asarray(Ds)))
    ref = jbatched.run_fixed(Ds, Ds[:, None], init, n_iters=2, perturbation_moves=4)
    out["gls"] = dict(D=Ds, init=init, n_iters=2, pm=4, jax_tours=np.asarray(ref.best_tours))
    return out


def _assert_same(a, b, path=""):
    """Nested results equal: arrays within rtol 1e-6, everything else exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("world", [2, 4])
def test_multi_device_layer_matches_jax_on_gloo_ranks(world, tmp_path):
    want = jax_results(world)
    # the fixture the card's multi-rank test reads holds these same results
    with open(DIST_FIXTURE, "rb") as f:
        _assert_same(want, pickle.load(f)[world])
    tmp.spawn(torch_dist_ranks.run, args=(world, str(tmp_path / "rendezvous"), want),
              nprocs=world, join=True)


@pytest.mark.slow
def test_write_jax_dist_fixture():
    """JAX's results for 2 and 4 ranks, for tests/test_torch_cuda.py's run on
    one NCCL rank per card (that machine has no jax)."""
    with open(DIST_FIXTURE, "wb") as f:
        pickle.dump({world: jax_results(world) for world in (2, 4)}, f)


def test_host_mesh_shape_keeps_model_groups_inside_nodes():
    assert multihost.host_mesh_shape(8, 4, 2) == (4, 2)
    assert multihost.host_mesh_shape(8, 2, 4) == (2, 4)  # a group spans two whole nodes
    assert multihost.host_mesh_shape(8, 8, 8) == (1, 8)
    for n, per_host, model in ((6, 3, 2), (12, 4, 3), (12, 4, 6)):
        with pytest.raises(ValueError, match="straddle"):
            multihost.host_mesh_shape(n, per_host, model)
    with pytest.raises(ValueError, match="divisible"):
        multihost.host_mesh_shape(8, 8, 3)
    with pytest.raises(ValueError, match="nodes"):
        multihost.host_mesh_shape(8, 3, 1)


def test_balanced_model_axis_is_jaxs():
    """make_mesh's default model axis: JAX's make_mesh on 1 to 8 devices."""
    for n in range(1, 9):
        want = jmesh.make_mesh(n, axes=("data", "model")).shape["model"]
        assert pm.balanced_model_size(n) == want


def test_ring_pad_round_trip():
    """tests/test_gat_ring.py's case, on numpy and on torch."""
    E = 120
    x = np.arange(E * 3, dtype=np.float32).reshape(E, 3)
    for arr in (x, torch.as_tensor(x)):
        xp = gat_ring.ring_pad(arr, 7, axis=0)
        assert xp.shape[0] == gat_ring.padded_edges(E, 7) == 126
        np.testing.assert_array_equal(np.asarray(gat_ring.ring_unpad(xp, E, axis=0)), x)
    assert gat_ring.ring_pad(x, 8, axis=0) is x


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_is_a_no_op_without_a_signal_and_idempotent(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "SLURM_STEP_NODELIST"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.host_local_batch_slice(32) == (0, 32)
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    multihost.initialize()  # a world of one is no launch
    assert not dist.is_initialized()
    multihost.initialize(coordinator_address=f"localhost:{_free_port()}", num_processes=1,
                         process_id=0)
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        multihost.initialize(coordinator_address="localhost:1", num_processes=1, process_id=0)
        mesh = pm.make_mesh(axes=("data", "model"))
        assert (mesh["data"].size(), mesh["model"].size()) == (1, 1)
    finally:
        dist.destroy_process_group()
