"""The GAT group kernel's plain twin and the model against gnngls_tpu.

The JAX side runs K2 as its own tests run it on the CPU (Pallas interpret
mode), and the XLA city-group and naive paths.  Tolerances: the port sums in
another order than XLA, so the same f32 data differ at the rounding level;
per-layer taps of the shipped model are held to benchmarks/PARITY.md's scale
(<= 5e-4 absolute per tap at n=100).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.core.graph import build_topology as jtopology
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.ops import gat as jgat
from gnngls_tpu.ops import pallas_gat as jpallas
from gnngls_tpu.ops.linear import linear as jlinear
from gnngls_tpu.ops.norm import batch_norm as jbatch_norm
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.data.dataset import TSPDataset
from gnngls_tpu_torch.models.convert import load_model
from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig
from gnngls_tpu_torch.ops import gat as tgat
from gnngls_tpu_torch.ops.gat_group import (gat_conv_group, gat_group_partials,
                                            merge_group_partials)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, H, F, B, seed, spread=1.0):
    rng = np.random.default_rng(seed)
    c = H * F
    E = n * (n - 1) // 2
    w = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
    al = rng.standard_normal((H, F)).astype(np.float32)
    ar = rng.standard_normal((H, F)).astype(np.float32)
    x = (spread * rng.standard_normal((B, E, c))).astype(np.float32)
    return (w, al, ar), x


@pytest.mark.parametrize("n", [5, 10, 20])
@pytest.mark.parametrize("spread", [1.0, 10.0])
def test_group_conv_matches_jax(n, spread):
    H, F = 4, 8
    (w, al, ar), x = _inputs(n, H, F, 2, n, spread)
    jp = jgat.GATParams(jnp.asarray(w), jnp.asarray(al), jnp.asarray(ar))
    tp = tgat.GATParams(torch.as_tensor(w), torch.as_tensor(al), torch.as_tensor(ar))
    jt, tt = jtopology(n), build_topology(n)
    want = np.asarray(jpallas.gat_conv_pallas(jp, jt, jnp.asarray(x), H, interpret=True))
    ref = np.asarray(jgat.gat_conv(jp, jt, jnp.asarray(x), H))
    xt = torch.as_tensor(x)
    got = gat_conv_group(tp, tt, xt, H).numpy()
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(tgat.gat_conv(tp, tt, xt, H).numpy(), ref, rtol=0,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(tgat.gat_conv_naive(tp, tt, xt, H).numpy(),
                               np.asarray(jgat.gat_conv_naive(jp, jt, jnp.asarray(x), H)),
                               rtol=0, atol=2e-5 * scale)


def test_group_partials_match_jax_kernel():
    """m, z and num per group against the Pallas kernel's (lane-replicated)
    outputs, and the merge against the kernel's conv."""
    n, H, F = 10, 4, 8
    (w, al, ar), x = _inputs(n, H, F, 3, 7, 3.0)
    jp = jgat.GATParams(jnp.asarray(w), jnp.asarray(al), jnp.asarray(ar))
    jt = jtopology(n)
    h, el, er = jgat._project(jp, jnp.asarray(x), H)
    city = jnp.asarray(jt.city_edges)
    rep = lambda a: jnp.repeat(a, F, axis=-1)[:, city]  # noqa: E731
    m_j, z_j, num_j = (np.asarray(a) for a in jpallas._group_partials(
        rep(el), rep(er), h.reshape(3, -1, H * F)[:, city], interpret=True))
    tt = build_topology(n)
    m, z, num = gat_group_partials(
        torch.as_tensor(np.asarray(el)), torch.as_tensor(np.asarray(er)),
        torch.as_tensor(np.asarray(h)), torch.as_tensor(tt.city_edges))
    np.testing.assert_array_equal(m.numpy(), m_j[..., ::F])
    np.testing.assert_allclose(z.numpy(), z_j[..., ::F], rtol=1e-6)
    np.testing.assert_allclose(num.reshape(3, n, n - 1, H * F).numpy(), num_j,
                               rtol=0, atol=1e-5 * np.abs(num_j).max())
    out = merge_group_partials(m, z, num, tt).numpy()
    want = np.asarray(jpallas.gat_conv_pallas(jp, jt, jnp.asarray(x), H, interpret=True))
    np.testing.assert_allclose(out, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_group_partials_input_checks():
    tt = build_topology(5)
    el = torch.zeros((1, 10, 2))
    city = torch.as_tensor(tt.city_edges)
    with pytest.raises(TypeError):
        gat_group_partials(el.double(), el, torch.zeros((1, 10, 2, 8)), city)
    with pytest.raises(TypeError):
        gat_group_partials(el, el, torch.zeros((1, 10, 2, 8)), city.long())
    with pytest.raises(ValueError):
        gat_group_partials(el, el, torch.zeros((1, 9, 2, 8)), city)
    with pytest.raises(ValueError):  # not a CUDA device: no kernel, no twin
        gat_group_partials(el.to("meta"), el.to("meta"), torch.zeros((1, 10, 2, 8),
                           device="meta"), city.to("meta"))


def test_shipped_model_taps_match_jax():
    """Per-layer taps of the shipped tsp100 model at n=100, B=1, against the
    JAX forward with gat_impl='fast', through the port's group path (the
    kernel's plain twin on the CPU)."""
    root = ROOT / "data" / "tsp100"
    ds = TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                             scalers_file=root / "scalers.json")
    x = ds.get_scaled_batch([3])["features"]
    cfg = JM.RegretGNNConfig()
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0), cfg)
    path = ROOT / "models" / "tsp100" / "checkpoint_best_val.npz"
    params, bn, _, _ = jck.load_checkpoint(path, params_like=p_like, bn_state_like=s_like)
    topo = jtopology(100)
    h = jlinear(params.embed, jnp.asarray(x))
    taps = [np.asarray(h)]
    for lp, ls in zip(params.layers, bn.layers):
        h = h + jgat.gat_conv(lp.gat, topo, h, cfg.n_heads)
        h, _ = jbatch_norm(lp.bn1, ls.bn1, h, False)
        h = h + jlinear(lp.ffn2, jax.nn.relu(jlinear(lp.ffn1, h)))
        h, _ = jbatch_norm(lp.bn2, ls.bn2, h, False)
        taps.append(np.asarray(h))
    y_j = np.asarray(jlinear(params.decision, h))
    y_full, _ = JM.forward(params, bn, topo, jnp.asarray(x), n_heads=8, gat_impl="fast")
    np.testing.assert_array_equal(y_j, np.asarray(y_full))
    model = load_model(path, RegretGNNConfig())
    mine = []
    with torch.no_grad():
        y = model(torch.as_tensor(x), taps=mine).numpy()
    assert len(mine) == len(taps) == 9
    for i, (a, b) in enumerate(zip(mine, taps)):
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 5e-4, f"tap {i} max abs err {err:.2e}"
    assert float(np.abs(y - y_j).max()) <= 5e-4
