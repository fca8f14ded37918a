"""The reference's own inputs through the port, against gnngls_tpu, on the CPU.

* `load_scalers` on a pickled dict of sklearn MinMaxScalers, flat and nested
  under 'edges' (the reference's scalers.pkl): the same transforms as JAX's.
* `TSPDataset.from_reference_dir` on networkx gpickles built from data/tsp10
  with a scalers.pkl beside them: the same arrays as JAX's reader.
* `.pt` checkpoints: the shipped tsp20 weights go JAX params -> JAX
  `state_dict_from_params` -> torch.save -> the port's `load_checkpoint`.  The
  port's forward is held to JAX's per layer within 5e-4 (benchmarks/PARITY.md's
  scale) and to the npz-loaded model within 1e-6; the port's own export
  matches JAX's key for key and loads back to the same weights.
"""

import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.core import scaler as jscaler
from gnngls_tpu.core.graph import build_topology as jtopology
from gnngls_tpu.data import dataset as jds
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.models import torch_import as jti
from gnngls_tpu.ops import gat as jgat
from gnngls_tpu.ops.linear import linear as jlinear
from gnngls_tpu.ops.norm import batch_norm as jbatch_norm
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu_torch.core import scaler as tscaler
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.models import torch_import as tti
from gnngls_tpu_torch.models.convert import load_model
from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "models" / "tsp20" / "checkpoint_best_val.npz"
TAP_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sklearn_scalers(seed=0):
    from sklearn.preprocessing import MinMaxScaler

    rng = np.random.default_rng(seed)
    feats = rng.random((50, 3)) * [1.0, 5.0, 0.0]  # a constant column: zero range
    return {"features": MinMaxScaler().fit(feats),
            "regret": MinMaxScaler().fit(rng.random((50, 1)) * 3)}


def _same_scalers(a, b, width):
    assert a.keys() == b.keys()
    x = np.random.default_rng(1).random((4, 6, width)).astype(np.float32)
    for key in a:
        cols = x[..., :a[key].data_min_.shape[0]]
        np.testing.assert_array_equal(a[key].transform(cols), b[key].transform(cols))
        np.testing.assert_array_equal(a[key].inverse_transform(cols),
                                      b[key].inverse_transform(cols))


@pytest.mark.parametrize("nested", [False, True])
def test_load_scalers_from_sklearn_pickle(tmp_path, nested):
    sk = _sklearn_scalers()
    path = tmp_path / "scalers.pkl"
    path.write_bytes(pickle.dumps({"edges": sk} if nested else sk))
    mine, theirs = tscaler.load_scalers(path), jscaler.load_scalers(path)
    _same_scalers(mine, theirs, 3)
    x = np.random.default_rng(2).random((5, 3))
    np.testing.assert_allclose(mine["features"].transform(x), sk["features"].transform(x),
                               rtol=1e-12)
    other = type(sk["regret"])(feature_range=(-1, 1)).fit(np.ones((2, 1)))
    with pytest.raises(ValueError, match="feature_range"):
        tscaler.MinMaxScaler.from_sklearn(other)


def _write_reference_dir(root: pathlib.Path):
    """data/tsp10's test split as the reference stores it: one networkx
    gpickle an instance, a listing, and scalers.pkl."""
    import networkx as nx

    src = ROOT / "data" / "tsp10"
    ds = tds.TSPDataset.from_npz(src / "instances.npz", src / "test.txt",
                                 scalers_file=src / "scalers.json")
    n = ds.n_nodes
    us, vs = np.triu_indices(n, k=1)
    D = np.linalg.norm(ds.coords[:, :, None] - ds.coords[:, None], axis=-1)
    names = []
    for i in range(len(ds)):
        G = nx.Graph()
        for v in range(n):
            G.add_node(v, pos=tuple(float(c) for c in ds.coords[i, v]))
        for e, (u, v) in enumerate(zip(us, vs)):
            G.add_edge(int(u), int(v), weight=float(D[i, u, v]), features=ds.features[i, e],
                       regret=float(ds.regret[i, e]),
                       in_solution=bool(ds.in_solution[i, e]))
        names.append(f"graphs/instance_{i}.pkl")
        (root / "graphs").mkdir(exist_ok=True)
        (root / names[-1]).write_bytes(pickle.dumps(G))
    (root / "test.txt").write_text("\n".join(names) + "\n")
    (root / "scalers.pkl").write_bytes(pickle.dumps({"edges": _sklearn_scalers()}))
    return root / "test.txt", ds


def test_from_reference_dir_matches_jax(tmp_path):
    listing, src = _write_reference_dir(tmp_path)
    mine = tds.TSPDataset.from_reference_dir(listing)
    theirs = jds.TSPDataset.from_reference_dir(listing)
    for key in ("coords", "features", "regret", "in_solution", "opt_cost"):
        a, b = getattr(mine, key), getattr(theirs, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b)
    _same_scalers(mine.scalers, theirs.scalers, 3)
    assert len(mine) == len(src) and mine.n_nodes == 10
    np.testing.assert_array_equal(mine.in_solution, src.in_solution)
    np.testing.assert_allclose(mine.opt_cost, src.opt_cost, rtol=1e-6)
    explicit = tds.TSPDataset.from_reference_dir(
        listing, scalers_file=ROOT / "data" / "tsp10" / "scalers.json")
    np.testing.assert_array_equal(explicit.scalers["regret"].data_max_,
                                  src.scalers["regret"].data_max_)


def _jax_params():
    cfg = JM.RegretGNNConfig()
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0), cfg)
    params, bn, _, _ = jck.load_checkpoint(CKPT, params_like=p_like, bn_state_like=s_like)
    return params, bn, cfg


def _jax_taps(params, bn, cfg, x):
    topo = jtopology(20)
    h = jlinear(params.embed, jnp.asarray(x))
    taps = [np.asarray(h)]
    for lp, ls in zip(params.layers, bn.layers):
        h = h + jgat.gat_conv(lp.gat, topo, h, cfg.n_heads)
        h, _ = jbatch_norm(lp.bn1, ls.bn1, h, False)
        h = h + jlinear(lp.ffn2, jax.nn.relu(jlinear(lp.ffn1, h)))
        h, _ = jbatch_norm(lp.bn2, ls.bn2, h, False)
        taps.append(np.asarray(h))
    taps.append(np.asarray(jlinear(params.decision, h)))
    return taps


def _port_taps(model, x):
    taps = []
    with torch.no_grad():
        y = model(torch.as_tensor(x), taps=taps)
    return [t.numpy() for t in taps] + [y.numpy()]


@pytest.mark.parametrize("wrapped", [True, False])
def test_pt_checkpoint_round_trip(tmp_path, wrapped):
    params, bn, cfg = _jax_params()
    sd = jti.state_dict_from_params(params, bn)
    path = tmp_path / "checkpoint_best_val.pt"
    torch.save({"epoch": 7, "model_state_dict": sd, "loss": 0.5, "val_loss": 0.25}
               if wrapped else sd, path)
    model, meta = tti.load_checkpoint(path, RegretGNNConfig(), device="cpu")
    assert meta == ({"epoch": 7, "loss": 0.5, "val_loss": 0.25} if wrapped else {})

    root = ROOT / "data" / "tsp20"
    ds = tds.TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                                 scalers_file=root / "scalers.json")
    x = ds.get_scaled_batch([0, 1])["features"]
    mine = _port_taps(model, x)
    theirs = _jax_taps(params, bn, cfg, x)
    npz = _port_taps(load_model(CKPT, RegretGNNConfig(), device="cpu"), x)
    assert len(mine) == len(theirs) == len(npz) == cfg.depth + 2
    for i, (a, b, c) in enumerate(zip(mine, theirs, npz)):
        assert float(np.abs(a - b).max()) <= TAP_TOL, f"tap {i} vs JAX"
        assert float(np.abs(a - c).max()) <= 1e-6, f"tap {i} vs the npz model"


def test_pt_export_matches_jax_export(tmp_path):
    params, bn, _ = _jax_params()
    theirs = jti.state_dict_from_params(params, bn)
    model = load_model(CKPT, RegretGNNConfig(), device="cpu")
    mine = tti.state_dict_from_params(model)
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert mine[key].shape == theirs[key].shape, key
        torch.testing.assert_close(mine[key], theirs[key].to(mine[key].dtype), rtol=0,
                                   atol=0, msg=key)
    torch.save(mine, tmp_path / "m.pt")
    back, _ = tti.load_checkpoint(tmp_path / "m.pt", RegretGNNConfig(), device="cpu")
    for (ka, a), (kb, b) in zip(model.state_dict().items(), back.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    with pytest.raises(ValueError, match="layers"):
        tti.load_checkpoint(tmp_path / "m.pt", RegretGNNConfig(n_heads=4),
                            device="cpu")
