"""The port's host side against gnngls_tpu: topology, scalers, tour
utilities, datasets, the checkpoint reader and the weight conversion.

Inputs are made with numpy and handed to both packages; every comparison is
exact (these are index arrays and the same float64/float32 arithmetic).
"""

import pathlib
import pickle

import jax
import numpy as np
import pytest
import torch

from gnngls_tpu import utils as jutils
from gnngls_tpu.core import graph as jgraph
from gnngls_tpu.core import scaler as jscaler
from gnngls_tpu.data import dataset as jds
from gnngls_tpu.data import generate as jgen
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu_torch import utils as tutils
from gnngls_tpu_torch.core import graph as tgraph
from gnngls_tpu_torch.core import scaler as tscaler
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.data import generate as tgen
from gnngls_tpu_torch.models.convert import load_model, state_from_jax_numpy
from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig
from gnngls_tpu_torch.train.checkpoint import load_checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n", [5, 10, 100])
def test_topology_matches(n):
    a, b = jgraph.build_topology(n), tgraph.build_topology(n)
    for key in ("edges", "city_edges", "slot_u", "slot_v", "nbr"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
    assert (a.n, a.n_edges) == (b.n, b.n_edges)
    x = np.random.default_rng(n).random((2, a.n_edges)).astype(np.float32)
    np.testing.assert_array_equal(jgraph.edge_vector_to_matrix(x, n),
                                  tgraph.edge_vector_to_matrix(x, n))


@pytest.mark.parametrize("name", ["tsp20", "tsp100"])
def test_scalers_match(name, tmp_path):
    path = ROOT / "data" / name / "scalers.json"
    js, ts = jscaler.load_scalers(path), tscaler.load_scalers(path)
    assert js.keys() == ts.keys()
    x = np.random.default_rng(0).random((3, 7, 1)).astype(np.float32)
    for key in js:
        np.testing.assert_array_equal(js[key].transform(x), ts[key].transform(x))
        np.testing.assert_array_equal(js[key].inverse_transform(x),
                                      ts[key].inverse_transform(x))
    zero = tscaler.MinMaxScaler([1.0], [1.0])  # sklearn's zero-range guard
    np.testing.assert_array_equal(zero.scale_, [1.0])
    # the reference's pickled sklearn scalers read as JAX reads them
    from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler

    sk = {key: SkMinMaxScaler().fit(np.stack([js[key].data_min_, js[key].data_max_]))
          for key in js}
    pkl = tmp_path / "scalers.pkl"
    pkl.write_bytes(pickle.dumps(sk))
    jp, tp = jscaler.load_scalers(pkl), tscaler.load_scalers(pkl)
    for key in js:
        np.testing.assert_array_equal(jp[key].transform(x), tp[key].transform(x))
        np.testing.assert_array_equal(tp[key].transform(x), ts[key].transform(x))


@pytest.mark.parametrize("n", [5, 10, 100])
def test_tour_utilities_match(n):
    rng = np.random.default_rng(n)
    coords = rng.random((n, 2))
    D = jgen.coords_to_distance_matrix(coords)
    np.testing.assert_array_equal(D, tgen.coords_to_distance_matrix(coords))
    tour = np.concatenate([[0], 1 + rng.permutation(n - 1), [0]])
    assert jutils.tour_cost(D, tour) == tutils.tour_cost(D, tour)
    bad = tour.copy()
    bad[1] = bad[2]
    for t in (tour, bad, tour[:-1], np.r_[1, tour[1:]]):
        assert jutils.is_valid_tour(n, t) == tutils.is_valid_tour(n, t)


@pytest.mark.parametrize("name,idx", [("tsp10", [0, 3]), ("tsp20", [0, 5, 9]),
                                      ("tsp100", [0, 1])])
def test_scaled_batches_match(name, idx):
    root = ROOT / "data" / name
    args = (root / "instances.npz", root / "test.txt")
    a = jds.TSPDataset.from_npz(*args, scalers_file=root / "scalers.json")
    b = tds.TSPDataset.from_npz(*args, scalers_file=root / "scalers.json")
    assert (len(a), a.n_nodes, a.feat_dim) == (len(b), b.n_nodes, b.feat_dim)
    np.testing.assert_array_equal(jgen.coords_to_distance_matrix(a.coords[:2]),
                                  tgen.coords_to_distance_matrix(b.coords[:2]))
    for drop in ([], [0]):
        a.feat_drop_idx, b.feat_drop_idx = drop, drop
        ba, bb = a.get_scaled_batch(idx), b.get_scaled_batch(idx)
        assert ba.keys() == bb.keys()
        for key in ba:
            np.testing.assert_array_equal(ba[key], bb[key], err_msg=key)


def test_checkpoint_reader_and_conversion():
    path = ROOT / "models" / "tsp100" / "checkpoint_best_val.npz"
    cfg = JM.RegretGNNConfig()
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0), cfg)
    params, bn, _, meta = jck.load_checkpoint(path, params_like=p_like, bn_state_like=s_like)
    blobs, tmeta = load_checkpoint(path)
    assert tmeta == meta and not any(k.startswith("opt_state::") for k in blobs)
    model = load_model(path, RegretGNNConfig(), device="cpu")
    sd = model.state_dict()
    flat = jck._flatten(params)
    assert len(flat) + len(jck._flatten(bn)) == len(sd)
    np.testing.assert_array_equal(sd["layers.7.gat.attn_r"].numpy(),
                                  np.asarray(params.layers[7].gat.attn_r))
    np.testing.assert_array_equal(sd["layers.3.bn2.var"].numpy(),
                                  np.asarray(bn.layers[3].bn2.var))


@pytest.mark.parametrize("embed,heads,depth_from_heads", [(16, 2, True), (32, 4, False)])
def test_state_from_init_params(embed, heads, depth_from_heads):
    jcfg = JM.RegretGNNConfig(embed_dim=embed, n_heads=heads, n_layers=3,
                              depth_from_heads=depth_from_heads)
    params, bn = JM.init_params(jax.random.PRNGKey(1), jcfg)
    blobs = {f"params::{k}": v for k, v in jck._flatten(params).items()}
    blobs.update({f"bn_state::{k}": v for k, v in jck._flatten(bn).items()})
    state = state_from_jax_numpy(blobs)
    model = RegretGNN(RegretGNNConfig(embed_dim=embed, n_heads=heads, n_layers=3,
                                      depth_from_heads=depth_from_heads))
    model.load_state_dict(state, strict=True)
    assert len(model.layers) == jcfg.depth
    for key, arr in blobs.items():
        name = key.split("::")[1].replace("/", ".")
        np.testing.assert_array_equal(model.state_dict()[name].numpy(), arr)
    with pytest.raises(KeyError):
        state_from_jax_numpy({"weird": np.zeros(1)})
    assert isinstance(state["embed.w"], torch.Tensor)
