"""The port's residual gated GCN (models/gated_gcn.py) against the plain
reference (portbench/reference/gated_gcn.py, in "f32": float32 products
without TF32) on the CPU at a small size, and its path through `evaluate` and
the CLI.

Tolerance: the port and the reference run the same float32 products in the
same layout; only BatchNorm's statistics are summed in another order (the
port normalises (B n n, H) rows, the reference the published transposed
copies), a few ulps a layer that the residual stream carries on.  1e-5 of
the largest value is ten times what three layers read (about 1e-6) and a
fifteenth of what TF32 products give (1.5e-4).
"""

import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch.cli import test as tcli
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.models import gated_gcn as gg

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # the reference lives in the benchmark's tree
    sys.path.insert(0, str(ROOT))
from portbench.reference import gated_gcn as ref  # noqa: E402
TSP10 = ROOT / "data" / "tsp10"
CFG = dict(hidden_dim=16, num_layers=3, mlp_layers=3, num_neighbors=4, node_dim=2,
           voc_edges_in=3, voc_edges_out=2, aggregation="mean")
PUBLISHED = dict(hidden_dim=300, num_layers=30, mlp_layers=3, num_neighbors=20, node_dim=2,
                 voc_edges_in=3, voc_edges_out=2, aggregation="mean")
SEED = 2024
REL = 1e-5  # module docstring


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _model(cfg=CFG, seed=SEED):
    buf = io.BytesIO()
    np.savez(buf, **ref.make_weights(cfg, seed))
    buf.seek(0)
    return gg.load_model(buf, gg.GatedGCNConfig(**cfg), device="cpu")


def _coords(B, n=12, seed=0):
    return np.random.default_rng(seed).random((B, n, 2), dtype=np.float32)


def _inputs(coords, k=CFG["num_neighbors"]):
    D = ref.distances(coords)
    return coords, D, ref.knn_tags(D, k)


def _port(model, coords):
    c, D, tags = (torch.as_tensor(a) for a in _inputs(coords))
    with torch.no_grad():
        logits = model(c, D, tags)
    return logits, gg.edge_guide(logits)


def _reference(coords, cfg=CFG, seed=SEED):
    w = {k: torch.as_tensor(v) for k, v in ref.make_weights(cfg, seed).items()}
    c, D, tags = (torch.as_tensor(a) for a in _inputs(coords))
    with torch.no_grad(), ref.precision("f32"):
        logits = ref.forward(w, cfg, c, D, tags)
    return logits, ref.guides(logits)


def test_logits_and_guides_match_the_reference():
    coords = _coords(3)
    (lp, gp), (lr, gr) = _port(_model(), coords), _reference(coords)
    assert lp.shape == (3, 12, 12, 2) and gp.shape == (3, 12, 12)
    assert _rel(lp, lr) <= REL
    assert _rel(gp, gr) <= REL
    assert _rel(gp, ref.predict(ref.make_weights(CFG, SEED), CFG, coords, batch=3)) <= REL


def test_batchnorm_ties_an_instance_to_its_batch():
    model = _model()
    a, b = _coords(3, seed=1), _coords(3, seed=2)
    b[0] = a[0]  # the same instance beside other batch-mates
    (_, ga), (_, gb) = _port(model, a), _port(model, b)
    assert np.abs(ga[0].numpy() - gb[0].numpy()).max() > 1e-4
    for coords, guide in ((a, ga), (b, gb)):
        assert _rel(guide, _reference(coords)[1]) <= REL


@pytest.mark.parametrize("tags_of", [lambda D, k: gg.knn_tags(torch.as_tensor(D), k).numpy(),
                                     ref.knn_tags], ids=["port", "reference"])
def test_knn_tags(tags_of):
    k, n = 3, 9
    D = ref.distances(_coords(2, n, seed=3))
    # row 0 of instance 1: cities 4 and 8 nearest, then 2 and 6 tied for the
    # last place, every other city far
    D[1, 0, :] = D[1, :, 0] = 5.0
    D[1, 0, 0] = 0.0
    D[1, 0, 4] = D[1, 4, 0] = 0.5
    D[1, 0, 8] = D[1, 8, 0] = 0.75
    D[1, 0, [6, 2]] = D[1, [6, 2], 0] = 1.0
    tags = tags_of(D, k)
    assert tags.dtype == np.int64 and tags.shape == (2, n, n)
    assert (np.diagonal(tags, axis1=1, axis2=2) == 2).all()
    assert ((tags == 1).sum(-1) == k).all() and ((tags == 2).sum(-1) == 1).all()
    assert sorted(np.flatnonzero(tags[1, 0] == 1)) == [2, 4, 8]  # the tie to the lower id
    for b in range(2):  # the k nearest other cities
        for i in range(n):
            d = np.delete(D[b, i], i)
            assert D[b, i][tags[b, i] == 1].max() <= np.sort(d)[k - 1]
    assert ((tags_of(D, 50) == 1).sum(-1) == n - 1).all()  # k past n - 1: every other city


def test_edge_guide_is_one_less_the_symmetric_mean_probability():
    logits, guide = _port(_model(), _coords(2))
    p = torch.softmax(logits, -1)[..., 1]
    want = 1.0 - (p + p.transpose(1, 2)) / 2
    g = guide.numpy()
    np.testing.assert_array_equal(g, g.transpose(0, 2, 1))
    assert (np.diagonal(g, axis1=1, axis2=2) == 0).all()
    off = ~np.eye(12, dtype=bool)
    np.testing.assert_array_equal(g[:, off], want.numpy()[:, off])
    assert guide.dtype == torch.float32 and (g >= 0).all() and (g <= 1).all()


def test_parameter_count_at_the_published_widths():
    assert gg.GatedGCNConfig() == gg.GatedGCNConfig(**PUBLISHED)
    assert sum(p.numel() for p in gg.GatedGCN().parameters()) == 11_054_402
    assert sum(int(np.prod(s)) for s in ref.param_shapes(PUBLISHED).values()) == 11_054_402


def test_load_model_requires_every_name():
    w = ref.make_weights(CFG, SEED)
    w.pop("mlp_edges.V.bias")
    buf = io.BytesIO()
    np.savez(buf, **w)
    buf.seek(0)
    with pytest.raises(RuntimeError, match="mlp_edges.V.bias"):
        gg.load_model(buf, gg.GatedGCNConfig(**CFG), device="cpu")


def _tsp10(k):
    data = dict(np.load(TSP10 / "instances.npz"))
    idx = np.loadtxt(TSP10 / "test.txt", dtype=np.int64)[:k]
    return tds.TSPDataset.from_arrays(data, idx, tds.load_scalers(TSP10 / "scalers.json"))


@pytest.mark.parametrize("ran", [4, 2], ids=["as_asked", "halved"])
def test_evaluate_runs_the_gcn(monkeypatch, ran):
    """`ran` is the batch the forwards run in: "halved" plants half the asked
    batch, which predict_batches has to count as it ran."""
    calls = []
    real = tev.predict_edge_guide

    def counted(*a, **kw):
        calls.append(kw["batch_size"])
        return real(*a, **dict(kw, batch_size=ran))

    monkeypatch.setattr(tev, "predict_edge_guide", counted)
    ds = _tsp10(10)
    out = tev.evaluate(ds, model=_model(), guides=["regret_pred"], n_iters=3,
                       perturbation_moves=3, batch_size=4, device="cpu")
    assert calls == [4] and out["engine"] == "pallas"
    assert out["timings"]["predict_batches"] == -(-10 // ran)
    n = ds.n_nodes
    for tours in (out["init_tours"], out["best_tours"]):
        assert tours.shape == (10, n + 1)
        assert (tours[:, 0] == tours[:, -1]).all()
        assert all(sorted(t[:-1]) == list(range(n)) for t in tours)
    want = ref.predict(ref.make_weights(CFG, SEED), CFG, ds.coords, batch=ran)
    assert out["guide_stack"].shape == (10, 1, n, n)
    assert _rel(out["guide_stack"][:, 0], want) <= REL
    assert np.all(out["gaps"] > -1e-4)


def test_cli_runs_a_gcn_checkpoint(tmp_path, capsys, monkeypatch):
    data = tmp_path / "tsp10"
    data.mkdir()
    for name in ("instances.npz", "scalers.json"):
        (data / name).symlink_to(TSP10 / name)
    (data / "test.txt").write_text("0\n1\n2\n")
    ckpt = tmp_path / "gcn"
    ckpt.mkdir()
    np.savez(ckpt / "model.npz", **ref.make_weights(CFG, SEED))
    (ckpt / "params.json").write_text(json.dumps(dict(CFG, arch="gated_gcn")))
    seen = []
    real = tev.predict_edge_guide

    def kept(model, *a, **kw):
        seen.append(model)
        return real(model, *a, **kw)

    monkeypatch.setattr(tev, "predict_edge_guide", kept)
    tcli.main([str(data / "test.txt"), str(ckpt / "model.npz"), str(tmp_path / "runs"),
               "regret_pred", "--n_iters", "2", "--perturbation_moves", "3", "--batch_size",
               "2", "--device", "cpu"])
    assert "mean gap" in capsys.readouterr().out
    (model,) = seen
    assert isinstance(model, gg.GatedGCN) and model.cfg == gg.GatedGCNConfig(**CFG)
    assert len(list((tmp_path / "runs").iterdir())) == 1
