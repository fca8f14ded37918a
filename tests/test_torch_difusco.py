"""The port's DIFUSCO denoiser (models/difusco.py, evaluate.
predict_diffusion_guide) against the plain reference (portbench/reference/
difusco.py, in "f32": float32 products without TF32) at a small size, seeded
weights, and its path through `evaluate` and the CLI.

Tolerance: the reference follows the port's own trajectory (a draw within a
few ulps of pi may fall either way, after which two trajectories part), so
each step's p^ is compared on the same state and time step.  Both run the
same float32 products; the port gathers A h and V h after the products where
the reference gathers rows first, sums each city's edges along K where the
reference adds them in edge order, maps edge_embed's two rows where the
reference maps all E, and forms GroupNorm's statistics in another order: a
few ulps a layer, 2e-7 to 6e-7 here.  1e-5 of the largest value is more
than ten times that and a fiftieth of what TF32 products give (5e-4).

The `gpu` cases run the same comparisons on the card (the draws then come
from the card's generator on both sides); they skip without a CUDA device.
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
from gnngls_tpu_torch.data.generate import coords_to_distance_tensor
from gnngls_tpu_torch.models import difusco as dm
from gnngls_tpu_torch.models import gated_gcn as gg

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # the reference lives in the benchmark's tree
    sys.path.insert(0, str(ROOT))
from portbench.reference import difusco as ref  # noqa: E402
TSP10 = ROOT / "data" / "tsp10"
CFG = dict(hidden_dim=32, num_layers=2, sparse_factor=5, diffusion_steps=1000,
           inference_steps=4, schedule="cosine", aggregation="sum", norm="layer")
PUBLISHED = dict(hidden_dim=256, num_layers=12, sparse_factor=50, diffusion_steps=1000,
                 inference_steps=50, schedule="cosine", aggregation="sum", norm="layer")
SEED, DRAWS = 2302, 11
REL = 1e-5  # module docstring
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return name


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _model(device="cpu", cfg=CFG):
    buf = io.BytesIO()
    np.savez(buf, **ref.make_weights(cfg, SEED))
    buf.seek(0)
    return dm.load_model(buf, dm.DifuscoConfig(**cfg), device=device)


def _coords(B, n=20, seed=0):
    return np.random.default_rng(seed).random((B, n, 2), dtype=np.float32)


def _dataset(coords):
    N, n = coords.shape[:2]
    E = n * (n - 1) // 2
    return tds.TSPDataset.from_arrays(
        {"coords": coords, "regret": np.zeros((N, E), np.float32),
         "in_solution": np.zeros((N, E), bool), "opt_cost": np.ones(N)},
        scalers=tds.load_scalers(ROOT / "models" / "tsp100" / "scalers.json"))


def _port(coords, device="cpu", seed=DRAWS, batch=None, model=None):
    """The port's guides and, through a forward hook, each step's (t, x_t,
    p^) of every instance."""
    model = model or _model(device)
    steps = []
    hook = model.register_forward_hook(
        lambda m, a, out: steps.append((a[2], a[1].cpu().numpy(), out.cpu().numpy())))
    try:
        guides = tev.predict_diffusion_guide(
            model, _dataset(coords), coords_to_distance_tensor(coords, device),
            batch_size=batch or len(coords), device=device, seed=seed)
    finally:
        hook.remove()
    return guides, steps


def _follow(coords, steps, device="cpu", seed=DRAWS, batch=None, prec="f32"):
    """The reference on the port's trajectory (one batch)."""
    states = np.stack([x for _, x, _ in steps], axis=1)  # (N, S, n, K)
    return ref.predict(ref.make_weights(CFG, SEED), CFG, coords, seed=seed,
                       batch=batch or len(coords), states=states, prec=prec, device=device)


@pytest.mark.parametrize("device", DEVICES)
def test_every_step_and_the_guides_match_the_reference(device):
    device = _device(device)
    coords = _coords(3)
    guides, steps = _port(coords, device)
    assert [t for t, _, _ in steps] == [t for t, _ in ref.schedule(1000, 4)]
    out = _follow(coords, steps, device)
    p_port = np.stack([p for _, _, p in steps], axis=1).reshape(out["p"].shape)
    assert _rel(p_port, out["p"]) <= REL
    assert _rel(guides, out["guides"]) <= REL
    assert guides.shape == (3, 20, 20) and guides.dtype == np.float32
    # the port's draws are the reference's: x_T = [u < 1/2], then [u < pi]
    xs = np.stack([x for _, x, _ in steps], axis=1).reshape(out["u"].shape)
    np.testing.assert_array_equal(xs[:, 0], out["u"][:, 0] < 0.5)
    pi = np.clip(out["pi"][:, :-1], 0, 1)
    sure = np.abs(out["u"][:, 1:] - pi) > 1e-4
    np.testing.assert_array_equal(xs[:, 1:][sure], (out["u"][:, 1:] < pi)[sure])


def test_the_tf32_control_is_outside_the_tolerance():
    coords = _coords(2)
    _, steps = _port(coords)
    f32, tf32 = _follow(coords, steps), _follow(coords, steps, prec="tf32")
    assert _rel(tf32["p"], f32["p"]) > 10 * REL
    assert _rel(tf32["guides"], f32["guides"]) > 10 * REL


@pytest.mark.parametrize("s", [600, 0])
@pytest.mark.parametrize("x", [0, 1])
def test_posterior_is_its_closed_form(x, s):
    """pi from Bayes' rule with the two-state diffusion's closed form:
    Q^_t = a_t I + (1 - a_t) / 2, a_t = prod (1 - b), and Q = Q^_s^-1 Q^_t."""
    t, T = 700, 1000
    a = np.concatenate([[1.0], np.cumprod(1 - np.linspace(1e-4, 2e-2, T))])

    def qbar(t, i, j):
        return (1 + a[t]) / 2 if i == j else (1 - a[t]) / 2

    r = a[t] / a[s]
    Q1x = (1 + r) / 2 if x == 1 else (1 - r) / 2
    p = np.linspace(0.0, 1.0, 11)
    want = ((1 - p) * Q1x * qbar(s, 0, 1) / qbar(t, 0, x)
            + p * Q1x * qbar(s, 1, 1) / qbar(t, 1, x))
    if s == 0:
        want = p / qbar(t, 1, 1) if x == 1 else 0 * p
    model = _model()
    pt = torch.as_tensor(p, dtype=torch.float32)
    xs = torch.full(pt.shape, bool(x))
    got = model.posterior(pt, xs, t, s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    probs = torch.stack([1 - pt, pt], dim=1)
    np.testing.assert_allclose(ref.posterior(probs, xs, t, s, ref.q_bar(T)).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def test_the_cosine_schedule_at_T_1000():
    steps = dm.Difusco(dm.DifuscoConfig(hidden_dim=32, num_layers=1)).steps()
    assert steps == ref.schedule(1000, 50) and len(steps) == 50
    assert steps[:3] == [(1000, 969), (969, 938), (938, 906)]
    assert steps[-3:] == [(5, 2), (2, 1), (1, 0)]
    assert all(t > s for t, s in steps)
    assert all(s1 == t2 for (_, s1), (t2, _) in zip(steps, steps[1:]))
    assert [s for _, s in steps].count(0) == 1


@pytest.mark.parametrize("edges_of", [
    lambda c, k: dm.edge_list(coords_to_distance_tensor(c, "cpu"), k).numpy(),
    lambda c, k: np.stack([ref.edges(x, k) for x in c])], ids=["port", "reference"])
def test_the_edge_list_includes_the_city_and_breaks_ties_low(edges_of):
    k, n = 4, 9
    coords = _coords(2, n, seed=3)
    # instance 1, city 0: city 4 at 1/16, city 8 at 1/8, then cities 6 and 2
    # tied at 1/4 (exact in binary), every other city far
    coords[1] = [(0.5, 0.5), (0.0, 0.0), (0.5, 0.25), (1.0, 1.0), (0.5, 0.5625),
                 (0.0, 1.0), (0.25, 0.5), (1.0, 0.0), (0.625, 0.5)]
    nbr = edges_of(coords, k)
    assert nbr.shape == (2, n, k) and nbr.dtype == np.int64
    assert list(nbr[1, 0]) == [0, 4, 8, 2]  # the tie to the lower id
    assert (nbr[:, :, 0] == np.arange(n)).all()  # each city first, at distance 0
    D = ref.distances(coords)
    for b in range(2):
        for i in range(n):
            assert D[b, i][nbr[b, i]].max() <= np.sort(D[b, i])[k - 1]
    # the GCN's tags rest on the same order, the city itself left out
    tags = gg.knn_tags(torch.as_tensor(D), k - 1).numpy()
    for b in range(2):
        for i in range(n):
            assert sorted(np.flatnonzero(tags[b, i] == 1)) == sorted(set(nbr[b, i]) - {i})
    np.testing.assert_array_equal(
        gg.nearest_cities(torch.as_tensor(D), k - 1).numpy(), nbr[..., 1:])


@pytest.mark.parametrize("device", DEVICES)
def test_an_instance_does_not_depend_on_its_batch_mates(device):
    """GroupNorm is each instance's own: instance 0 beside other mates, with
    the same draws for it (the first rows of each draw), gets the same p^
    on the same states."""
    device = _device(device)
    a, b = _coords(3, seed=1), _coords(3, seed=2)
    b[0] = a[0]
    model = _model(device)
    D = coords_to_distance_tensor(a, device)
    nbr = dm.edge_list(D, 5)
    x = torch.rand(nbr.shape, generator=torch.Generator().manual_seed(5)).to(device) < 0.5
    with torch.no_grad():
        pa = model(torch.as_tensor(a, device=device), x, 700, nbr)
        pb = model(torch.as_tensor(b, device=device), x,
                   700, dm.edge_list(coords_to_distance_tensor(b, device), 5))
    assert _rel(pa[0].cpu(), pb[0].cpu()) <= REL
    ga, gb = _port(a, device)[0], _port(b, device)[0]
    assert _rel(ga[0], gb[0]) <= REL
    assert np.abs(ga[1:] - gb[1:]).max() > 1e-3  # the mates themselves differ


@pytest.mark.parametrize("device", DEVICES)
def test_a_seed_gives_its_trajectory(device):
    device = _device(device)
    coords = _coords(2)
    g1, s1 = _port(coords, device)
    g2, s2 = _port(coords, device)
    g3, s3 = _port(coords, device, seed=DRAWS + 1)
    np.testing.assert_array_equal(g1, g2)
    for (_, x1, _), (_, x2, _) in zip(s1, s2):
        np.testing.assert_array_equal(x1, x2)
    assert any((x1 != x3).any() for (_, x1, _), (_, x3, _) in zip(s1, s3))
    assert np.abs(g1 - g3).max() > 1e-3


def test_batches_draw_in_turn_from_one_generator():
    """Two batches of 2 and 1 draw, in turn, what the reference replays."""
    coords = _coords(3, seed=4)
    guides, steps = _port(coords, batch=2)
    assert len(steps) == 2 * 4 and [len(x) for _, x, _ in steps] == [2] * 4 + [1] * 4
    states = [np.stack([x[j] for _, x, _ in steps[:4]]) for j in range(2)]
    states.append(np.stack([x[0] for _, x, _ in steps[4:]]))
    out = ref.predict(ref.make_weights(CFG, SEED), CFG, coords, seed=DRAWS, batch=2,
                      states=states)
    assert _rel(guides, out["guides"]) <= REL
    own = ref.predict(ref.make_weights(CFG, SEED), CFG, coords, seed=DRAWS, batch=2, lanes=[2])
    np.testing.assert_array_equal(own["u"][0, 0] < 0.5, states[2][0].reshape(-1))


def test_the_guide_form():
    coords = _coords(2)
    guides, steps = _port(coords)
    nbr = dm.edge_list(coords_to_distance_tensor(coords, "cpu"), 5).numpy()
    np.testing.assert_array_equal(guides, guides.transpose(0, 2, 1))
    assert (np.diagonal(guides, axis1=1, axis2=2) == 0).all()
    on = np.zeros(guides.shape, bool)
    for b in range(2):
        on[b, np.repeat(np.arange(20), 5), nbr[b].reshape(-1)] = True
    on |= on.transpose(0, 2, 1)
    off = ~on & ~np.eye(20, dtype=bool)
    assert (guides[off] == 1).all() and (guides[on & ~np.eye(20, dtype=bool)] < 1).any()
    assert (guides >= 0).all() and (guides <= 1).all()


def test_parameter_count_and_names_at_the_published_widths():
    model = dm.Difusco()
    assert dm.DifuscoConfig() == dm.DifuscoConfig(**PUBLISHED)
    assert sum(p.numel() for p in model.parameters()) == 5_333_762
    shapes = ref.param_shapes(PUBLISHED)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    for bad in (dict(schedule="linear"), dict(aggregation="mean"), dict(norm="batch"),
                dict(hidden_dim=48)):
        with pytest.raises(ValueError):
            dm.DifuscoConfig(**bad)


def test_load_model_requires_every_name():
    w = ref.make_weights(CFG, SEED)
    w.pop("per_layer_out.1.2.bias")
    buf = io.BytesIO()
    np.savez(buf, **w)
    buf.seek(0)
    with pytest.raises(RuntimeError, match="per_layer_out.1.2.bias"):
        dm.load_model(buf, dm.DifuscoConfig(**CFG), device="cpu")


def _tsp10(k):
    data = dict(np.load(TSP10 / "instances.npz"))
    idx = np.loadtxt(TSP10 / "test.txt", dtype=np.int64)[:k]
    return tds.TSPDataset.from_arrays(data, idx, tds.load_scalers(TSP10 / "scalers.json"))


def test_evaluate_runs_difusco():
    ds = _tsp10(5)
    out = tev.evaluate(ds, model=_model(), guides=["regret_pred"], n_iters=3,
                       perturbation_moves=3, batch_size=2, device="cpu", seed=DRAWS)
    assert out["engine"] == "pallas"
    assert out["timings"]["predict_batches"] == out["timings"]["denoise_steps"] == 3 * 4
    n = ds.n_nodes
    for tours in (out["init_tours"], out["best_tours"]):
        assert tours.shape == (5, n + 1)
        assert (tours[:, 0] == tours[:, -1]).all()
        assert all(sorted(t[:-1]) == list(range(n)) for t in tours)
    want = ref.predict(ref.make_weights(CFG, SEED), CFG, ds.coords, seed=DRAWS, batch=2)
    assert out["guide_stack"].shape == (5, 1, n, n)
    # on the CPU at this size the reference's own draws meet the port's
    assert _rel(out["guide_stack"][:, 0], want["guides"]) <= REL
    assert np.all(out["gaps"] > -1e-4)


def test_cli_runs_a_difusco_checkpoint(tmp_path, capsys, monkeypatch):
    data = tmp_path / "tsp10"
    data.mkdir()
    for name in ("instances.npz", "scalers.json"):
        (data / name).symlink_to(TSP10 / name)
    (data / "test.txt").write_text("0\n1\n2\n")
    ckpt = tmp_path / "difusco"
    ckpt.mkdir()
    np.savez(ckpt / "model.npz", **ref.make_weights(CFG, SEED))
    (ckpt / "params.json").write_text(json.dumps(dict(CFG, arch="difusco")))
    seen = []
    real = tev.predict_diffusion_guide

    def kept(model, *a, **kw):
        seen.append((model, kw["seed"]))
        return real(model, *a, **kw)

    monkeypatch.setattr(tev, "predict_diffusion_guide", kept)
    tcli.main([str(data / "test.txt"), str(ckpt / "model.npz"), str(tmp_path / "runs"),
               "regret_pred", "--n_iters", "2", "--perturbation_moves", "3", "--batch_size",
               "2", "--device", "cpu"])
    assert "mean gap" in capsys.readouterr().out
    ((model, seed),) = seen
    assert isinstance(model, dm.Difusco) and model.cfg == dm.DifuscoConfig(**CFG)
    assert seed == 0
    assert len(list((tmp_path / "runs").iterdir())) == 1
