"""The forced-edge label oracles and regret labels of the port against
gnngls_tpu on the CPU: K1's k input (on its plain twin), the warm and cold
oracles, `compute_regret` with every method, `warm_labels_chunked` and its
shards, and the committed JAX fixture of the tsp100 label path.

JAX runs its oracles on its XLA engine, as it does off the TPU; the port runs
K1's twin.  Both take the same moves, but their f32 tour-cost sums differ in
order (ROADMAP section 3), so where a search meets two tours of (nearly) one
cost, the packages may keep different ones: the same cycle run the other way,
or, with `dual_splice`, the other splice's tour.  Every lane is therefore held
as: the same tour, or the same cycle, or f64 costs within TIE_ULPS ulps of
f32 at the lane's big-M (the scale of the search's own f32 cost).  Regrets are
held to that cost tolerance over opt_cost.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.data import generate as jgen
from gnngls_tpu.data import labels as jlb
from gnngls_tpu.data import solvers as jsolvers
from gnngls_tpu.search import local_search as jls
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.data import labels as tlb
from gnngls_tpu_torch.data import solvers as tsolvers
from gnngls_tpu_torch.search import batched as tbatched
from gnngls_tpu_torch.search.gls_whole import gls_whole
from gnngls_tpu_torch.search.local_search import gls_fixed_plain, penalty_scale
from gnngls_tpu_torch.search.moves import tour_costs
from gnngls_tpu_torch.utils import is_valid_tour, tour_to_edge_vector

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "gnngls_tpu_torch" / "testdata" / "jax_tsp100_labels_0to7.npz"
TIE_ULPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def distances(n, B, seed):
    coords = np.random.default_rng(seed).random((B, n, 2)).astype(np.float32)
    return jgen.coords_to_distance_matrix(coords).astype(np.float64)


def tie(M):
    return TIE_ULPS * float(np.spacing(np.float32(M)))


def assert_lanes_match(n, tours, costs, ref_tours, ref_costs, M):
    """Each lane: the same tour, or the same cycle, or costs within tie(M)."""
    for t, c, rt, rc in zip(tours, costs, ref_tours, ref_costs):
        assert is_valid_tour(n, t)
        if not np.array_equal(t, rt) and not np.array_equal(
                tour_to_edge_vector(n, t), tour_to_edge_vector(n, rt)):
            assert abs(c - rc) <= tie(M), (c, rc, tie(M))


def test_k_input_on_the_twin_matches_jax():
    """gls_fixed_plain with a given k against JAX's guided_local_search with
    that k: moves equal, best tours the same cycles; with k=None the twin
    keeps the bits it gives when handed its own default k."""
    n, B, iters, pm = 15, 3, 3, 5
    Ds = distances(n, B, 0).astype(np.float32)
    inits = tbatched.nearest_neighbor_batch(torch.as_tensor(Ds))
    k = np.float32([0.02, 0.07, 0.2])
    got = gls_fixed_plain(torch.as_tensor(Ds), torch.as_tensor(Ds), inits, n_iters=iters,
                          perturbation_moves=pm, k=torch.as_tensor(k))
    want = jax.vmap(lambda D, t, kk: jls.guided_local_search(
        D, D[None], t, n_iters=iters, perturbation_moves=pm, k=kk))(
        jnp.asarray(Ds), jnp.asarray(inits.numpy()), jnp.asarray(k))
    np.testing.assert_array_equal(got.moves.numpy(), np.asarray(want.trace.n))
    for b in range(B):
        np.testing.assert_array_equal(
            tour_to_edge_vector(n, got.best_tours[b].numpy()),
            tour_to_edge_vector(n, np.asarray(want.best_tour[b])))
    D_t = torch.as_tensor(Ds)
    k_default = penalty_scale(tour_costs(D_t, inits.long()), n)
    a = gls_whole(D_t, D_t, inits, n_iters=iters, perturbation_moves=pm)
    b = gls_whole(D_t, D_t, inits, n_iters=iters, perturbation_moves=pm, k=k_default)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="k must be"):
        gls_whole(D_t, D_t, inits, n_iters=iters, k=k_default[:2])
    zero = gls_whole(D_t, D_t, inits, n_iters=0, k=torch.as_tensor(k))  # the label budget
    assert zero.trace_costs.shape == (B, 0)
    assert torch.equal(zero.best_tours, gls_whole(D_t, D_t, inits, n_iters=0).best_tours)


@pytest.mark.parametrize("n", [10, 20])
@pytest.mark.parametrize("iters", [0, 3])
@pytest.mark.parametrize("dual", [False, True])
def test_warm_batch_matches_jax(n, iters, dual):
    """Two instances from nearest-neighbour tours, all E edges."""
    Ds = distances(n, 2, n + iters)
    edges = build_topology(n).edges
    best = tbatched.nearest_neighbor_batch(torch.as_tensor(Ds.astype(np.float32))).numpy()
    jc, ju, jt = jsolvers.warm_fixed_edge_costs_batch(
        Ds, edges, best, n_gls_iters=iters, dual_splice=dual, inst_chunk=2)
    tc, tu, tt = tsolvers.warm_fixed_edge_costs_batch(
        Ds, edges, best, n_gls_iters=iters, dual_splice=dual, device="cpu")
    assert tu.all() and ju.all() and tt.dtype == np.int32 and tc.dtype == np.float64
    if iters == 0 and not dual:  # one local search from one splice: nothing to tie
        np.testing.assert_array_equal(tt, jt)
    for b in range(2):
        M = n * Ds[b].max() + 1.0
        assert_lanes_match(n, tt[b], tc[b], jt[b], jc[b], M)
        np.testing.assert_allclose(
            tc[b], Ds[b][tt[b][:, :-1], tt[b][:, 1:]].sum(-1), rtol=0, atol=0)


def test_warm_single_matches_jax_and_chunks_change_nothing(monkeypatch):
    """warm_fixed_edge_costs (its defaults: 2 GLS iterations, one splice, and
    with dual_splice) on one n=12 instance; launches of 7 lanes give the bits
    of one launch."""
    n = 12
    D = distances(n, 1, 3)[0]
    edges = build_topology(n).edges
    best, _ = jsolvers.held_karp(D)
    M = n * D.max() + 1.0
    for dual in (False, True):
        jc, ju, jt = jsolvers.warm_fixed_edge_costs(D, edges, np.asarray(best),
                                                    dual_splice=dual)
        tc, tu, tt = tsolvers.warm_fixed_edge_costs(D, edges, np.asarray(best),
                                                    dual_splice=dual, device="cpu")
        assert tu.all() and ju.all()
        assert_lanes_match(n, tt, tc, jt, jc, M)
    monkeypatch.setattr(tsolvers, "MAX_D2_BYTES", 7 * 4 * n * n)
    small = tsolvers.warm_fixed_edge_costs(D, edges, np.asarray(best), dual_splice=True,
                                           device="cpu")
    for a, b in zip(small, (tc, tu, tt)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [10, 11, 12])
def test_cold_oracle_matches_jax(n, monkeypatch):
    """gls_fixed_edge_costs (n_iters 10, pm 30): used equal, costs within
    tie(M) for M = sum(D) + 1 (the cost is the f32 search cost plus M);
    launches of 16 lanes give the bits of one launch."""
    D = distances(n, 1, 20 + n)[0]
    edges = build_topology(n).edges
    M = float(D.sum() + 1.0)
    jc, ju = jsolvers.gls_fixed_edge_costs(D, edges, n_iters=10, perturbation_moves=30)
    tc, tu = tsolvers.gls_fixed_edge_costs(D, edges, n_iters=10, perturbation_moves=30,
                                           device="cpu")
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=tie(M))
    monkeypatch.setattr(tsolvers, "MAX_D2_BYTES", 16 * 4 * n * n)
    small = tsolvers.gls_fixed_edge_costs(D, edges, n_iters=10, perturbation_moves=30,
                                          device="cpu")
    np.testing.assert_array_equal(small[0], tc)


def _dataset(N=3, n=8, seed=6):
    return jgen.generate_instances(N, n, seed=seed, solver="held_karp")


def test_compute_regret_every_method():
    """N=3, n=8, Held-Karp optima.  held_karp, native and auto (which takes
    native here) equal JAX's; gls and warm within the cost tolerance over
    opt_cost; lkh raises JAX's error while the binary is absent."""
    data = _dataset()
    opt = data["opt_cost"]
    for method in ("held_karp", "native", "auto"):
        got = tlb.compute_regret(dict(data), method=method, device="cpu")
        want = jlb.compute_regret(dict(data), method=method)
        np.testing.assert_array_equal(got, want)
    Ds = jgen.coords_to_distance_matrix(data["coords"]).astype(np.float64)
    for method in ("gls", "warm"):
        got = tlb.compute_regret(dict(data), method=method, n_iters=10, device="cpu")
        want = jlb.compute_regret(dict(data), method=method, n_iters=10)
        for i in range(len(opt)):
            np.testing.assert_allclose(got[i], want[i], rtol=0,
                                       atol=tie(Ds[i].sum() + 1.0) / opt[i])
        assert got.dtype == np.float32 and (got >= 0).all()
    with pytest.raises(RuntimeError) as err:
        jlb.compute_regret(dict(data), method="lkh")
    with pytest.raises(RuntimeError, match=str(err.value)):
        tlb.compute_regret(dict(data), method="lkh", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        tlb.compute_regret(dict(data), method="concorde", device="cpu")


def _assert_labels_match(got, want):
    n = got["coords"].shape[1]
    M = n * jgen.coords_to_distance_matrix(got["coords"]).max() + 1.0
    np.testing.assert_array_equal(got["in_solution"], want["in_solution"])
    np.testing.assert_allclose(got["opt_cost"], want["opt_cost"], rtol=0, atol=tie(M))
    for i in range(len(got["opt_cost"])):
        np.testing.assert_allclose(got["regret"][i], want["regret"][i], rtol=0,
                                   atol=tie(M) / want["opt_cost"][i])


def test_warm_labels_chunked_resumes_across_packages(tmp_path):
    """8 instances at n=12, shards of 3: each package's labels against the
    other's, its shard files, and each resuming the other's directory after a
    shard was lost (loaded shards are taken bit for bit)."""
    ref = {k: np.array(v) for k, v in _dataset(8, 12, 5).items()}
    want = jlb.warm_labels_chunked(dict(ref), tmp_path / "j", chunk=3)
    got = tlb.warm_labels_chunked(dict(ref), tmp_path / "t", chunk=3, device="cpu")
    _assert_labels_match(got, want)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == [
        "labels_00000000.npz", "labels_00000003.npz", "labels_00000006.npz"]
    for name in names:
        with np.load(tmp_path / "t" / name) as a, np.load(tmp_path / "j" / name) as b:
            assert a.files == b.files
            assert all(str(a[k]) == str(b[k]) for k in a.files if k.startswith("meta_"))

    (tmp_path / "j" / "labels_00000003.npz").unlink()
    mixed = tlb.warm_labels_chunked(dict(ref), tmp_path / "j", chunk=3, device="cpu")
    for key in ("regret", "opt_tour", "opt_cost"):
        np.testing.assert_array_equal(mixed[key][:3], want[key][:3])
        np.testing.assert_array_equal(mixed[key][6:], want[key][6:])
    _assert_labels_match(mixed, want)
    (tmp_path / "t" / "labels_00000006.npz").unlink()
    back = jlb.warm_labels_chunked(dict(ref), tmp_path / "t", chunk=3)
    np.testing.assert_array_equal(back["regret"][:6], got["regret"][:6])
    _assert_labels_match(back, got)


def test_warm_labels_chunked_refusals_and_bouts(tmp_path):
    """The overlap and extends-past refusals with JAX's messages; max_chunks
    bouts reproduce an unbounded run, as gnngls_tpu's test holds them."""
    ref = {k: np.array(v) for k, v in _dataset(8, 12, 5).items()}
    full = tlb.warm_labels_chunked(dict(ref), tmp_path / "full", chunk=3, device="cpu")
    out = None
    for bout in range(10):
        out = tlb.warm_labels_chunked(dict(ref), tmp_path / "b", chunk=2, max_chunks=1,
                                      device="cpu")
        if out is not None:
            break
    assert out is not None and bout == 3  # shards 0-2, then 3 and completion
    np.testing.assert_array_equal(out["regret"], full["regret"])

    shard = tmp_path / "full" / "labels_00000000.npz"
    for bad, what in (("labels_00000002.npz", "overlapping"), ("labels_00000007.npz",
                                                               "extends past")):
        d = tmp_path / what.replace(" ", "_")
        d.mkdir()
        (d / "labels_00000000.npz").write_bytes(shard.read_bytes())
        (d / "labels_00000003.npz").write_bytes(
            (tmp_path / "full" / "labels_00000003.npz").read_bytes())
        (d / bad).write_bytes(shard.read_bytes())
        with pytest.raises(ValueError, match=what) as err:
            jlb.warm_labels_chunked(dict(ref), d, chunk=3)
        with pytest.raises(ValueError, match=re.escape(str(err.value))):
            tlb.warm_labels_chunked(dict(ref), d, chunk=3, device="cpu")


def test_warm_labels_chunked_bounds_the_host(monkeypatch):
    """The oracle is called on groups of instances whose lane tours fit
    MAX_TOUR_BYTES.  n=500 with the oracle stubbed (its lanes cannot run
    here): the default budget takes two instances a call.  n=30, a budget of
    one instance's lane tours: one instance a call, and JAX's labels."""
    real = tsolvers.warm_fixed_edge_costs_batch
    sizes = []

    def stub(Ds, edges, best_tours, **kw):
        sizes.append(len(Ds))
        B, E, n = len(Ds), len(edges), Ds.shape[1]
        costs = np.full((B, E), 1e9)
        return costs, np.ones((B, E), bool), np.broadcast_to(best_tours[:, None], (B, E, n + 1))

    def spy(Ds, *args, **kw):
        sizes.append(len(Ds))
        return real(Ds, *args, **kw)

    n = 500
    coords = np.random.default_rng(4).random((5, n, 2)).astype(np.float32)
    tours = np.concatenate([np.tile(np.arange(n), (5, 1)), np.zeros((5, 1), int)], axis=1)
    data = dict(coords=coords, opt_tour=tours)
    monkeypatch.setattr(tsolvers, "warm_fixed_edge_costs_batch", stub)
    out = tlb.warm_labels_chunked(data, None, device="cpu")
    assert sizes == [2, 2, 1] and 2 * 2 * (n * (n - 1) // 2) * (n + 1) * 4 <= tlb.MAX_TOUR_BYTES
    assert out["regret"].shape == (5, n * (n - 1) // 2) and out["in_solution"].sum() == 5 * n

    n = 30
    coords = np.random.default_rng(11).random((2, n, 2)).astype(np.float32)
    ref = dict(coords=coords, opt_tour=tbatched.nearest_neighbor_batch(
        torch.as_tensor(jgen.coords_to_distance_matrix(coords))).numpy())
    sizes.clear()
    monkeypatch.setattr(tsolvers, "warm_fixed_edge_costs_batch", spy)
    monkeypatch.setattr(tlb, "MAX_TOUR_BYTES", 2 * (n * (n - 1) // 2) * (n + 1) * 4)
    got = tlb.warm_labels_chunked(dict(ref), None, device="cpu")
    assert sizes == [1, 1]
    _assert_labels_match(got, jlb.warm_labels_chunked(dict(ref), None))


@pytest.mark.slow
def test_write_jax_tsp100_labels_fixture(tmp_path):
    """Rewrites the fixture (about 100 s on the CPU): gnngls_tpu's
    warm_labels_chunked on raw data/tsp100 instances 0-7 from their shipped
    opt_tour, with the production settings (warm_gls_iters 0, dual splice,
    pm 20)."""
    with np.load(ROOT / "data" / "tsp100" / "instances.npz") as z:
        data = {k: z[k][:8] for k in ("coords", "opt_tour", "opt_cost", "in_solution")}
    out = jlb.warm_labels_chunked(data, tmp_path, chunk=250, warm_gls_iters=0,
                                  dual_splice=True, perturbation_moves=20)
    np.savez_compressed(FIXTURE, regret=out["regret"], opt_tour=out["opt_tour"],
                        opt_cost=out["opt_cost"])


def test_jax_labels_fixture():
    """Its shapes; instances 0-3 reproduce the shipped labels; instance 4's
    best tour was refined below the shipped one by a forced-edge tour."""
    with np.load(FIXTURE) as fx, np.load(ROOT / "data" / "tsp100" / "instances.npz") as z:
        assert fx["regret"].shape == (8, 4950) and fx["regret"].dtype == np.float32
        assert fx["opt_tour"].shape == (8, 101) and fx["opt_cost"].shape == (8,)
        np.testing.assert_allclose(fx["regret"][:4], z["regret"][:4], rtol=0, atol=1e-8)
        np.testing.assert_array_equal(fx["opt_tour"][:4], z["opt_tour"][:4])
        D = jgen.coords_to_distance_matrix(z["coords"][:8]).astype(np.float64)
        shipped = D[np.arange(8)[:, None], z["opt_tour"][:8, :-1], z["opt_tour"][:8, 1:]].sum(-1)
        assert fx["opt_cost"][4] < shipped[4] - 1e-9
        assert (fx["opt_cost"] <= shipped + 1e-12).all()
        for t in fx["opt_tour"]:
            assert is_valid_tour(100, t)
