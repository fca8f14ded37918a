"""The per-move engine and the rest of evaluation against gnngls_tpu, on the CPU.

* The first-improvement scans against gnngls_tpu.search.moves: the same
  (i, j, found), deltas within 1e-6.
* Port `run_fixed` (the per-move engine, search/local_search.py) against JAX
  `run_fixed` for both first_improvement values, one guide and a two-guide
  cycle: the same trace counts and chunk moves, trace costs within rtol
  1e-6, best tours equal except where two tours tie in cost at the ulp level
  (tour costs are sums in another order: search/moves.py).
* `batch_init` + k x `batch_chunk(1)` equals `batch_chunk(k)` bit for bit;
  `run_wall_clock` stamps increasing boundaries and ends where `run_fixed`
  ends after as many iterations.
* `evaluate`'s engine routing for every engine / first_improvement /
  n_iters combination; `search_progress_records` against JAX's on the same
  result in both trace modes; `calibrate_protocol_iters` and
  `stats.paired_compare` against JAX's.
* The committed first-improvement JAX fixture of chip_smoke.py phase 14(d):
  its slow writer and a check of its header.
"""

import dataclasses
import json
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu import evaluate as jev
from gnngls_tpu import stats as jstats
from gnngls_tpu.data import dataset as jds
from gnngls_tpu.search import batched as jbatched
from gnngls_tpu.search import moves as jmoves
from gnngls_tpu.utils import is_valid_tour, tour_cost
from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch import stats as tstats
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.search import batched as tbatched
from gnngls_tpu_torch.search import gls_whole
from gnngls_tpu_torch.search import local_search as tls
from gnngls_tpu_torch.search import moves as tmoves

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, B, ITERS, PM = 20, 4, 3, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def instances(n, b, seed):
    rng = np.random.default_rng(seed)
    pos = rng.random((b, n, 2))
    return np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1).astype(np.float32)


def case(G, seed=0):
    Ds = instances(N, B, seed)
    stack = np.stack([instances(N, B, seed + 100), Ds][:G][::-1], axis=1)
    inits = np.array(jbatched.nearest_neighbor_batch(jnp.asarray(Ds)))
    return Ds, np.ascontiguousarray(stack), inits


def assert_best_match(n, Ds, tours, costs, ref_tours, ref_costs):
    for b in range(len(tours)):
        if not np.array_equal(tours[b], ref_tours[b]):
            assert is_valid_tour(n, tours[b].tolist())
            tol = 8 * np.finfo(np.float32).eps * abs(ref_costs[b])
            assert abs(tour_cost(Ds[b], tours[b]) - ref_costs[b]) <= tol
    np.testing.assert_allclose(costs, ref_costs, rtol=1e-6)


@pytest.mark.parametrize("n,seed", [(8, 0), (13, 1), (13, 2)])
def test_first_improvement_scans_match_jax(n, seed):
    rng = np.random.default_rng(seed)
    Ds = instances(n, 3, seed)
    tours = np.stack([np.r_[0, 1 + rng.permutation(n - 1), 0] for _ in range(3)]).astype(np.int32)
    M = tmoves.tour_matrix(torch.as_tensor(Ds), torch.as_tensor(tours).long())
    pos = torch.as_tensor([2, 1, n - 1])
    got = {"two_opt_a2a": tmoves.two_opt_a2a(M, True),
           "relocate_a2a": tmoves.relocate_a2a(M, True),
           "two_opt_o2a": tmoves.two_opt_o2a(M, pos, True)}
    dq, jq, fq = tmoves.relocate_o2a(M, pos, True)
    for b in range(3):
        t, D, p = jnp.asarray(tours[b]), jnp.asarray(Ds[b]), jnp.int32(int(pos[b]))
        want = {"two_opt_a2a": jmoves.two_opt_a2a(t, D, True),
                "relocate_a2a": jmoves.relocate_a2a(t, D, True),
                "two_opt_o2a": jmoves.two_opt_o2a(t, D, p, True)}
        for name, (d, i, j, f) in got.items():
            ref = want[name]
            assert bool(f[b]) == bool(ref.found), name
            if bool(ref.found):
                assert (int(i[b]), int(j[b])) == (int(ref.i), int(ref.j)), name
                assert abs(float(d[b]) - float(ref.delta)) <= 1e-6, name
        ref = jmoves.relocate_o2a(t, D, p, True)
        assert bool(fq[b]) == bool(ref.found)
        if bool(ref.found):
            assert int(jq[b]) == int(ref.j) and abs(float(dq[b]) - float(ref.delta)) <= 1e-6
    # the first improving candidate is improving, and no better than the best
    d_best, *_ = tmoves.two_opt_a2a(M)
    d_first, _, _, f = got["two_opt_a2a"]
    assert bool((d_first[f] >= d_best[f]).all())


@pytest.mark.parametrize("first_improvement,G", [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_run_fixed_matches_jax(first_improvement, G):
    Ds, stack, inits = case(G)
    ref = jbatched.run_fixed(Ds, stack, inits, n_iters=ITERS, perturbation_moves=PM,
                             first_improvement=first_improvement)
    res = tbatched.run_fixed(Ds, stack, inits, n_iters=ITERS, perturbation_moves=PM,
                             first_improvement=first_improvement, device="cpu")
    np.testing.assert_array_equal(res.trace_n, ref.trace_n)
    np.testing.assert_array_equal(res.chunk_moves, ref.chunk_moves)
    assert res.trace_costs.shape == ref.trace_costs.shape == (B, 4096)
    np.testing.assert_allclose(res.trace_costs, ref.trace_costs, rtol=1e-6)
    assert_best_match(N, Ds, res.best_tours, res.best_costs, np.asarray(ref.best_tours),
                      np.asarray(ref.best_costs))
    assert res.trace_moves is None and len(res.chunk_times) == 3
    if not first_improvement:  # the per-move engine is the twin's search, traced
        out = gls_whole.gls_whole(torch.as_tensor(Ds), torch.as_tensor(stack),
                                  torch.as_tensor(inits), n_iters=ITERS,
                                  perturbation_moves=PM)
        np.testing.assert_array_equal(res.best_tours, out.best_tours.numpy())
        np.testing.assert_array_equal(res.best_costs, out.best_costs.numpy())
        np.testing.assert_array_equal(res.trace_n, out.moves.numpy())
        np.testing.assert_array_equal(res.work, out.work.numpy())


@pytest.mark.parametrize("first_improvement", [False, True])
def test_engine_knobs_match_jax(first_improvement):
    """gls_init(max_ls_iters, k) and gls_iteration(max_pert_iters,
    max_ls_iters), as JAX's label oracles call them, against JAX's vmapped
    engine at n=12, B=4: the same tours and move counts, costs within rtol 1e-6."""
    import jax

    from gnngls_tpu.search import local_search as jls

    n, b, pm, iters = 12, 4, 6, 3
    Ds = instances(n, b, 5)  # an instance whose initial local search takes 6 rounds
    stack = np.stack([instances(n, b, 6), Ds], axis=1)
    inits = np.array(jbatched.nearest_neighbor_batch(jnp.asarray(Ds)))
    k = np.array([0.05, 0.2, 0.01, 0.1], np.float32)
    kw = dict(max_ls_iters=3, first_improvement=first_improvement)
    step = dict(perturbation_moves=pm, max_pert_iters=5, max_ls_iters=3,
                first_improvement=first_improvement)
    js = jax.vmap(lambda D, t, kk: jls.gls_init(D, t, trace_cap=256, k=kk, **kw))(
        jnp.asarray(Ds), jnp.asarray(inits), jnp.asarray(k))
    ts = tls.gls_init(torch.as_tensor(Ds), torch.as_tensor(inits), trace_cap=256,
                      k=torch.as_tensor(k), **kw)
    jstep_fn = jax.vmap(lambda s, D, G: jls.gls_iteration(s, D, G, **step))
    for it in range(iters + 1):
        if it:
            js = jstep_fn(js, jnp.asarray(Ds), jnp.asarray(stack))
            ts = tls.gls_iteration(ts, torch.as_tensor(Ds), torch.as_tensor(stack), **step)
        np.testing.assert_array_equal(ts.trace.n.numpy(), np.asarray(js.trace.n))
        np.testing.assert_array_equal(ts.tour.numpy(), np.asarray(js.tour))
        np.testing.assert_allclose(ts.cost.numpy(), np.asarray(js.cost), rtol=1e-6)
        np.testing.assert_allclose(ts.trace.costs.numpy(), np.asarray(js.trace.costs),
                                   rtol=1e-6)
    np.testing.assert_array_equal(ts.k.numpy(), k)
    np.testing.assert_array_equal(ts.best_tour.numpy(), np.asarray(js.best_tour))
    # the bounds bind: fewer rounds than the defaults (10 n, 3 pm) allow
    assert int(ts.work[:, 0].max()) <= 3 * (iters + 1) and int(ts.work[:, 1].max()) <= 5 * iters
    # a scalar k, and k=None's default, 0.1 * init_cost / n
    s1 = tls.gls_init(torch.as_tensor(Ds), torch.as_tensor(inits), k=0.5)
    s2 = tls.gls_init(torch.as_tensor(Ds), torch.as_tensor(inits))
    assert s1.k.shape == (b,) and bool((s1.k == 0.5).all())
    assert int(s2.work[:, 0].max()) > 3  # the default bound does not bind where 3 did
    init_cost = tmoves.tour_costs(torch.as_tensor(Ds), torch.as_tensor(inits).long())
    assert torch.equal(s2.k, (torch.full_like(init_cost, 0.1) * init_cost) / float(n))
    direct = tls.guided_local_search(torch.as_tensor(Ds), torch.as_tensor(stack),
                                     torch.as_tensor(inits), n_iters=1, perturbation_moves=pm,
                                     k=torch.as_tensor(k))
    assert torch.equal(direct.k, torch.as_tensor(k))
    ls = tls.local_search(torch.as_tensor(inits).long(), init_cost, torch.as_tensor(Ds),
                          tls.make_trace(b, 8, "cpu"), max_iters=1)
    assert bool((ls.trace.n <= 2).all()) and ls.tour.shape == (b, n + 1)


def _state_arrays(s):
    return [s.tour, s.cost, s.best_tour, s.best_cost, s.penalties, s.k, s.trace.costs,
            s.trace.n, s.work]


def test_chunks_compose_bit_for_bit():
    Ds, stack, inits = case(2, seed=3)
    s0 = tbatched.batch_init(Ds, stack, inits, trace_cap=64, device="cpu")
    before = [a.clone() for a in _state_arrays(s0)]
    s = s0
    for _ in range(3):
        s = tbatched.batch_chunk(s, Ds, stack, 1, PM)
    whole = tbatched.batch_chunk(s0, Ds, stack, 3, PM)
    direct = tls.guided_local_search(torch.as_tensor(Ds), torch.as_tensor(stack),
                                     torch.as_tensor(inits), n_iters=3, perturbation_moves=PM,
                                     trace_cap=64)
    assert s.iter_i == whole.iter_i == direct.iter_i == 3
    for a, b, c in zip(_state_arrays(s), _state_arrays(whole), _state_arrays(direct)):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(_state_arrays(s0), before):  # the input state is left as it was
        assert torch.equal(a, b)


def test_run_wall_clock_matches_run_fixed():
    Ds, stack, inits = case(1, seed=4)
    res = tbatched.run_wall_clock(Ds, stack, inits, time_limit_s=0.3, perturbation_moves=PM,
                                  device="cpu")
    chunks = len(res.chunk_times) - 1
    assert chunks >= 1 and res.chunk_moves.shape == (B, chunks + 1)
    assert all(b > a for a, b in zip(res.chunk_times, res.chunk_times[1:]))
    assert (np.diff(res.chunk_moves, axis=1) >= 0).all()
    assert res.chunk_times[-2] < res.deadline <= res.chunk_times[-1]
    fixed = tbatched.run_fixed(Ds, stack, inits, n_iters=chunks, perturbation_moves=PM,
                               device="cpu")
    for key in ("best_tours", "best_costs", "trace_costs", "trace_n", "work"):
        np.testing.assert_array_equal(getattr(res, key), getattr(fixed, key))
    np.testing.assert_array_equal(res.chunk_moves[:, [0, -1]], fixed.chunk_moves)


def test_run_wall_clock_widens_its_trace(monkeypatch):
    """Sized to the run (trace_cap None), the trace widens before a chunk
    could fill it: no move overwrites a row, and the rows are those of a
    fixed run over as many iterations with room for every move."""
    monkeypatch.setattr(tbatched, "TRACE_ROWS", 1)  # start at the initial search's 20 n
    Ds, stack, inits = case(1, seed=5)
    res = tbatched.run_wall_clock(Ds, stack, inits, time_limit_s=0.3, perturbation_moves=PM,
                                  device="cpu")
    rows = res.trace_costs.shape[1]
    assert rows >= 40 * N and (res.trace_n <= rows).all()
    fixed = tbatched.run_fixed(Ds, stack, inits, n_iters=len(res.chunk_times) - 1,
                               perturbation_moves=PM, trace_cap=rows, device="cpu")
    for key in ("best_tours", "best_costs", "trace_costs", "trace_n", "work"):
        np.testing.assert_array_equal(getattr(res, key), getattr(fixed, key), err_msg=key)


def test_evaluate_default_deadline_keeps_every_move():
    """The CLI's default run (the 10 s deadline) keeps a trace row for every
    accepted move: the progress rows are whole and nothing warns."""
    ds = _tiny()
    out = tev.evaluate(ds, guides=["weight"], device="cpu")
    res = out["result"]
    assert out["engine"] == "xla" and res.chunk_times[-1] - res.chunk_times[0] >= 9.0
    assert (res.trace_n <= res.trace_costs.shape[1]).all()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rows = tev.search_progress_records(ds, out)
    assert len(rows) == int(res.trace_n.sum()) > 0


def _tiny(k=2):
    root = ROOT / "data" / "tsp10"
    ds = tds.TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                                 scalers_file=root / "scalers.json")
    return dataclasses.replace(ds, coords=ds.coords[:k], features=ds.features[:k],
                               regret=ds.regret[:k], in_solution=ds.in_solution[:k],
                               opt_cost=ds.opt_cost[:k])


@pytest.mark.parametrize("engine", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("first_improvement", [False, True])
@pytest.mark.parametrize("n_iters", [None, 2])
def test_evaluate_routing(engine, first_improvement, n_iters):
    kw = dict(guides=["weight"], n_iters=n_iters, time_limit=0.05, engine=engine,
              first_improvement=first_improvement, perturbation_moves=4, device="cpu")
    if engine == "pallas" and (n_iters is None or first_improvement):
        with pytest.raises(ValueError, match="pallas"):
            tev.evaluate(_tiny(), **kw)
        return
    out = tev.evaluate(_tiny(), **kw)
    kernel = engine == "pallas" or (engine == "auto" and n_iters is not None
                                    and not first_improvement)
    assert out["engine"] == ("pallas" if kernel else "xla")
    assert out["trace_mode"] == ("per-iteration" if kernel else "per-move")
    assert out["device"] == "cpu" and out["gaps"].shape == (2,)
    res = out["result"]
    assert (res.trace_moves is not None) == kernel
    if n_iters is None:
        assert len(res.chunk_times) >= 2 and res.chunk_times[-1] >= res.chunk_times[0]
    for tour in out["best_tours"]:
        assert is_valid_tour(10, tour.tolist())


def test_evaluate_routing_past_the_kernel_range(monkeypatch):
    """Past gls_whole.MAX_N, "auto" takes the per-move engine."""
    monkeypatch.setattr(gls_whole, "MAX_N", 9)
    out = tev.evaluate(_tiny(), guides=["weight"], n_iters=1, perturbation_moves=4,
                       device="cpu")
    assert out["engine"] == "xla" and out["trace_mode"] == "per-move"
    with pytest.raises(ValueError, match="engine"):
        tev.evaluate(_tiny(), guides=["weight"], n_iters=1, engine="kernel", device="cpu")
    with pytest.raises(ValueError, match="time_limit or n_iters"):
        tev.evaluate(_tiny(), guides=["weight"], time_limit=None, device="cpu")


@pytest.mark.parametrize("mode", ["per-move", "per-iteration", "wall-clock"])
def test_search_progress_records_match_jax(mode):
    ds = _tiny()
    Ds = jev.coords_to_distance_matrix(ds.coords).astype(np.float32)
    inits = tbatched.nearest_neighbor_batch(torch.as_tensor(Ds)).numpy()
    if mode == "per-move":  # a cap of 8 rows saturates: both packages warn
        res = tbatched.run_fixed(Ds, Ds[:, None], inits, n_iters=3, perturbation_moves=4,
                                 trace_cap=8, device="cpu")
    elif mode == "wall-clock":
        res = tbatched.run_wall_clock(Ds, Ds[:, None], inits, time_limit_s=0.05,
                                      perturbation_moves=4, device="cpu")
    else:
        res = tbatched.run_fixed_kernel(Ds, Ds[:, None], inits, n_iters=3,
                                        perturbation_moves=4, device="cpu")
    out = {"result": res, "opt_costs": np.asarray(ds.opt_cost, np.float64)}
    saturated = bool((res.trace_n > res.trace_costs.shape[1]).any())
    assert saturated == (mode == "per-move")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = jev.search_progress_records(ds, out)
        got = tev.search_progress_records(ds, out)
    assert len(caught) == (2 if saturated else 0)
    assert len(got) == len(want) > 0
    assert got == want


def test_calibrate_protocol_iters_matches_jax():
    """A target between the two probes' means: the interpolation and the
    verify step both run, on the whole-search engine's twin here and on
    JAX's XLA engine there (the same moves)."""
    root = ROOT / "data" / "tsp20"
    subsets = []
    for mod in (tds, jds):
        full = mod.TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                                       scalers_file=root / "scalers.json")
        subsets.append(dataclasses.replace(
            full, coords=full.coords[:8], features=full.features[:8],
            regret=full.regret[:8], in_solution=full.in_solution[:8],
            opt_cost=full.opt_cost[:8]))
    mine, theirs = subsets
    probes = (2, 6)
    means = [float(np.mean(tev.evaluate(mine, guides=["weight"], n_iters=b,
                                        device="cpu")["moves"])) for b in probes]
    assert means[0] < means[1]
    target = 0.5 * (means[0] + means[1])
    got = tev.calibrate_protocol_iters(mine, target_moves=target, probe_budgets=probes,
                                       guides=["weight"], device="cpu")
    want = jev.calibrate_protocol_iters(theirs, target_moves=target, probe_budgets=probes,
                                        guides=["weight"])
    assert got == want and probes[0] < got <= probes[1]
    assert tev.REFERENCE_10S_MOVES == jev.REFERENCE_10S_MOVES


def test_paired_compare_matches_jax():
    rng = np.random.default_rng(7)
    a, b = rng.random(40), rng.random(40) + 0.05
    b[:5] = a[:5]
    kw = dict(n_boot=2000, n_perm=3000, seed=3)
    got, want = tstats.paired_compare(a, b, **kw), jstats.paired_compare(a, b, **kw)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(_values(got), _values(want), rtol=0, atol=1e-12)


def _values(d):
    """The numbers of a paired_compare result, flattened in key order."""
    out = []
    for v in d.values():
        if isinstance(v, dict):
            out += _values(v)
        elif isinstance(v, list):
            out += list(v)
        else:
            out.append(v)
    return out


# --- the first-improvement fixture of chip_smoke.py phase 14(d) ---------------------

FI_FIXTURE = ROOT / "gnngls_tpu_torch" / "testdata" / "jax_tsp100_test16_fi_it20.json"
FI_COMMAND = ("JAX_PLATFORMS=cpu python -m pytest "
              "tests/test_torch_per_move.py::test_write_jax_first_improvement_fixture -m slow")
FI_K, FI_ITERS, FI_PM = 16, 20, 20


@pytest.mark.slow
def test_write_jax_first_improvement_fixture():
    full = jds.TSPDataset.from_npz(ROOT / "data/tsp100/instances.npz",
                                   ROOT / "data/tsp100/test.txt",
                                   scalers_file=ROOT / "data/tsp100/scalers.json")
    ds = dataclasses.replace(full, coords=full.coords[:FI_K], features=full.features[:FI_K],
                             regret=full.regret[:FI_K], in_solution=full.in_solution[:FI_K],
                             opt_cost=full.opt_cost[:FI_K])
    out = jev.evaluate(ds, guides=["weight"], n_iters=FI_ITERS, perturbation_moves=FI_PM,
                       first_improvement=True)
    assert out["engine"] == "xla"
    doc = {
        "command": FI_COMMAND,
        "what": "gnngls_tpu.evaluate on the CPU (XLA engine): data/tsp100 test instances "
                "0-15, guide weight, nearest-neighbour tours on D, n_iters=20, "
                "perturbation_moves=20, first_improvement=True; best_cost is the "
                "search's own f32 accounting",
        "instances": list(range(FI_K)),
        "moves": [int(m) for m in out["result"].trace_n],
        "best_cost": [float(c) for c in out["best_costs"]],
        "best_tours": np.asarray(out["best_tours"]).astype(int).tolist(),
        "mean_gap": float(out["mean_gap"]),
    }
    FI_FIXTURE.write_text(json.dumps(doc, separators=(",", ":")) + "\n")
    assert FI_FIXTURE.stat().st_size < 40_000


def test_first_improvement_fixture_header():
    """The header names the command that wrote the fixture; the port's
    per-move engine reproduces its first two instances on the CPU."""
    fx = json.loads(FI_FIXTURE.read_text())
    assert fx["command"] == FI_COMMAND
    assert fx["instances"] == list(range(FI_K))
    assert len(fx["moves"]) == len(fx["best_cost"]) == len(fx["best_tours"]) == FI_K
    for tour in fx["best_tours"]:
        assert is_valid_tour(100, tour)
    k = 2
    full = tds.TSPDataset.from_npz(ROOT / "data/tsp100/instances.npz",
                                   ROOT / "data/tsp100/test.txt",
                                   scalers_file=ROOT / "data/tsp100/scalers.json")
    ds = dataclasses.replace(full, coords=full.coords[:k], opt_cost=full.opt_cost[:k])
    out = tev.evaluate(ds, guides=["weight"], n_iters=FI_ITERS, perturbation_moves=FI_PM,
                       first_improvement=True, device="cpu")
    np.testing.assert_array_equal(out["result"].trace_n, fx["moves"][:k])
    np.testing.assert_allclose(out["best_costs"], fx["best_cost"][:k], rtol=1e-6)
