"""The reference API of the port against gnngls_tpu on the CPU: the tour
helpers, the constructors of search/construct.py and compat.py's graph-level
functions.

* `is_equivalent_tour` and `weights_to_edge_vector` equal JAX's.
* `probabilistic_nearest_neighbour`: jax.random.categorical draws
  argmax(logits + Gumbel noise); the test draws that noise in JAX from the
  keys JAX's function splits (n-1 per tour, one split per sample for
  `best_*`) and passes it in: the tours must be identical, on a plain guide,
  one holding an inf entry (reachable, and only among visited cities), one
  with an all-zero row, and with `invert` on and off.
* `cheapest_insertion` and `insertion` (all three modes; "random" from the
  same numpy seed) return JAX's lists.
* compat over tests/test_compat.py's graphs: every function's output equals
  JAX's (set_labels' regrets exactly; the exact solvers are Held-Karp here,
  as no Concorde or LKH binary is installed); guided_local_search runs on the
  clock, so the common prefix of both packages' progress rows must hold the
  same costs, and where both ran the same number of iterations, the best tour
  and cost must be the same.  Costs within rtol 1e-6: the per-move engine's
  bar (tests/test_torch_per_move.py), as the packages sum a tour's edges in
  another order and the initial cost already differs by about an ulp.
"""

import time

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from gnngls_tpu import compat as jcompat
from gnngls_tpu.core import graph as jgraph
from gnngls_tpu.search import construct as jconstruct
from gnngls_tpu.utils import is_equivalent_tour as j_is_equivalent
from gnngls_tpu_torch import compat as tcompat
from gnngls_tpu_torch.core import graph as tgraph
from gnngls_tpu_torch.search import construct as tconstruct
from gnngls_tpu_torch.utils import is_equivalent_tour

from test_compat import make_graph


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_tour_helpers_match_jax():
    cases = [([0, 1, 2, 0], [0, 2, 1, 0]), ([0, 1, 2, 3, 0], [0, 2, 1, 3, 0]),
             ([0, 1, 2, 3, 0], [0, 1, 2, 3, 0]), ([0, 3, 2, 1, 0], [0, 1, 2, 3, 0]),
             (np.array([0, 1, 2, 0]), [0, 1, 2, 0, 0])]
    for a, b in cases:
        assert is_equivalent_tour(a, b) == j_is_equivalent(a, b)
    rng = np.random.default_rng(0)
    D = rng.random((3, 7, 7))
    D = D + np.swapaxes(D, -1, -2)
    for M in (D, D[0]):
        np.testing.assert_array_equal(tgraph.weights_to_edge_vector(M),
                                      jgraph.weights_to_edge_vector(M))
    np.testing.assert_array_equal(
        tgraph.edge_vector_to_matrix(tgraph.weights_to_edge_vector(D[0]), 7),
        D[0] * (1 - np.eye(7)))


def _jax_noise(key, n):
    """The Gumbel noise JAX's probabilistic_nearest_neighbour draws: one
    (n,) draw per split key of each step."""
    return np.stack([np.asarray(jax.random.gumbel(k, (n,), jnp.float32))
                     for k in jax.random.split(key, n - 1)])


def _guide(case, n, seed):
    rng = np.random.default_rng(seed)
    W = rng.random((n, n)).astype(np.float32) + 0.05
    W = W + W.T
    if case == "inf":  # an inf in the row of the depot, reachable
        W[0, 3] = W[3, 0] = np.inf
    elif case == "inf_visited":  # inf only towards the depot: visited, so uniform
        W[2, 0] = W[0, 2] = np.inf
    elif case == "zero_row":
        W[4, :] = W[:, 4] = 0.0
    np.fill_diagonal(W, 0.0)
    return W


@pytest.mark.parametrize("case", ["plain", "inf", "inf_visited", "zero_row"])
@pytest.mark.parametrize("invert", [True, False])
@pytest.mark.parametrize("depot", [0, 3])
def test_probabilistic_nearest_neighbour_matches_jax_on_its_noise(case, invert, depot):
    n = 9
    W = _guide(case, n, 11)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jconstruct.probabilistic_nearest_neighbour(key, jnp.asarray(W), depot,
                                                                     invert=invert))
        got = tconstruct.probabilistic_nearest_neighbour(
            torch.as_tensor(W), depot, invert=invert, noise=torch.as_tensor(_jax_noise(key, n)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert sorted(want[:-1].tolist()) == list(range(n)) and want[0] == want[-1] == depot


def test_best_probabilistic_nearest_neighbour_matches_jax_on_its_noise():
    n, n_iters = 12, 16
    rng = np.random.default_rng(4)
    pos = rng.random((n, 2))
    W = np.linalg.norm(pos[:, None] - pos[None], axis=-1).astype(np.float32)
    guide = (W * rng.random((n, n)) + 0.01).astype(np.float32)
    guide = guide + guide.T
    for g in (None, guide):
        key = jax.random.PRNGKey(7)
        want = np.asarray(jconstruct.best_probabilistic_nearest_neighbour(
            key, jnp.asarray(W), 0, n_iters, guide=None if g is None else jnp.asarray(g)))
        noise = np.stack([_jax_noise(k, n) for k in jax.random.split(key, n_iters)])
        got = tconstruct.best_probabilistic_nearest_neighbour(
            torch.as_tensor(W), 0, n_iters, guide=None if g is None else torch.as_tensor(g),
            noise=torch.as_tensor(noise))
        np.testing.assert_array_equal(got.numpy(), want)
    # the default noise comes from the generator: seeded, reproducible, a tour
    a, b = (tconstruct.best_probabilistic_nearest_neighbour(
        torch.as_tensor(W), 0, 4, generator=torch.Generator().manual_seed(1)) for _ in range(2))
    assert torch.equal(a, b) and sorted(a[:-1].tolist()) == list(range(n))


@pytest.mark.parametrize("mode", ["random", "nearest", "farthest"])
def test_insertion_matches_jax(mode):
    for n, seed in ((6, 0), (9, 1), (12, 2)):
        pos = np.random.default_rng(seed).random((n, 2))
        W = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        for depot in (0, n - 1):
            want = jconstruct.insertion(W, depot, mode, rng=np.random.default_rng(seed))
            got = tconstruct.insertion(W, depot, mode, rng=np.random.default_rng(seed))
            assert got == want
    sub = [0, 3, 1, 0]
    assert tconstruct.cheapest_insertion(W, sub, 5) == jconstruct.cheapest_insertion(W, sub, 5)
    with pytest.raises(ValueError):
        tconstruct.insertion(W, 0, "cheapest")


def _solved_graph(n, seed):
    G = make_graph(n, seed)
    tour = jcompat.optimal_tour(G)
    nx.set_edge_attributes(G, jcompat.tour_to_edge_attribute(G, tour), "in_solution")
    return G, tour


def test_compat_solvers_and_labels_match_jax():
    G, tour = _solved_graph(8, 0)
    assert tcompat.optimal_tour(G) == tour
    assert tcompat.tour_to_edge_attribute(G, tour) == jcompat.tour_to_edge_attribute(G, tour)
    assert tcompat.tour_cost(G, tour) == jcompat.tour_cost(G, tour)
    assert tcompat.optimal_cost(G) == jcompat.optimal_cost(G)
    for e in [(0, 3), (2, 5), (6, 7)]:
        assert tcompat.fixed_edge_tour(G, e) == jcompat.fixed_edge_tour(G, e)
    H = G.copy()
    jcompat.set_features(G)
    jcompat.set_labels(G)
    tcompat.set_features(H)
    tcompat.set_labels(H)
    for e in G.edges:
        assert H.edges[e]["regret"] == G.edges[e]["regret"]
        np.testing.assert_array_equal(H.edges[e]["features"], G.edges[e]["features"])
    for t in (tour, tour[::-1], tour[:-2] + tour[-1:]):
        assert tcompat.is_valid_tour(8, t) == jcompat.is_valid_tour(8, t)
        assert tcompat.is_equivalent_tour(tour, t) == jcompat.is_equivalent_tour(tour, t)


def test_compat_nearest_neighbor_and_gls_match_jax():
    G, _ = _solved_graph(9, 3)
    init = tcompat.nearest_neighbor(G, 0, device="cpu")
    assert init == jcompat.nearest_neighbor(G, 0)
    assert tcompat.nearest_neighbor(G, 4, device="cpu") == jcompat.nearest_neighbor(G, 4)
    cost = tcompat.tour_cost(G, init)
    runs = []
    for gls in (jcompat.guided_local_search,
                lambda *a, **kw: tcompat.guided_local_search(*a, device="cpu", **kw)):
        runs.append(gls(G, init, cost, time.time() + 1.5, perturbation_moves=5))
    (jt, jc, jp), (tt, tc, tp) = runs
    m = min(len(jp), len(tp))
    assert m > 0
    np.testing.assert_allclose([r["cost"] for r in tp[:m]], [r["cost"] for r in jp[:m]],
                               rtol=1e-6)
    assert all(set(r) == {"time", "cost"} for r in tp)
    assert tcompat.is_valid_tour(9, tt) and tc <= cost + 1e-6
    if len(jp) == len(tp):
        assert tt == jt and tc == pytest.approx(jc, rel=1e-6)


def test_compat_plot_edge_attribute():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    G = make_graph(6, 2)
    attr = {e: G.edges[e]["weight"] for e in G.edges}
    fig, ax = plt.subplots()
    tcompat.plot_edge_attribute(G, attr, ax)
    assert len(ax.collections) > 0
    plt.close(fig)
