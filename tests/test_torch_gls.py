"""The whole-GLS kernel's plain twin against gnngls_tpu, move for move.

The JAX side runs K1 as tests/test_pallas_gls.py runs it on the CPU
(`gls_pallas(interpret=True)`) and the XLA engine `batched.run_fixed`, on the
same cases.  Accepted-move counts, per-iteration traces and best tours must
agree; a best tour may differ only where two tours tie in cost at the ulp
level (tour costs are sums in another order: see search/moves.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.search import batched as jbatched
from gnngls_tpu.search import moves as jmoves
from gnngls_tpu.search.pallas_gls import gls_pallas
from gnngls_tpu.utils import is_valid_tour, tour_cost
from gnngls_tpu_torch.search import batched as tbatched
from gnngls_tpu_torch.search import moves as tmoves
from gnngls_tpu_torch.search.gls_whole import gls_whole


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def instances(n, B, seed):
    rng = np.random.default_rng(seed)
    pos = rng.random((B, n, 2))
    return np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1).astype(np.float32)


def nn_tours(W):
    got = tbatched.nearest_neighbor_batch(torch.as_tensor(W)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbatched.nearest_neighbor_batch(jnp.asarray(W))))
    return got


def port(Ds, guides, inits, iters, pm):
    return gls_whole(torch.as_tensor(Ds), torch.as_tensor(np.ascontiguousarray(guides)),
                     torch.as_tensor(inits), n_iters=iters, perturbation_moves=pm)


def assert_best_match(n, Ds, tours, costs, ref_tours, ref_costs):
    for b in range(len(tours)):
        if not np.array_equal(tours[b], ref_tours[b]):
            assert is_valid_tour(n, tours[b].tolist())
            tol = 8 * np.finfo(np.float32).eps * abs(ref_costs[b])
            assert abs(tour_cost(Ds[b], tours[b]) - ref_costs[b]) <= tol
    np.testing.assert_allclose(costs, ref_costs, rtol=2e-6)


@pytest.mark.parametrize("n,B,iters,pm,seed", [
    (10, 3, 2, 4, 0), (15, 3, 2, 5, 1), (20, 2, 3, 6, 2), (20, 8, 5, 4, 3)])
def test_plain_gls_matches_jax(n, B, iters, pm, seed):
    Ds = instances(n, B, seed)
    inits = nn_tours(Ds)
    out = port(Ds, Ds[:, None], inits, iters, pm)
    t, c, m, tr_c, tr_m = (np.asarray(a) for a in gls_pallas(
        jnp.asarray(Ds), jnp.asarray(Ds), jnp.asarray(inits), n_iters=iters,
        perturbation_moves=pm, interpret=True))
    ref = jbatched.run_fixed(Ds, Ds[:, None], inits, n_iters=iters, perturbation_moves=pm)
    np.testing.assert_array_equal(out.moves.numpy(), m.astype(int))
    np.testing.assert_array_equal(out.moves.numpy(), ref.trace_n)
    np.testing.assert_array_equal(out.trace_moves.numpy(), tr_m.astype(int))
    np.testing.assert_allclose(out.trace_costs.numpy(), tr_c, rtol=2e-6)
    assert_best_match(n, Ds, out.best_tours.numpy(), out.best_costs.numpy(), t, c)
    assert_best_match(n, Ds, out.best_tours.numpy(), out.best_costs.numpy(),
                      ref.best_tours, ref.best_costs)
    assert out.best_tours.dtype == torch.int32 and out.work.shape == (B, 2)


def test_plain_gls_regret_guide():
    n, B = 12, 2
    Ds, guide = instances(n, B, 5), instances(n, B, 99)
    inits = nn_tours(Ds)
    out = port(Ds, guide[:, None], inits, 2, 4)
    t, c, m, _, _ = gls_pallas(jnp.asarray(Ds), jnp.asarray(guide), jnp.asarray(inits),
                               n_iters=2, perturbation_moves=4, interpret=True)
    ref = jbatched.run_fixed(Ds, guide[:, None], inits, n_iters=2, perturbation_moves=4)
    np.testing.assert_array_equal(out.moves.numpy(), np.asarray(m).astype(int))
    np.testing.assert_array_equal(out.moves.numpy(), ref.trace_n)
    assert_best_match(n, Ds, out.best_tours.numpy(), out.best_costs.numpy(),
                      np.asarray(t), np.asarray(c))


def test_plain_gls_guide_cycling():
    n, B, iters, pm = 12, 2, 4, 4
    Ds = instances(n, B, 7)
    stack = np.stack([instances(n, B, 123), Ds], axis=1)
    inits = nn_tours(Ds)
    out = port(Ds, stack, inits, iters, pm)
    ref = jbatched.run_fixed(Ds, stack, inits, n_iters=iters, perturbation_moves=pm)
    np.testing.assert_array_equal(out.moves.numpy(), ref.trace_n)
    assert_best_match(n, Ds, out.best_tours.numpy(), out.best_costs.numpy(),
                      ref.best_tours, ref.best_costs)
    single = port(Ds, stack[:, :1], inits, iters, pm)
    assert not torch.equal(single.moves, out.moves)


def test_run_fixed_kernel_multi_guide_traces():
    n, B, iters = 10, 2, 3
    Ds = instances(n, B, 11)
    stack = np.stack([instances(n, B, 42), Ds], axis=1)
    inits = nn_tours(Ds)
    res = tbatched.run_fixed_kernel(Ds, stack, inits, n_iters=iters, perturbation_moves=4,
                                    device="cpu")
    want = jbatched.run_fixed_pallas(Ds, stack, inits, n_iters=iters, perturbation_moves=4,
                                     interpret=True)
    np.testing.assert_array_equal(res.chunk_moves, want.chunk_moves)
    np.testing.assert_array_equal(res.trace_moves, want.trace_moves)
    np.testing.assert_allclose(res.trace_costs, want.trace_costs, rtol=2e-6)
    np.testing.assert_array_equal(res.trace_n, want.trace_n)
    assert_best_match(n, Ds, res.best_tours, res.best_costs.astype(np.float32),
                      want.best_tours, want.best_costs.astype(np.float32))
    np.testing.assert_allclose(res.search_costs, res.best_costs, rtol=1e-6)


@pytest.mark.parametrize("n,seed", [(8, 0), (13, 1)])
def test_move_scans_match_jax(n, seed):
    """The batched move scans against gnngls_tpu/search/moves.py per tour."""
    rng = np.random.default_rng(seed)
    Ds = instances(n, 3, seed)
    tours = np.stack([np.r_[0, 1 + rng.permutation(n - 1), 0] for _ in range(3)]).astype(np.int32)
    M = tmoves.tour_matrix(torch.as_tensor(Ds), torch.as_tensor(tours).long())
    d2, i2, j2, f2 = tmoves.two_opt_a2a(M)
    dr, ir, jr, fr = tmoves.relocate_a2a(M)
    pos = torch.as_tensor([2, 1, n - 1])
    do, lo, hi, fo = tmoves.two_opt_o2a(M, pos)
    dq, jq, fq = tmoves.relocate_o2a(M, pos)
    for b in range(3):
        t, D = jnp.asarray(tours[b]), jnp.asarray(Ds[b])
        for (d, i, j, f), ref in (((d2, i2, j2, f2), jmoves.two_opt_a2a(t, D)),
                                  ((dr, ir, jr, fr), jmoves.relocate_a2a(t, D)),
                                  ((do, lo, hi, fo), jmoves.two_opt_o2a(t, D, jnp.int32(int(pos[b]))))):
            assert bool(f[b]) == bool(ref.found)
            if bool(ref.found):
                assert (int(i[b]), int(j[b])) == (int(ref.i), int(ref.j))
                assert float(d[b]) == float(ref.delta)
        ref = jmoves.relocate_o2a(t, D, jnp.int32(int(pos[b])))
        assert bool(fq[b]) == bool(ref.found)
        if bool(ref.found):
            assert int(jq[b]) == int(ref.j) and float(dq[b]) == float(ref.delta)
        a = tmoves.apply_two_opt(torch.as_tensor(tours[b:b + 1]), torch.tensor([2]),
                                 torch.tensor([n - 1]))
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(jmoves.apply_two_opt(t, 2, n - 1)))
        for i, j in ((1, n - 2), (n - 2, 1), (3, 4)):
            a = tmoves.apply_relocate(torch.as_tensor(tours[b:b + 1]), torch.tensor([i]),
                                      torch.tensor([j]))
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(jmoves.apply_relocate(t, i, j)))


def test_gls_wrapper_input_checks():
    D = torch.as_tensor(instances(6, 1, 0))
    T = torch.as_tensor(nn_tours(D.numpy()))
    with pytest.raises(TypeError):
        gls_whole(D, D, T.long(), n_iters=1)
    with pytest.raises(TypeError):
        gls_whole(D.double(), D, T, n_iters=1)
    with pytest.raises(ValueError):
        gls_whole(D, D, T[:, :-1], n_iters=1)
    with pytest.raises(ValueError):
        gls_whole(D, D, T, n_iters=-1)
    with pytest.raises(ValueError):  # not a CUDA device: no kernel, no twin
        gls_whole(D.to("meta"), D.to("meta"), T.to("meta"), n_iters=1)
