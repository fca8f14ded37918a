"""The per-move engine's perturbation seam on the CPU.

On CUDA tensors the per-move engine's perturbation is one launch of
csrc/gls_perturb.cu (search/gls_perturb.py); the kernel itself is held to the
twin bit for bit by the `gpu` cases of tests/test_torch_cuda.py.  Here:

* CPU tensors take the plain twin `_perturbation` and launch nothing;
* `gls_fixed_plain`, the whole-GLS kernel's twin, never reaches the seam;
* the invariant the wrapper relies on for `GLSState.rounds`: an outer
  iteration's lock-step perturbation rounds are the largest of the
  instances' own rounds (their `work[:, 1]` increase);
* the wrapper refuses what the kernel does not take, before any launch.
"""

import numpy as np
import pytest
import torch

from gnngls_tpu_torch import kernels
from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
from gnngls_tpu_torch.search import gls_perturb
from gnngls_tpu_torch.search import local_search as ls
from gnngls_tpu_torch.search.batched import run_fixed
from gnngls_tpu_torch.search.construct import nearest_neighbor_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(n, B, seed):
    rng = np.random.default_rng(seed)
    D = torch.as_tensor(coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32)))
    R = torch.as_tensor(rng.random((B, n, n)).astype(np.float32))
    return D, (R + R.transpose(1, 2))[:, None], nearest_neighbor_plain(D)


def _refuse(*a, **kw):
    raise AssertionError("reached the perturbation kernel's wrapper")


def test_cpu_tensors_take_the_twin(monkeypatch):
    D, G, T = _case(20, 4, 0)
    want = run_fixed(D, G, T, n_iters=3, perturbation_moves=6, device="cpu")
    monkeypatch.setattr(gls_perturb, "perturbation", _refuse)
    kernels.reset_launch_counts()
    got = run_fixed(D, G, T, n_iters=3, perturbation_moves=6, device="cpu")
    assert kernels.launches["gls_perturb"] == 0
    assert got.rounds == want.rounds and got.rounds[1] > 0
    np.testing.assert_array_equal(got.best_tours, want.best_tours)
    np.testing.assert_array_equal(got.work, want.work)


def test_gls_fixed_plain_never_reaches_the_kernel(monkeypatch):
    """The whole-GLS kernel's twin stays plain on every device: it calls the
    twin itself, never the engine's seam, which the per-move engine does
    reach."""
    D, G, T = _case(20, 4, 1)
    want = ls.gls_fixed_plain(D, G, T, n_iters=3, perturbation_moves=6)
    monkeypatch.setattr(ls, "_perturb", _refuse)
    monkeypatch.setattr(gls_perturb, "perturbation", _refuse)
    got = ls.gls_fixed_plain(D, G, T, n_iters=3, perturbation_moves=6)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    state = ls.gls_init(D, T)
    with pytest.raises(AssertionError, match="wrapper"):
        ls.gls_iteration(state, D, G, perturbation_moves=6)


@pytest.mark.parametrize("pm", [1, 5, 20])
@pytest.mark.parametrize("B", [1, 8])
def test_lockstep_rounds_are_the_largest_own_rounds(B, pm):
    """An instance is active on a prefix of the lock step's rounds, so the
    rounds the batch runs are the largest of its instances' own, in every
    outer iteration, and what `_perturbation` returns."""
    D, G, T = _case(24, B, 10 * B + pm)
    state = ls.gls_init(D, T, trace_cap=64)
    for it in range(4):
        work, rounds = state.work[:, 1].clone(), state.rounds[1]
        guide = G[:, it % G.shape[1]]
        probe = ls.clone_state(state)
        _, _, ran = ls._perturbation(D, guide, probe.penalties, probe.k, probe.tour, probe.cost,
                                     probe.trace, probe.work, pm, 3 * pm)
        assert ran == int((probe.work[:, 1] - work).max())
        state = ls.gls_iteration(state, D, G, perturbation_moves=pm)
        assert state.rounds[1] - rounds == int((state.work[:, 1] - work).max()) == ran
        assert torch.equal(state.work[:, 1], probe.work[:, 1])


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    D, G, T = _case(12, 2, 3)
    s = ls.gls_init(D, T)
    args = (D, G[:, 0], s.penalties, s.k, s.tour, s.cost, s.trace, s.work, 4, 12)
    with pytest.raises(ValueError, match="CUDA"):  # CPU tensors: the engine takes the twin
        gls_perturb.perturbation(*args)
    with pytest.raises(TypeError):
        gls_perturb.perturbation(D.double(), *args[1:])
    with pytest.raises(TypeError):
        gls_perturb.perturbation(*args[:4], s.tour.int(), *args[5:])
    with pytest.raises(ValueError, match="shapes"):
        gls_perturb.perturbation(*args[:4], s.tour[:, :-1], *args[5:])
