"""The port's CUDA kernels against their plain twins, on the card.

Every test here carries the `gpu` marker and skips without a CUDA device.
The file imports neither jax nor gnngls_tpu, so it also runs where jax is
not installed, without the suite's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gnngls_tpu_torch import kernels
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
from gnngls_tpu_torch.ops.gat_group import (gat_group_partials, gat_group_partials_chunked,
                                            gat_group_partials_chunked_plain,
                                            gat_group_partials_plain)
from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
from gnngls_tpu_torch.search.gls_whole import gls_whole
from gnngls_tpu_torch.search.local_search import gls_fixed_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,H,F", [(5, 2, 8), (20, 4, 8), (50, 8, 16), (100, 8, 16), (30, 2, 32)])
def test_gat_group_kernel_matches_plain(cuda, n, H, F):
    rng = np.random.default_rng(n)
    E = n * (n - 1) // 2
    el, er = (torch.as_tensor(3 * rng.standard_normal((2, E, H)), dtype=torch.float32,
                              device=cuda) for _ in range(2))
    h = torch.as_tensor(rng.standard_normal((2, E, H, F)), dtype=torch.float32, device=cuda)
    city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=cuda)
    before = kernels.launches["gat_group"]
    got = gat_group_partials(el, er, h, city)
    torch.cuda.synchronize()
    assert kernels.launches["gat_group"] == before + 1
    want = gat_group_partials_plain(el, er, h, city)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)  # the same max
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("n,B,iters,pm,G", [(10, 3, 2, 4, 1), (20, 8, 5, 4, 2),
                                            (64, 3, 4, 10, 1), (138, 1, 1, 5, 1)])
def test_gls_kernel_matches_plain(cuda, n, B, iters, pm, G):
    rng = np.random.default_rng(n + G)
    D = coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32))
    R = rng.random((B, n, n))
    guides = np.stack([D, R + R.transpose(0, 2, 1)][:G], axis=1)
    Dt = torch.as_tensor(D, device=cuda)
    Gt = torch.as_tensor(np.ascontiguousarray(guides, dtype=np.float32), device=cuda)
    T = nearest_neighbor_batch(Dt)
    got = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
    torch.cuda.synchronize()
    want = gls_fixed_plain(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,H,F,gs", [(18, 4, 8, 8), (40, 4, 8, 8), (30, 2, 32, 16),
                                      (120, 8, 16, 64), (200, 8, 16, 40)])
def test_gat_group_chunked_kernel_matches_plain(cuda, n, H, F, gs):
    rng = np.random.default_rng(n + gs)
    E = n * (n - 1) // 2
    el, er = (torch.as_tensor(3 * rng.standard_normal((2, E, H)), dtype=torch.float32,
                              device=cuda) for _ in range(2))
    h = torch.as_tensor(rng.standard_normal((2, E, H, F)), dtype=torch.float32, device=cuda)
    city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=cuda)
    before = kernels.launches["gat_group_chunked"]
    got = gat_group_partials_chunked(el, er, h, city, gs)
    torch.cuda.synchronize()
    assert kernels.launches["gat_group_chunked"] == before + 1
    want = gat_group_partials_chunked_plain(el, er, h, city, gs)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)  # the same maxima
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _gls_case(n, B, G, seed, dev):
    rng = np.random.default_rng(seed)
    D = coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32))
    R = rng.random((B, n, n))
    guides = np.stack([D, R + R.transpose(0, 2, 1)][:G], axis=1)
    Dt = torch.as_tensor(D, device=dev)
    Gt = torch.as_tensor(np.ascontiguousarray(guides, dtype=np.float32), device=dev)
    return Dt, Gt, nearest_neighbor_batch(Dt)


@pytest.mark.parametrize("n,B,iters,pm,G", [(20, 4, 3, 6, 2), (100, 8, 2, 20, 1),
                                            (100, 8, 2, 20, 2), (138, 2, 1, 10, 1)])
def test_gls_global_layout_matches_shared(cuda, n, B, iters, pm, G):
    """The two state layouts differ only in addresses: the same bits."""
    Dt, Gt, T = _gls_case(n, B, G, n + 7 * G, cuda)
    shared = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm, layout="shared")
    glob = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm, layout="global")
    torch.cuda.synchronize()
    for a, b in zip(glob, shared):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,B,iters,pm,G", [(139, 2, 2, 10, 2), (257, 2, 1, 10, 1),
                                            (600, 1, 1, 5, 1)])
def test_gls_global_layout_matches_plain(cuda, n, B, iters, pm, G):
    Dt, Gt, T = _gls_case(n, B, G, n, cuda)
    before = kernels.launches["gls_whole"]
    got = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
    torch.cuda.synchronize()
    assert kernels.launches["gls_whole"] == before + 1
    want = gls_fixed_plain(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrappers_raise_on_bad_cuda_inputs(cuda):
    E = 10
    el = torch.zeros((1, E, 2), device=cuda)
    city = torch.as_tensor(build_topology(5).city_edges, device=cuda).long()
    with pytest.raises(TypeError):
        gat_group_partials(el, el, torch.zeros((1, E, 2, 8), device=cuda), city)
    h7 = torch.zeros((1, E, 2, 7), device=cuda)
    with pytest.raises(ValueError):
        gat_group_partials(el, el, h7, city.int())
    D = torch.zeros((1, 200, 200), device=cuda)
    with pytest.raises(ValueError):  # beyond the shared-memory layout
        gls_whole(D, D, torch.zeros((1, 201), dtype=torch.int32, device=cuda), n_iters=1,
                  layout="shared")
    D = torch.zeros((1, 1025, 1025), device=cuda)
    with pytest.raises(ValueError):  # beyond the global layout
        gls_whole(D, D, torch.zeros((1, 1026), dtype=torch.int32, device=cuda), n_iters=1)
