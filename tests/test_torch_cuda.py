"""The port's CUDA kernels against their plain twins, on the card; and one
train step on the card against the CPU, and a resumed run at full width.

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
from gnngls_tpu_torch.data.generate import coords_to_distance_matrix, coords_to_distance_tensor
from gnngls_tpu_torch.ops.gat_group import (gat_group_partials, gat_group_partials_chunked,
                                            gat_group_partials_chunked_plain,
                                            gat_group_partials_mxu,
                                            gat_group_partials_mxu_plain,
                                            gat_group_partials_plain)
from gnngls_tpu_torch.ops.gat_group import merge_group_partials
from gnngls_tpu_torch.ops.gat_group_sep import gat_sep_partials, gat_sep_partials_plain
from gnngls_tpu_torch.ops.gat_sorted import gat_sorted_partials, gat_sorted_partials_plain
from gnngls_tpu_torch.search.batched import run_fixed, run_wall_clock
from gnngls_tpu_torch.search import gls_perturb
from gnngls_tpu_torch.search import gls_whole as gls_whole_module
from gnngls_tpu_torch.search import local_search as tls
from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
from gnngls_tpu_torch.search.gls_whole import gls_whole
from gnngls_tpu_torch.search.gls_whole import max_n as gls_whole_max_n
from gnngls_tpu_torch.search.local_search import gls_fixed_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,H,F", [(5, 2, 8), (20, 4, 8), (50, 8, 16), (100, 8, 16), (30, 2, 32),
                                   *[(n, H, F) for n in (3, 10, 100, 111) for H in (1, 8)
                                     for F in (8, 16, 32)],
                                   (300, 8, 32)])
def test_gat_group_kernel_matches_plain(cuda, n, H, F):
    """n=3 has one source a target; n=111 is the top of K2's route at H*F=128;
    n=300 H=8 F=32 does not fit a block with all eight heads, so the block
    takes a slice of them."""
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
                                            (64, 3, 4, 10, 1), (138, 1, 1, 5, 1),
                                            (3, 4, 3, 4, 1), (4, 4, 3, 4, 2), (33, 3, 3, 8, 1),
                                            (34, 2, 3, 8, 2), (138, 2, 2, 10, 2),
                                            (139, 2, 2, 10, 1), (500, 2, 2, 20, 1),
                                            (1100, 2, 2, 10, 2), (2100, 1, 1, 10, 1)])
def test_gls_kernel_matches_plain(cuda, n, B, iters, pm, G):
    """Every layout that takes n against the twin: n=3 and 4 have at most one
    2-opt candidate, n=33 and 34 put a row of 31 and 32 candidates beside a
    warp, 138 is the top of the shared layout and 139 the first global n;
    n=1100 and 2100 pass the block's 1024 threads (and 2100 the tour cost's
    stack of five levels that served n <= 1024)."""
    rng = np.random.default_rng(n + G)
    D = coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32))
    R = rng.random((B, n, n))
    guides = np.stack([D, R + R.transpose(0, 2, 1)][:G], axis=1)
    Dt = torch.as_tensor(D, device=cuda)
    Gt = torch.as_tensor(np.ascontiguousarray(guides, dtype=np.float32), device=cuda)
    T = nearest_neighbor_batch(Dt)
    want = gls_fixed_plain(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
    for layout in ("shared", "global") if n <= gls_whole_max_n() else ("global",):
        got = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm, layout=layout)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), layout


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


def _group_inputs(n, H, F, B, seed, spread, dev):
    rng = np.random.default_rng(seed)
    E = n * (n - 1) // 2
    el, er = (torch.as_tensor(spread * rng.standard_normal((B, E, H)), dtype=torch.float32,
                              device=dev) for _ in range(2))
    h = torch.as_tensor(rng.standard_normal((B, E, H, F)), dtype=torch.float32, device=dev)
    city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=dev)
    return el, er, h, city


@pytest.mark.parametrize("n,H,F,spread,ties", [
    (5, 2, 8, 3.0, False), (10, 4, 8, 3.0, False), (50, 8, 16, 3.0, False),
    (100, 8, 16, 3.0, False), (30, 2, 32, 3.0, False),
    *[(n, H, F, 3.0, False) for n in (3, 111) for H in (1, 8) for F in (8, 16, 32)],
    (14, 4, 16, 1.0, True), (100, 8, 16, 1.0, True), (20, 8, 16, 40.0, False),
    (100, 8, 16, 40.0, False)])
def test_gat_group_mxu_kernel_matches_plain(cuda, n, H, F, spread, ties):
    """n=3 (g=2) has one n8 tile of targets, 6 of them padding, and its
    sources are padded to gp=8; n=111 is the top of the route at H*F=128;
    F = 8, 16, 32 give 1, 1, 2 m16 tiles of features (F=8 half padding).
    ties: el takes four values, so maxima repeat and, where the top value is
    unique, it sits at some target's own index (the second value then gives
    m).  A spread of 40 sends most p to 0."""
    el, er, h, city = _group_inputs(n, H, F, 2, n, spread, cuda)
    if ties:
        el = torch.round(torch.rand(el.shape, generator=torch.Generator().manual_seed(n)) * 3
                         ).to(cuda)
    before = kernels.launches["gat_group_mxu"]
    got = gat_group_partials_mxu(el, er, h, city)
    torch.cuda.synchronize()
    assert kernels.launches["gat_group_mxu"] == before + 1
    want = gat_group_partials_mxu_plain(el, er, h, city)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)  # the same max
    for a, b in zip(got[1:], want[1:]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("n,H,F,spread", [(5, 2, 8, 1.0), (10, 8, 16, 10.0), (100, 8, 16, 10.0),
                                          (60, 4, 32, 3.0), (200, 8, 16, 1.0)])
def test_gat_sep_kernel_matches_plain(cuda, n, H, F, spread, fast):
    """f32 and bf16 payloads: m exactly, z and num within 1e-5 of the largest
    value (the same payload bits, summed in another order)."""
    args = _group_inputs(n, H, F, 2, n + 1, spread, cuda)
    before = kernels.launches["gat_sep"]
    got = gat_sep_partials(*args, fast)
    torch.cuda.synchronize()
    assert kernels.launches["gat_sep"] == before + 1
    want = gat_sep_partials_plain(*args, fast)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, b in zip(got[1:], want[1:]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_gat_sep_kernel_tied_maxima(cuda):
    """Constant el per group: every element ties at the maximum."""
    n, H, F = 20, 2, 8
    el, er, h, city = _group_inputs(n, H, F, 1, 0, 1.0, cuda)
    el = torch.full_like(el, 0.25)
    for fast in (False, True):
        got = gat_sep_partials(el, er, h, city, fast)
        want = gat_sep_partials_plain(el, er, h, city, fast)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        for a, b in zip(got[1:], want[1:]):
            assert bool(torch.isfinite(a).all())
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("name,n,F,extra", [("gat_group_mxu", 2074, 16, ()),
                                            ("gat_sep", 3100, 8, (False,)),
                                            ("gat_group", 1800, 32, ()),
                                            ("gat_sorted", 2800, 8, (True,))])
def test_launchers_refuse_a_block_that_does_not_fit(cuda, name, n, F, extra):
    """Each launcher checks its block's shared memory against the device's
    opt-in limit; the wrapper raises ValueError and counts no launch.  K5's
    route runs the sorted-prefix kernel, which reaches n=2712 with f32
    payloads and n=2441 with bf16 ones.  K4's block at one head holds h
    (gp rows of F+8 floats, gp = g rounded up to 8), el and er (gp each), m
    and z (g each) and 3 words: at F=16 and n=2073 (g = gp = 2072) that is
    58,019 words, 232,076 bytes, within an H100's 232,448; at n=2074
    (g=2073, gp=2080) 58,229 words, 232,916 bytes."""
    partials = {"gat_group_mxu": gat_group_partials_mxu, "gat_sep": gat_sep_partials,
                "gat_group": gat_group_partials, "gat_sorted": gat_sorted_partials}[name]
    E = n * (n - 1) // 2
    el = torch.zeros((1, E, 1), device=cuda)
    city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=cuda)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="shared memory"):
        partials(el, el, torch.zeros((1, E, 1, F), device=cuda), city, *extra)
    assert dict(kernels.launches) == before


def _hold_sorted(got, want, n):
    """m equal; z, num and the merged conv within 1e-5 of the largest
    reference value, all finite."""
    assert torch.equal(got[0], want[0])
    topo = build_topology(n)
    pairs = list(zip(got[1:], want[1:]))
    pairs.append((merge_group_partials(*got, topo), merge_group_partials(*want, topo)))
    for a, b in pairs:
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("n,H,F,B", [(10, 8, 16, 2), (100, 8, 16, 2), (500, 8, 16, 1),
                                     (1100, 2, 16, 1), (900, 2, 32, 1), (3, 1, 8, 3)])
def test_gat_sorted_kernel_matches_plain(cuda, n, H, F, B, fast):
    """The sorted-prefix kernel against its twin; n=1100 at F=16 scans its
    features in column slices, and n=900 at F=32 was past K5's block."""
    args = _group_inputs(n, H, F, B, n + 3, 3.0, cuda)
    before = kernels.launches["gat_sorted"]
    got = gat_sorted_partials(*args, fast)
    torch.cuda.synchronize()
    assert kernels.launches["gat_sorted"] == before + 1
    _hold_sorted(got, gat_sorted_partials_plain(*args, fast), n)


@pytest.mark.parametrize("fast", [False, True])
def test_gat_sorted_kernel_range(cuda, fast):
    """The library's gat_sorted_max_n is the launcher's own limit on this
    card: the kernel runs there (in 4-column slices) and refuses one city
    more.  On an H100 that is n=2712 with f32 payloads, 2441 with bf16."""
    top = kernels.library().gat_sorted_max_n(int(fast), torch.cuda.current_device())
    assert top >= 2048
    for n in (top, top + 1):
        E = n * (n - 1) // 2
        el = torch.zeros((1, E, 1), device=cuda)
        city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=cuda)
        before = kernels.launches["gat_sorted"]
        if n > top:
            with pytest.raises(ValueError, match="shared memory"):
                gat_sorted_partials(el, el, torch.zeros((1, E, 1, 8), device=cuda), city, fast)
            assert kernels.launches["gat_sorted"] == before
        else:
            m, z, num = gat_sorted_partials(el, el, torch.ones((1, E, 1, 8), device=cuda),
                                            city, fast)
            torch.cuda.synchronize()
            assert kernels.launches["gat_sorted"] == before + 1
            # every score is leaky(0) = 0: m = 0, z and num count the n - 2 sources
            assert bool((m == 0).all()) and bool((z == n - 2).all())
            assert bool((num == n - 2).all())


def test_gat_sorted_kernel_on_the_n200_fixture_layer0(cuda):
    """The shipped tsp100 model's layer-0 el, er and h on the n=200 JAX
    fixture's instances, both payload modes, against the new twin and the
    plain arithmetic of K3 and K5."""
    import pathlib

    from gnngls_tpu_torch.core.scaler import load_scalers
    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.models.convert import load_model
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig
    from gnngls_tpu_torch.ops.gat import project

    root = pathlib.Path(__file__).resolve().parent.parent
    coords = np.load(root / "gnngls_tpu_torch/testdata/jax_tsp200_seed3.npz")["coords"]
    B, n, _ = coords.shape
    E = n * (n - 1) // 2
    d = {"coords": coords, "regret": np.zeros((B, E), np.float32),
         "in_solution": np.zeros((B, E), bool), "opt_cost": np.ones(B)}
    ds = TSPDataset.from_arrays(d, scalers=load_scalers(root / "models/tsp100/scalers.json"))
    model = load_model(root / "models/tsp100/checkpoint_best_val.npz", RegretGNNConfig(),
                       device=cuda)
    with torch.no_grad():
        x = model.embed(torch.as_tensor(ds.get_scaled_batch(np.arange(B))["features"],
                                        device=cuda))
        h, el, er = project(model.layers[0].gat.params(), x, model.cfg.n_heads)
        city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=cuda)
        args = (el.contiguous(), er.contiguous(), h.contiguous(), city)
        for fast in (False, True):
            got = gat_sorted_partials(*args, fast)
            torch.cuda.synchronize()
            _hold_sorted(got, gat_sorted_partials_plain(*args, fast), n)
            _hold_sorted(got, gat_sep_partials_plain(*args, fast), n)
        _hold_sorted(gat_group_partials_chunked(*args, 40),
                     gat_group_partials_chunked_plain(*args, 40), n)


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


@pytest.mark.parametrize("n,B,iters,pm", [(20, 4, 3, 6), (100, 4, 2, 20), (100, 4, 0, 20),
                                          (300, 2, 1, 10)])
def test_gls_kernel_k_input_matches_plain(cuda, n, B, iters, pm):
    """A (B,) k input (the forced-edge label oracles') against the twin in
    every layout that takes n, n_iters=0 (empty traces) included; k=None
    gives the bits of k set to the kernel's own 0.1 * initial cost / n."""
    from gnngls_tpu_torch.search.local_search import penalty_scale
    from gnngls_tpu_torch.search.moves import tour_costs

    Dt, Gt, T = _gls_case(n, B, 1, n + 3, cuda)
    k = torch.as_tensor(np.random.default_rng(n).uniform(0.01, 0.3, B), dtype=torch.float32,
                        device=cuda)
    want = gls_fixed_plain(Dt, Gt, T, n_iters=iters, perturbation_moves=pm, k=k)
    for layout in ("shared", "global") if n <= gls_whole_max_n() else ("global",):
        got = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm, k=k, layout=layout)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), layout
    k0 = penalty_scale(tour_costs(Dt, T.long()), n)
    own = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
    given = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm, k=k0)
    torch.cuda.synchronize()
    for a, b in zip(own, given):
        assert torch.equal(a, b)


@pytest.mark.parametrize("iters", [0, 2])
def test_warm_label_lanes_match_plain(cuda, iters):
    """The warm forced-edge oracle at n=100 (shipped tsp100 instance 4 from
    its shipped tour, every 77th edge, both splices) through K1 on the card
    and through its twin on the CPU: the same tours and costs."""
    import pathlib

    from gnngls_tpu_torch.data.solvers import warm_fixed_edge_costs_batch

    root = pathlib.Path(__file__).resolve().parent.parent
    with np.load(root / "data" / "tsp100" / "instances.npz") as z:
        D = coords_to_distance_matrix(z["coords"][4:5]).astype(np.float64)
        best = z["opt_tour"][4:5]
    edges = build_topology(100).edges[::77]
    before = kernels.launches["gls_whole"]
    got = warm_fixed_edge_costs_batch(D, edges, best, n_gls_iters=iters, device="cuda")
    assert kernels.launches["gls_whole"] == before + 1
    want = warm_fixed_edge_costs_batch(D, edges, best, n_gls_iters=iters, device="cpu")
    assert got[1].all()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


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
    n = gls_whole_module.MAX_N + 1
    D = torch.zeros((1, n, n), device=cuda)
    with pytest.raises(ValueError):  # beyond the global layout
        gls_whole(D, D, torch.zeros((1, n + 1), dtype=torch.int32, device=cuda), n_iters=1)


def _state_arrays(state):
    """Every field of a GLSState, tensors on the host."""
    out = {}
    for key, v in state._asdict().items():
        if key == "trace":
            out["trace.costs"] = None if v.costs is None else v.costs.cpu()
            out["trace.n"] = v.n.cpu()
        else:
            out[key] = v.cpu() if torch.is_tensor(v) else v
    return out


@pytest.mark.parametrize("variant", ["default", "ties_cap7", "count_only_k"])
@pytest.mark.parametrize("n,B,iters,pm,G,first_improvement", [
    (20, 8, 5, 8, 1, False), (20, 8, 5, 8, 2, True), (50, 4, 5, 8, 2, False),
    (50, 4, 5, 8, 1, True), (100, 64, 3, 20, 1, False), (100, 16, 3, 20, 2, True),
    (139, 4, 2, 20, 1, False), (500, 2, 2, 20, 1, False)])
def test_per_move_engine_on_the_card_matches_the_cpu(cuda, n, B, iters, pm, G,
                                                     first_improvement, variant):
    """On CUDA tensors the per-move engine's perturbation is one launch of
    csrc/gls_perturb.cu an outer iteration, and the engine gives the CPU's
    bits: every field of the state, the lock-step rounds included.  Variants:
    "default" (4096 trace rows, also through run_fixed); "ties_cap7"
    (integer-valued guides, so that utilities tie, and a trace of 7 rows that
    saturates); "count_only_k" (a trace that counts moves only, and a given
    k per instance)."""
    Dt, Gt, T = _gls_case(n, B, G, 3 * n + G, cuda)
    cap, k = 4096, None
    if variant == "ties_cap7":
        Gt, cap = torch.floor(4 * Gt), 7
    elif variant == "count_only_k":
        cap, k = None, 0.02 * torch.arange(1, B + 1, dtype=torch.float32)

    def search(dev):
        s = tls.gls_init(Dt.to(dev), T.to(dev), trace_cap=cap,
                         k=None if k is None else k.to(dev),
                         first_improvement=first_improvement)
        for _ in range(iters):
            s = tls.gls_iteration(s, Dt.to(dev), Gt.to(dev), perturbation_moves=pm,
                                  first_improvement=first_improvement)
        return s

    before = kernels.launches["gls_perturb"]
    got = _state_arrays(search(cuda))
    assert kernels.launches["gls_perturb"] == before + iters
    want = _state_arrays(search("cpu"))
    assert got.keys() == want.keys()
    for key, a in got.items():
        b = want[key]
        if torch.is_tensor(b):
            assert torch.equal(a, b), key
        else:
            assert a == b, key
    if variant == "default":
        kw = dict(n_iters=iters, perturbation_moves=pm, first_improvement=first_improvement)
        got = run_fixed(Dt, Gt, T, device=cuda, **kw)
        want = run_fixed(Dt.cpu(), Gt.cpu(), T.cpu(), device="cpu", **kw)
        for key in ("trace_n", "chunk_moves", "best_tours", "trace_costs", "best_costs", "work",
                    "rounds"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)


def _never_the_twin(*a, **kw):
    raise AssertionError("the per-move engine ran the twin's rounds on the card")


def test_wall_clock_on_the_card_launches_one_perturbation_an_iteration(cuda, monkeypatch):
    """run_wall_clock's chunks are one outer iteration each: one launch of
    the perturbation kernel per chunk, and none of the twin's rounds."""
    Dt, Gt, T = _gls_case(100, 32, 1, 11, cuda)

    monkeypatch.setattr(tls, "_perturbation", _never_the_twin)
    kernels.reset_launch_counts()
    res = run_wall_clock(Dt, Gt, T, time_limit_s=1.0, device=cuda)
    iters = len(res.chunk_times) - 1
    assert iters >= 1 and dict(kernels.launches) == {"gls_perturb": iters}


def test_perturbation_global_layout_matches_shared(cuda, monkeypatch):
    """Past max_n() the wrapper keeps the tour state in a global workspace;
    the two layouts differ only in addresses: the same bits, one launch an
    outer iteration either way, and the twin's rounds never run."""
    Dt, Gt, T = _gls_case(60, 4, 1, 7, cuda)
    kw = dict(n_iters=3, perturbation_moves=10)
    before = kernels.launches["gls_perturb"]
    want = run_fixed(Dt, Gt, T, device=cuda, **kw)
    whole = gls_perturb.max_n(global_layout=True)
    monkeypatch.setattr(gls_perturb, "max_n",
                        lambda global_layout=False: whole if global_layout else 59)
    monkeypatch.setattr(tls, "_perturbation", _never_the_twin)
    got = run_fixed(Dt, Gt, T, device=cuda, **kw)
    assert kernels.launches["gls_perturb"] == before + 6
    for key in ("trace_n", "best_tours", "trace_costs", "best_costs", "work", "rounds"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)


def test_perturbation_past_the_shared_layout_matches_the_twin(cuda):
    """At n = max_n() + 1, where only the global layout holds the tour
    state, one phase from a poor tour equals the twin's bit for bit."""
    n = gls_perturb.max_n() + 1
    rng = np.random.default_rng(14496)
    D = coords_to_distance_tensor(rng.random((1, n, 2)).astype(np.float32), cuda)
    g = torch.Generator(device=cuda).manual_seed(11)
    R = torch.rand((1, n, n), generator=g, device=cuda)
    G = R + R.transpose(1, 2)
    del R
    t = torch.cat([torch.arange(n), torch.zeros(1, dtype=torch.long)])[None].to(cuda)
    cost = D[0, t[0, :-1], t[0, 1:]].sum()[None]
    k = tls.penalty_scale(cost, n)
    outs = []
    for fn in (gls_perturb.perturbation, tls._perturbation):
        P = torch.zeros_like(D)
        trace = tls.make_trace(1, 16, cuda)
        work = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
        tours, costs, rounds = fn(D, G, P, k, t, cost, trace, work, 3, 9)
        outs.append((tours, costs, P, trace.costs, trace.n, work, rounds))
        del P
    for key, a, b in zip(("tours", "costs", "penalties", "trace costs", "trace counts",
                          "work", "rounds"), *outs):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), key
    assert int(outs[0][4][0]) >= 3


def test_perturbation_wrapper_refuses_bad_cuda_inputs(cuda):
    Dt, Gt, T = _gls_case(12, 2, 1, 5, cuda)
    s = tls.gls_init(Dt, T)
    args = (Dt, Gt[:, 0], s.penalties, s.k, s.tour, s.cost, s.trace, s.work, 4, 12)
    with pytest.raises(TypeError):
        gls_perturb.perturbation(Dt.double(), *args[1:])
    with pytest.raises(ValueError):  # one tensor on the CPU
        gls_perturb.perturbation(*args[:3], s.k.cpu(), *args[4:])
    n = gls_perturb.max_n(global_layout=True) + 1
    Z = torch.zeros((1, 1, 1), device=cuda).expand(1, n, n)  # no memory behind it
    big = tls.make_trace(1, 4, cuda)
    with pytest.raises(ValueError, match="range"):
        gls_perturb.perturbation(Z, Z, Z, s.k[:1], torch.zeros((1, n + 1), dtype=torch.long,
                                                               device=cuda), s.cost[:1], big,
                                 s.work[:1], 4, 12)


@pytest.mark.parametrize("n,B,iters,pm,G", [(50, 8, 10, 10, 2), (100, 8, 10, 20, 1),
                                            (200, 2, 3, 20, 1)])
def test_per_move_engine_matches_the_kernel(cuda, n, B, iters, pm, G):
    """With best-improvement the per-move engine runs K1's search: the same
    accepted moves, best tours and the search's own best costs."""
    Dt, Gt, T = _gls_case(n, B, G, 5 * n + G, cuda)
    before = kernels.launches["gls_whole"]
    res = run_fixed(Dt, Gt, T, n_iters=iters, perturbation_moves=pm, device=cuda)
    assert kernels.launches["gls_whole"] == before
    out = gls_whole(Dt, Gt, T.int(), n_iters=iters, perturbation_moves=pm)
    np.testing.assert_array_equal(res.trace_n, out.moves.cpu().numpy())
    np.testing.assert_array_equal(res.best_tours, out.best_tours.cpu().numpy())
    np.testing.assert_array_equal(res.best_costs, out.best_costs.cpu().numpy())
    np.testing.assert_array_equal(res.work, out.work.cpu().numpy())


def _train_step(model, dev, dtype, x, y):
    import copy

    from gnngls_tpu_torch.train.step import make_optimizer, train_step

    m = copy.deepcopy(model).to(device=dev, dtype=dtype)
    loss = train_step(m, make_optimizer(m), torch.as_tensor(x, dtype=dtype, device=dev),
                      torch.as_tensor(y, dtype=dtype, device=dev))
    leaves = {k: p.grad for k, p in m.named_parameters()}
    leaves.update({k: t for k, t in m.state_dict().items() if k.endswith((".mean", ".var"))})
    return float(loss), {k: v.double().cpu() for k, v in leaves.items()}


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-6), (torch.float32, 1e-2)])
def test_train_step_on_the_card_matches_the_cpu(cuda, dtype, tol):
    """One train step (chip_smoke.py phase 15a): the loss within 1e-5
    relative; each gradient leaf and running statistic within tol of its
    largest value, or of the largest over all leaves where its own is below
    1e-4 of that (a gradient that vanishes in exact arithmetic holds only
    rounding noise).  float32 takes 1e-2: the two devices' f32 forwards may
    take different sides of a ReLU kink, which moves that FFN's gradients by
    about 1e-3 of their scale."""
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig, init_params

    n, B = 20, 8
    rng = np.random.default_rng(15)
    x, y = (rng.random((B, n * (n - 1) // 2, 1)).astype(np.float32) for _ in range(2))
    model = init_params(RegretGNNConfig(embed_dim=32, n_heads=4), torch.Generator().manual_seed(15))
    got_loss, got = _train_step(model, cuda, dtype, x, y)
    want_loss, want = _train_step(model, "cpu", dtype, x, y)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    grads = [k for k in want if not k.endswith((".mean", ".var"))]
    top = max(float(want[k].abs().max()) for k in grads)
    for key in want:
        scale = float(want[key].abs().max())
        if key in grads and scale < 1e-4 * top:
            scale = top
        assert float((got[key] - want[key]).abs().max()) <= tol * scale, key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R,K,H,F,p", [(400, 99, 8, 16, 0.5), (3, 499, 8, 16, 0.05),
                                       (7, 10, 3, 5, 1.0), (2, 2000, 1, 8, 0.01)])
def test_rank_sums_kernel_matches_its_twin(cuda, R, K, H, F, p, dtype):
    """The sorted-prefix routes' adjoint (csrc/rank_sums.cu) against its twin
    on the CPU bit for bit, twice: ranks drawn geometric(p) from 0 (p=1: every
    target on rank 0), the last rows all on rank K-1; one launch a call."""
    from gnngls_tpu_torch.ops.gat_sep import rank_sums, rank_sums_plain

    rng = np.random.default_rng(R + K)
    idx = np.minimum(rng.geometric(p, size=(R, K, H)) - 1, K - 1)
    idx[-1] = K - 1
    g, gh = rng.normal(size=(R, K, H)), rng.normal(size=(R, K, H, F)) * 1e3
    args = [torch.as_tensor(a) for a in (idx, g.astype(np.float64), gh)]
    args = [args[0]] + [t.to(dtype) for t in args[1:]]
    before = kernels.launches["rank_sums"]
    got = rank_sums(*(t.to(cuda) for t in args))
    again = rank_sums(*(t.to(cuda) for t in args))
    assert kernels.launches["rank_sums"] == before + 2
    for a, b, c in zip(got, again, rank_sums_plain(*args)):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


@pytest.mark.parametrize("route", ["sep", "sep_fast"])
def test_sep_train_steps_repeat_on_the_card(cuda, route):
    """Two train steps through the route from the shipped checkpoint and a
    fresh Adam, on tsp100 train instances 0-7 at full width: the loss, every
    gradient leaf, every parameter after the step and the BatchNorm running
    statistics equal bit for bit."""
    import copy
    import pathlib

    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.models.convert import load_model
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig
    from gnngls_tpu_torch.train.step import make_optimizer, train_step

    root = pathlib.Path(__file__).resolve().parent.parent
    model = load_model(root / "models/tsp100/checkpoint_best_val.npz", RegretGNNConfig(),
                       device=cuda)
    ds = TSPDataset.from_npz(root / "data/tsp100/instances.npz", root / "data/tsp100/train.txt",
                             scalers_file=root / "data/tsp100/scalers.json")
    batch = ds.get_scaled_batch(np.arange(8))
    x, y = (torch.as_tensor(batch[k], device=cuda) for k in ("features", "regret"))

    def step():
        m = copy.deepcopy(model)
        loss = train_step(m, make_optimizer(m), x, y, gat_impl=route)
        return float(loss), [p.grad.cpu() for p in m.parameters()], \
            [t.cpu() for t in m.state_dict().values()]

    (l1, g1, s1), (l2, g2, s2) = step(), step()
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))


def test_resume_the_shipped_checkpoint_on_the_card(cuda, tmp_path):
    """A few steps of train_model at full width resumed from the shipped
    checkpoint: finite losses, epoch 26 at lr 1e-3 * 0.99**26, Adam's count
    carried on from 1638."""
    import json
    import pathlib

    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.train import loop

    root = pathlib.Path(__file__).resolve().parent.parent
    ckpt = root / "models/tsp100/checkpoint_best_val.npz"
    pj = json.loads((root / "models/tsp100/params.json").read_text())
    cfg = loop.TrainConfig(**{**pj, "n_epochs": 27})
    sets = []
    for split, k in (("train", 96), ("val", 32)):
        ds = TSPDataset.from_npz(root / "data/tsp100/instances.npz",
                                 root / f"data/tsp100/{split}.txt",
                                 scalers_file=root / "data/tsp100/scalers.json")
        sets.append(TSPDataset(ds.coords[:k], ds.features[:k], ds.regret[:k],
                               ds.in_solution[:k], ds.opt_cost[:k], ds.scalers))
    _, history = loop.train_model(*sets, cfg, tmp_path, verbose=False, resume_from=ckpt,
                                  device=cuda)
    (row,) = history
    assert row["epoch"] == 26 and row["lr"] == pytest.approx(1e-3 * 0.99 ** 26, rel=1e-12)
    assert np.isfinite(row["loss"]) and np.isfinite(row["val_loss"])
    assert row["loss"] < 2 * 0.001972 and row["val_loss"] < 2 * 0.001931
    with np.load(tmp_path / "checkpoint_final.npz") as z:
        assert int(z["opt_state::count"]) == int(z["opt_state::inner_state/0/count"]) == 1638 + 3


def _conv_case(n, H, F, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    c = H * F
    arrays = [rng.normal(size=s) * 0.5 for s in ((c, c), (H, F), (H, F))]
    x = rng.normal(size=(2, n * (n - 1) // 2, c))
    return [torch.as_tensor(a, dtype=dtype) for a in (*arrays, x)]


@pytest.mark.parametrize("route,n,H,F", [("chunked", 120, 8, 16), ("chunked", 30, 2, 8),
                                         ("bf16", 100, 8, 16), ("bf16", 20, 4, 8)])
def test_chunked_and_bf16_routes_on_the_card_match_the_cpu(cuda, route, n, H, F):
    """The plain routes on the card against the CPU: chunked at 2e-5 of the
    scale (the conv's f32 bar against JAX); bf16 at 2e-3 (tests/
    test_torch_gat_sep.py's BF16_VS_F32: f32 noise moves bf16 roundings),
    and its GATConv gradient in float64 at 1e-4 of each leaf's scale."""
    from gnngls_tpu_torch.models.regret_gat import gat_conv_for
    from gnngls_tpu_torch.ops.gat import GATParams

    conv = gat_conv_for(route)
    topo = build_topology(n)
    leaves = _conv_case(n, H, F, n)
    want = conv(GATParams(*leaves[:3]), topo, leaves[3], H)
    got = conv(GATParams(*(t.to(cuda) for t in leaves[:3])), topo, leaves[3].to(cuda), H)
    bar = (2e-5 if route == "chunked" else 2e-3) * max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= bar
    grads = []
    for dev in ("cpu", cuda):
        ls = [t.to(device=dev, dtype=torch.float64).requires_grad_() for t in leaves]
        conv(GATParams(*ls[:3]), topo, ls[3], H).sum().backward()
        grads.append([t.grad.cpu() for t in ls])
    for a, b in zip(grads[1], grads[0]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.fixture(scope="module")
def nccl_mesh():
    """A NCCL process group of one rank and its (data, model) mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist

    from gnngls_tpu_torch.parallel import mesh as pm
    from gnngls_tpu_torch.parallel import multihost

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=1,
                         process_id=0)
    assert dist.get_backend() == "nccl"
    yield pm.make_mesh(axes=("data", "model"))
    dist.destroy_process_group()


def test_ring_tp_and_sharded_conv_at_world_size_one_under_nccl(nccl_mesh):
    """gat_conv_ring (a one-member ring: nothing is sent), gat_conv_sharded,
    ffn_tp and the model's forward_ring and forward_tp on the card against
    the single-device paths, at the tolerances the JAX package's tests hold
    them to (2e-5, 2e-4, 1e-5, 3e-5, 2e-4)."""
    from gnngls_tpu_torch.models.regret_gat import (RegretGNNConfig, forward_ring,
                                                    forward_tp, init_params,
                                                    shard_params_tp)
    from gnngls_tpu_torch.ops import gat_ring, tp
    from gnngls_tpu_torch.ops.gat import GATParams, gat_conv
    from gnngls_tpu_torch.ops.gat_sharded import gat_conv_sharded

    cuda, mesh = torch.device("cuda"), nccl_mesh
    n, H, F = 24, 4, 8
    topo = build_topology(n)
    leaves = [t.to(cuda) for t in _conv_case(n, H, F, 3)]
    p, x = GATParams(*leaves[:3]), leaves[3]
    want = gat_conv(p, topo, x, H)
    ring = gat_ring.gat_conv_ring(p, topo, gat_ring.edge_sharding(x, mesh), H, mesh,
                                  city_chunk=4)
    torch.testing.assert_close(ring, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(gat_conv_sharded(p, topo, x, H, mesh), want, rtol=2e-4,
                               atol=2e-4)
    model = init_params(RegretGNNConfig(embed_dim=32, n_heads=4),
                        torch.Generator().manual_seed(4)).to(cuda).eval()
    xm = torch.rand((3, topo.n_edges, 1), generator=torch.Generator().manual_seed(5)).to(cuda)
    with torch.no_grad():
        want = model(xm, gat_impl="fast")
        layer = model.layers[0]
        f1, f2 = tp.shard_ffn_params(layer.ffn1, layer.ffn2, mesh)
        h = torch.randn((5, 32), generator=torch.Generator().manual_seed(6)).to(cuda)
        torch.testing.assert_close(tp.ffn_tp(f1, f2, h, mesh),
                                   layer.ffn2(torch.relu(layer.ffn1(h))), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(forward_ring(model, xm, n, mesh=mesh, city_chunk=4), want,
                               rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(forward_tp(shard_params_tp(model, mesh), xm, mesh=mesh), want,
                               rtol=2e-4, atol=1e-5)


def test_sharded_gls_matches_the_kernel_under_nccl(nccl_mesh):
    """make_sharded_gls at world size 1: K1 launched once, its tours, costs
    and moves those of run_fixed_kernel."""
    from gnngls_tpu_torch.parallel.eval_shard import make_sharded_gls
    from gnngls_tpu_torch.search.batched import run_fixed_kernel

    n, B = 50, 8
    rng = np.random.default_rng(9)
    D = coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32))
    init = nearest_neighbor_batch(torch.as_tensor(D)).numpy()
    run = make_sharded_gls(nccl_mesh, n_iters=5, perturbation_moves=10)
    before = kernels.launches["gls_whole"]
    tours, costs, moves = run(D, D[:, None], init)
    assert kernels.launches["gls_whole"] == before + 1
    ref = run_fixed_kernel(D, D[:, None], init, n_iters=5, perturbation_moves=10,
                           device="cuda")
    np.testing.assert_array_equal(tours, ref.best_tours)
    np.testing.assert_array_equal(costs, np.float32(ref.best_costs))
    np.testing.assert_array_equal(moves, ref.chunk_moves[:, -1])


def test_multi_device_layer_on_every_card(cuda, tmp_path):
    """tests/test_torch_dist.py's scenarios on one NCCL rank per card (2 or 4
    cards; skipped otherwise), each held to JAX's single-device results (the
    committed fixture gnngls_tpu_torch/testdata/jax_dist_results.pkl) at the
    tolerances the JAX package's own tests use: the city-sharded and ring
    GATConvs (rings over NVLink), forward_ring, the tensor-parallel FFN and
    forward_tp, a data-parallel train step, make_sharded_gls on K1, the
    meshes and the DTensor of the ranks' shards."""
    import pathlib
    import pickle

    import torch.multiprocessing as tmp

    import torch_dist_ranks

    world = torch.cuda.device_count()
    if world not in (2, 4):
        pytest.skip(f"needs 2 or 4 cards, found {world}")
    fixture = (pathlib.Path(__file__).resolve().parent.parent
               / "gnngls_tpu_torch/testdata/jax_dist_results.pkl")
    with open(fixture, "rb") as f:
        want = pickle.load(f)[world]
    kernels.build()  # once, before the ranks load it
    tmp.spawn(torch_dist_ranks.run, args=(world, str(tmp_path / "rendezvous"), want, "cuda"),
              nprocs=world, join=True)


def _valid(tours, n) -> bool:
    tours = np.asarray(tours).reshape(-1, n + 1)
    return bool((tours[:, 0] == 0).all() and (tours[:, -1] == 0).all()
                and (np.sort(tours[:, :-1], axis=1) == np.arange(n)).all())


@pytest.mark.parametrize("caller", ["gls_oracle", "gls_fixed_edge_costs",
                                    "warm_fixed_edge_costs_batch", "make_sharded_gls",
                                    "search_on_predictions"])
def test_k1_callers_launch_the_kernel_past_1024_on_the_card(cuda, caller, request):
    """Each caller of K1 at n=1100, past the block's 1024 threads, launches
    K1 and returns valid tours (the label lanes each through its edge)."""
    from gnngls_tpu_torch import evaluate as tev
    from gnngls_tpu_torch.data import solvers
    from gnngls_tpu_torch.parallel.eval_shard import make_sharded_gls

    n, B = 1100, 2
    rng = np.random.default_rng(16)
    coords = rng.random((B, n, 2)).astype(np.float32)
    D = coords_to_distance_matrix(coords)
    edges = build_topology(n).edges[::300000][:2]
    before = kernels.launches["gls_whole"]
    if caller == "gls_oracle":
        tours = solvers.gls_oracle(D, n_iters=1, perturbation_moves=5, device="cuda")[0]
    elif caller == "gls_fixed_edge_costs":
        _, used = solvers.gls_fixed_edge_costs(D[0].astype(np.float64), edges, n_iters=1,
                                               perturbation_moves=5, device="cuda")
        tours = None
        assert used.all()
    elif caller == "warm_fixed_edge_costs_batch":
        best = nearest_neighbor_batch(torch.as_tensor(D[:1], device=cuda)).cpu().numpy()
        _, used, tours = solvers.warm_fixed_edge_costs_batch(
            D[:1].astype(np.float64), edges, best, n_gls_iters=1, perturbation_moves=5,
            dual_splice=False, device="cuda")
        assert used.all()
    elif caller == "make_sharded_gls":
        init = nearest_neighbor_batch(torch.as_tensor(D, device=cuda)).cpu().numpy()
        tours = make_sharded_gls(request.getfixturevalue("nccl_mesh"), n_iters=1,
                                 perturbation_moves=5)(D, D[:, None], init)[0]
    else:
        preds = rng.random((B, n * (n - 1) // 2)).astype(np.float32)
        tours = tev.search_on_predictions(preds, coords, n_iters=1, perturbation_moves=5,
                                          device="cuda")[0].best_tours
    assert kernels.launches["gls_whole"] > before
    assert tours is None or _valid(tours, n)


def test_model_work_holds_full_f32_for_a_tf32_caller_on_the_card(cuda):
    """A caller at "high" (TF32 in cuBLAS, which moves a plain product) gets
    from a forward through K2, predict_regret and a `sep` train step the bits
    it gets at "highest", and reads "high" after each call."""
    import copy
    import pathlib

    from gnngls_tpu_torch import evaluate as tev
    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig, init_params
    from gnngls_tpu_torch.train.step import make_optimizer, train_step

    root = pathlib.Path(__file__).resolve().parent.parent
    ds = TSPDataset.from_npz(root / "data/tsp100/instances.npz", root / "data/tsp100/test.txt",
                             scalers_file=root / "data/tsp100/scalers.json")
    ds.coords, ds.features, ds.regret = ds.coords[:8], ds.features[:8], ds.regret[:8]
    ds.in_solution, ds.opt_cost = ds.in_solution[:8], ds.opt_cost[:8]
    batch = ds.get_scaled_batch(np.arange(8))
    x, y = (torch.as_tensor(batch[k], device=cuda) for k in ("features", "regret"))
    model = init_params(RegretGNNConfig(embed_dim=32, n_heads=4),
                        torch.Generator().manual_seed(16)).to(cuda)
    a = torch.randn((256, 256), device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))

    def each(setting):
        torch.set_float32_matmul_precision(setting)
        out = [(a @ a).cpu()]
        with torch.no_grad():
            out.append(model(x).cpu())
        out.append(torch.as_tensor(tev.predict_regret(model, ds, device=cuda)))
        m = copy.deepcopy(model)
        out.append(train_step(m, make_optimizer(m), x, y, gat_impl="sep").cpu())
        out += [p.grad.cpu() for p in m.parameters()] + [t.cpu() for t in m.state_dict().values()]
        assert torch.get_float32_matmul_precision() == setting
        return out

    try:
        before = kernels.launches["gat_group"]
        highest, high = each("highest"), each("high")
        assert kernels.launches["gat_group"] > before
    finally:
        torch.set_float32_matmul_precision("highest")
    assert not torch.equal(high[0], highest[0])  # TF32 was live for the caller's product
    for i, (u, v) in enumerate(zip(high[1:], highest[1:])):
        assert torch.equal(u, v), f"output {i + 1} moved under the caller's 'high'"
