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
from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
from gnngls_tpu_torch.ops.gat_group import (gat_group_partials, gat_group_partials_chunked,
                                            gat_group_partials_chunked_plain,
                                            gat_group_partials_mxu,
                                            gat_group_partials_mxu_plain,
                                            gat_group_partials_plain)
from gnngls_tpu_torch.ops.gat_group import merge_group_partials
from gnngls_tpu_torch.ops.gat_group_sep import gat_sep_partials, gat_sep_partials_plain
from gnngls_tpu_torch.ops.gat_sorted import gat_sorted_partials, gat_sorted_partials_plain
from gnngls_tpu_torch.search.batched import run_fixed
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
                                            (139, 2, 2, 10, 1), (500, 2, 2, 20, 1)])
def test_gls_kernel_matches_plain(cuda, n, B, iters, pm, G):
    """Every layout that takes n against the twin: n=3 and 4 have at most one
    2-opt candidate, n=33 and 34 put a row of 31 and 32 candidates beside a
    warp, 138 is the top of the shared layout and 139 the first global n."""
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


@pytest.mark.parametrize("n,B,iters,pm,G,first_improvement", [
    (20, 8, 5, 8, 1, False), (20, 8, 5, 8, 2, True), (50, 4, 5, 8, 2, False),
    (50, 4, 5, 8, 1, True)])
def test_per_move_engine_on_the_card_matches_the_cpu(cuda, n, B, iters, pm, G,
                                                     first_improvement):
    """The per-move engine is tensor code: on CUDA tensors it gives the CPU's bits."""
    Dt, Gt, T = _gls_case(n, B, G, 3 * n + G, cuda)
    kw = dict(n_iters=iters, perturbation_moves=pm, first_improvement=first_improvement)
    got = run_fixed(Dt, Gt, T, device=cuda, **kw)
    want = run_fixed(Dt.cpu(), Gt.cpu(), T.cpu(), device="cpu", **kw)
    for key in ("trace_n", "chunk_moves", "best_tours", "trace_costs", "best_costs", "work"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)


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
