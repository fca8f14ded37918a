"""The callers of the whole-GLS kernel (K1), on the CPU.

Each caller reaches `gls_whole` (the twin `gls_fixed_plain` on CPU tensors)
and returns exactly what `gls_fixed_plain` gives on the same inputs: the GLS
oracle, the cold and warm forced-edge label oracles (their lanes and penalty
scales k from `cold_lanes` / `warm_lanes`, several launches a call), the
instance-sharded search at world size 1 under gloo, and the search on given
predictions.  The GLS oracle cuts its launches at `MAX_D2_BYTES` and gives
the uncut bits.  K1's tour cost (csrc/gls_whole.cu, `warp_tour_cost`) adds
in the order of `moves.tree_sum` at every n up to `gls_whole.MAX_N`: a numpy
emulation of its lanes, stack and shuffles is held to the twin's bits.

The keywords of gnngls_tpu's signatures that change no number in the port
(`seed`, `edge_chunk`, `inst_chunk`, `duty_work`, `duty_idle_s`,
`trace_cap`, `use_shard_map`) are accepted and change nothing.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch.core.graph import build_topology, edge_vector_to_matrix
from gnngls_tpu_torch.data import labels as tlabels
from gnngls_tpu_torch.data import solvers as tsolvers
from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
from gnngls_tpu_torch.parallel import eval_shard
from gnngls_tpu_torch.parallel.mesh import make_mesh
from gnngls_tpu_torch.search import batched as tbatched
from gnngls_tpu_torch.search import gls_whole as gw
from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
from gnngls_tpu_torch.search.local_search import gls_fixed_plain
from gnngls_tpu_torch.search.moves import tree_sum

N = 12
ITERS, PM = 3, 4
CALLERS = ["gls_oracle", "gls_fixed_edge_costs", "warm_fixed_edge_costs_batch",
           "make_sharded_gls", "search_on_predictions"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def gloo_mesh(tmp_path_factory):
    """A gloo process group of one rank in this process, and its mesh."""
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    rdv = tmp_path_factory.mktemp("gloo") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=1, rank=0)
    yield make_mesh()
    dist.destroy_process_group()


@pytest.fixture
def launches(monkeypatch):
    """The calls made to K1's wrapper, wherever a caller's module holds it by
    name."""
    calls = []
    real = gw.gls_whole

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    for mod in (gw, tbatched):
        monkeypatch.setattr(mod, "gls_whole", spy)
    return calls


def _distances(B, seed):
    rng = np.random.default_rng(seed)
    return coords_to_distance_matrix(rng.random((B, N, 2)).astype(np.float32))


def _twin(D, guides, init, k=None):
    return gls_fixed_plain(torch.as_tensor(D), torch.as_tensor(guides),
                           torch.as_tensor(init).to(torch.int32), n_iters=ITERS,
                           perturbation_moves=PM, k=k)


def _tour_costs(D, tours):
    """f32 sums of D along each tour, as the callers re-derive them."""
    return D[np.arange(len(D))[:, None], tours[:, :-1], tours[:, 1:]].sum(-1)


def _uses(tours, edges):
    a, b = tours[..., :-1], tours[..., 1:]
    u, v = edges[:, :1], edges[:, 1:]
    return (((a == u) & (b == v)) | ((a == v) & (b == u))).any(-1)


def _gls_oracle(mesh):
    D = _distances(3, 0)
    got = tsolvers.gls_oracle(D, n_iters=ITERS, perturbation_moves=PM, device="cpu")
    init = nearest_neighbor_batch(torch.as_tensor(D))
    tours = _twin(D, D[:, None], init).best_tours.numpy()
    return got, (tours, _tour_costs(D, tours).astype(np.float64))


def _gls_fixed_edge_costs(mesh):
    D = _distances(1, 1)[0].astype(np.float64)
    edges = build_topology(N).edges[::4]
    got = tsolvers.gls_fixed_edge_costs(D, edges, n_iters=ITERS, perturbation_moves=PM,
                                        device="cpu")
    M = float(D.sum() + 1.0)
    outs = [_twin(D2, D2, init, k) for _, _, D2, init, k in
            tsolvers.cold_lanes(D, edges, device="cpu")]
    assert len(outs) > 1  # several launches, each with its lanes' k
    costs = torch.cat([o.best_costs for o in outs]).numpy().astype(np.float64) + M
    tours = torch.cat([o.best_tours for o in outs]).numpy()
    return got, (costs, _uses(tours, edges))


def _warm_fixed_edge_costs_batch(mesh):
    D = _distances(2, 2).astype(np.float64)
    edges = build_topology(N).edges[::3]
    best = nearest_neighbor_batch(torch.as_tensor(D, dtype=torch.float32)).numpy()
    got = tsolvers.warm_fixed_edge_costs_batch(D, edges, best, n_gls_iters=ITERS,
                                               perturbation_moves=PM, device="cpu")
    outs = [_twin(D2, D2, init, k) for _, _, D2, init, k in
            tsolvers.warm_lanes(D, edges, best, device="cpu")]
    assert len(outs) > 1
    E = len(edges)
    lanes = torch.cat([o.best_tours for o in outs]).view(2, 2, E, N + 1)
    search = torch.cat([o.best_costs for o in outs]).view(2, 2, E)
    tours = torch.where((search[:, 1] < search[:, 0])[..., None], lanes[:, 1],
                        lanes[:, 0]).numpy()
    costs = D[np.arange(2)[:, None, None], tours[..., :-1], tours[..., 1:]].sum(-1)
    return got, (costs, _uses(tours, edges), tours)


def _make_sharded_gls(mesh):
    D = _distances(4, 3)
    init = nearest_neighbor_batch(torch.as_tensor(D)).numpy()
    got = eval_shard.make_sharded_gls(mesh, n_iters=ITERS, perturbation_moves=PM)(
        D, D[:, None], init)
    out = _twin(D, D[:, None], init)
    tours = out.best_tours.numpy()
    return got, (tours, _tour_costs(D, tours), out.moves.numpy().astype(np.int64))


def _search_on_predictions(mesh):
    rng = np.random.default_rng(4)
    coords = rng.random((3, N, 2)).astype(np.float32)
    preds = rng.random((3, N * (N - 1) // 2)).astype(np.float32)
    res, _ = tev.search_on_predictions(preds, coords, n_iters=ITERS, perturbation_moves=PM,
                                       device="cpu")
    R = edge_vector_to_matrix(preds, N)
    init = nearest_neighbor_batch(torch.as_tensor(R))
    out = _twin(coords_to_distance_matrix(coords), R[:, None], init)
    got = (res.best_tours, res.search_costs, res.chunk_moves[:, -1], res.trace_costs,
           res.trace_moves)
    want = (out.best_tours.numpy(), out.best_costs.numpy(), out.moves.numpy(),
            out.trace_costs.numpy(), out.trace_moves.numpy())
    return got, want


@pytest.mark.parametrize("caller", CALLERS)
def test_k1_callers_reach_the_kernel_and_give_the_twins_bits(caller, launches, monkeypatch,
                                                             request):
    monkeypatch.setattr(tsolvers, "MAX_D2_BYTES", 4 * N * N * 7)  # 7 lanes a launch
    mesh = request.getfixturevalue("gloo_mesh") if caller == "make_sharded_gls" else None
    got, want = globals()[f"_{caller}"](mesh)
    assert launches
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gls_oracle_cuts_its_launches_by_bytes(launches, monkeypatch):
    """Five instances, two a launch: three launches with the one launch's bits."""
    D = _distances(5, 9)
    want = tsolvers.gls_oracle(D, n_iters=ITERS, perturbation_moves=PM, device="cpu")
    assert launches == [(5, N, N)]
    launches.clear()
    monkeypatch.setattr(tsolvers, "MAX_D2_BYTES", 4 * N * N * 2 + 1)
    got = tsolvers.gls_oracle(D, n_iters=ITERS, perturbation_moves=PM, device="cpu")
    assert launches == [(2, N, N), (2, N, N), (1, N, N)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _bit_reversed(k: int, bits: int) -> int:
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _kernel_tour_cost(vals: np.ndarray) -> np.float32:
    """csrc/gls_whole.cu's warp_tour_cost in numpy f32: lane l reduces its
    column q = l (mod 32) of the zero-padded edge terms, walking it in
    bit-reversed order with a stack of partial sums, kCostLevels (8) deep;
    then strides 16..1 add lane l + off into lane l, as __shfl_down_sync."""
    n = len(vals)
    p2 = 1
    while p2 < n:
        p2 *= 2
    val = lambda q: vals[q] if q < n else np.float32(0)  # noqa: E731
    xs = []
    for lane in range(32):
        if p2 <= 32:
            x = val(lane) if lane < p2 else np.float32(0)
        else:
            M = p2 >> 5
            lm = M.bit_length() - 1
            st = [None] * 8
            for kk in range(M):
                x = val(lane + 32 * _bit_reversed(kk, lm))
                for lv in range(8):
                    if not (kk >> lv) & 1:
                        st[lv] = x
                        break
                    x = np.float32(st[lv] + x)
        xs.append(x)
    off = min(16, p2 >> 1)
    while off > 0:
        xs = [np.float32(xs[l] + xs[l + off]) if l + off < 32 else xs[l] for l in range(32)]
        off >>= 1
    return xs[0]


@pytest.mark.parametrize("n", [5, 33, 100, 1000, 1025, 2100, 4097, gw.MAX_N])
def test_kernel_tour_cost_adds_in_the_twins_order(n):
    """The kernel's tour cost, emulated, gives the bits of `tree_sum`, the
    twin's, on edge terms spread over five decades (so the order shows)."""
    rng = np.random.default_rng(n)
    vals = (rng.random(n) * 10.0 ** rng.integers(-2, 3, n)).astype(np.float32)
    want = tree_sum(torch.as_tensor(vals)[None])[0].numpy()
    assert _kernel_tour_cost(vals).tobytes() == want.tobytes()


def _labels_data():
    rng = np.random.default_rng(6)
    coords = rng.random((2, 8, 2)).astype(np.float32)
    D = coords_to_distance_matrix(coords).astype(np.float64)
    tours = nearest_neighbor_batch(torch.as_tensor(D, dtype=torch.float32)).numpy()
    return {"coords": coords, "opt_tour": tours}


@pytest.mark.parametrize("fn,kw", [
    ("gls_oracle", {"seed": 7}),
    ("gls_fixed_edge_costs", {"edge_chunk": 3}),
    ("warm_fixed_edge_costs", {"edge_chunk": 3}),
    ("warm_fixed_edge_costs_batch", {"inst_chunk": 1}),
    ("warm_labels_chunked", {"duty_work": 1, "duty_idle_s": 0.0}),
    ("make_sharded_gls", {"trace_cap": 1, "use_shard_map": False}),
])
def test_jax_keywords_are_accepted_and_change_nothing(fn, kw, request, tmp_path):
    """Each keyword of gnngls_tpu's that sizes its TPU work (or, for `seed`,
    that gnngls_tpu does not use either) runs and returns what the call
    without it returns."""
    D = _distances(2, 8)
    edges = build_topology(N).edges[::9]
    best = nearest_neighbor_batch(torch.as_tensor(D)).numpy()
    if fn == "make_sharded_gls":
        mesh = request.getfixturevalue("gloo_mesh")
        init = best

        def call(**extra):
            return eval_shard.make_sharded_gls(mesh, n_iters=2, perturbation_moves=PM,
                                               **extra)(D, D[:, None], init)
    elif fn == "warm_labels_chunked":
        def call(**extra):
            out = tlabels.warm_labels_chunked(_labels_data(), tmp_path / str(len(extra)),
                                              chunk=1, device="cpu", **extra)
            return tuple(out[k] for k in ("regret", "opt_tour", "opt_cost", "in_solution"))
    else:
        args = {"gls_oracle": (D,), "gls_fixed_edge_costs": (D[0], edges),
                "warm_fixed_edge_costs": (D[0], edges, best[0]),
                "warm_fixed_edge_costs_batch": (D, edges, best)}[fn]

        def call(**extra):
            return getattr(tsolvers, fn)(*args, perturbation_moves=PM, device="cpu", **extra)
    for a, b in zip(call(**kw), call()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
