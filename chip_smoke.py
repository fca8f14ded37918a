#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gnngls_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printed with the elapsed seconds; any failure exits non-zero
and prints no result line:
  0. the card (nvidia-smi name and power limit); build the kernels with nvcc.
  1. the GAT group kernel against its plain twin on the card: layer-0
     activations of the shipped tsp100 checkpoint (B=2, n=100, H=8, F=16) and
     seeded inputs with a 10x spread (B=3, n=20, H=4, F=8).
  2. the whole-GLS kernel against its plain twin on the card, for
     (n, B, iters, pm) in (20, 8, 5, 4), (50, 4, 5, 8), (100, 2, 3, 20) under
     the weight guide, a regret-like guide and a two-guide cycle: tours,
     moves, traces and work counters identical.
  3. the main path: gnngls_tpu_torch.evaluate.evaluate on the 500 tsp100 test
     instances with the shipped checkpoint, guide regret_pred, n_iters=100,
     perturbation_moves=20, batch_size=64, with the launch counts reset just
     before and read just after; tours checked, and instances 0-63 held
     against the committed JAX fixture (mean gap within 0.1 pp).
  4. both kernels timed (CUDA events) and held against their twins at the
     main path's shapes (K2: B=64 n=100 H=8 F=16; K1: B=500 n=100 G=1
     n_iters=100 pm=20), with their bounds.
  5. the source-chunked GAT kernel (K3) against its plain twin on the card:
     layer-0 activations of the checkpoint on two seeded n=500 instances
     (gs=16, padded) and seeded inputs with a 10x spread (n=40 H=4 F=8 gs=8).
  6. the whole-GLS kernel's global layout: bit for bit equal to the shared
     layout at n=100 (B=8, weight guide and a two-guide cycle), to its plain
     twin at n=500 (B=2, n_iters=3, pm=30), and valid tours at n=1000.
  7. the tsp500 path, with the launch counts reset just before and read just
     after: generate_instances(128, 500, seed=3, solver="gls",
     opt_iters=100) (the GLS oracle), TSPDataset.from_arrays with the tsp100
     scalers and zero regret, and evaluate(guide regret_pred, n_iters=40,
     perturbation_moves=20, batch_size=16); tours checked, gaps against the
     oracle, moves/s, edges/s, stage times and peak memory.
  8. the n=200 JAX fixture: predictions within 5e-4 and best costs of the
     search equal to gnngls_tpu's (gnngls_tpu_torch/testdata/).
  9. K3, K2 (the route's alternative) and K1's global layout timed at the
     tsp500 path's shapes and held against their twins there, with bounds;
     then the `kernels` JSON line and the result line.
It imports neither jax nor gnngls_tpu, pandas, networkx or matplotlib.
"""

import json
import pathlib
import subprocess
import sys
import time
import traceback

T0 = time.time()
ROOT = pathlib.Path(__file__).resolve().parent
N_ITERS, PM, BATCH = 100, 20, 64
# the tsp500 path (benchmarks/tsp500_e2e.py's evaluation through the port)
N500, N_INST500, SEED500, ORACLE_ITERS, ORACLE_PM = 500, 128, 3, 100, 30
N_ITERS500, BATCH500 = 40, 16
PRED_TOL = 5e-4  # predictions against the JAX fixture (benchmarks/PARITY.md's scale)
PEAK_F32 = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
K2_REL_TOL = 1e-5  # max |kernel - plain| <= K2_REL_TOL * max |plain|
K3_REL_TOL = 1e-5  # the same for the source-chunked kernel
FORBIDDEN = ("jax", "gnngls_tpu", "pandas", "networkx", "matplotlib")


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def errs(a, b):
    """(max abs error, max abs error / max |b|)."""
    d = float((a.double() - b.double()).abs().max())
    return d, d / max(float(b.double().abs().max()), 1e-30)


def gat_partials_work(B, n, H, F):
    """(operations, bytes) of the group partials' function at this shape:
    (2F+6) operations per (target, source, head) pair (F FMAs, the score, its
    leaky, the exp, the sums); el, er, h read once, m, z, num written once."""
    g, E = n - 1, n * (n - 1) // 2
    ops = B * n * g * (g - 1) * H * (2 * F + 6)
    nbytes = 4 * (2 * B * E * H + B * E * H * F + n * g + 2 * B * n * g * H + B * n * g * H * F)
    return ops, nbytes


def gls_work(work, n, G, n_iters):
    """(operations, bytes) of the whole GLS for this run's data: its
    local-search and perturbation rounds (the kernel reports them) times the
    additions of their scans; D and the guides read once, tours, costs and
    traces written once."""
    rounds = work.double().sum(dim=0).tolist()  # (local-search, perturbation) rounds
    B = work.shape[0]
    per_ls = 3 * (n - 2) * (n - 3) / 2 + 5 * (n - 2) ** 2  # adds over all a2a candidates
    per_pert = 46 * n  # utility, two o2a scans under D + k*P per endpoint, re-costs
    ops = rounds[0] * per_ls + rounds[1] * per_pert
    nbytes = 4 * (B * n * n * (1 + G) + 2 * B * (n + 1) + B * (4 + 2 * n_iters))
    return ops, nbytes


def row(name, source, replaces, launches, err, ms, plain, ops, nbytes, shape, **extra):
    """One entry of the `kernels` JSON line; the bound is the larger of the
    operations over the f32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": shape, **extra}


def phase0_build():
    from gnngls_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t = time.time()
    path = kernels.build()
    kernels.library()
    log(f"phase 0: kernels built in {time.time() - t:.1f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "entry function" in line or "registers" in line:
            log("  ptxas: " + line.strip())
    return card


def phase1_gat(model, ds, dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.ops.gat import project
    from gnngls_tpu_torch.ops.gat_group import (gat_group_partials,
                                                gat_group_partials_plain,
                                                merge_group_partials)

    worst = 0.0
    layer0 = model.layers[0].gat.params()
    rng = np.random.default_rng(0)
    cases = []
    with torch.no_grad():
        x = torch.as_tensor(ds.get_scaled_batch([0, 1])["features"], device=dev)
        cases.append(("checkpoint layer 0, B=2 n=100 H=8 F=16", 100,
                      project(layer0, model.embed(x), 8)))
        n, H, F = 20, 4, 8
        E = n * (n - 1) // 2
        rnd = lambda *shape: torch.as_tensor(  # noqa: E731
            10 * rng.standard_normal(shape), dtype=torch.float32, device=dev)
        cases.append(("seeded x10 spread, B=3 n=20 H=4 F=8", n,
                      (rnd(3, E, H, F), rnd(3, E, H), rnd(3, E, H))))
        for name, n, (h, el, er) in cases:
            topo = build_topology(n)
            city = torch.as_tensor(topo.city_edges, dtype=torch.int32, device=dev)
            args = (el.contiguous(), er.contiguous(), h.contiguous(), city)
            got = gat_group_partials(*args)
            torch.cuda.synchronize()
            want = gat_group_partials_plain(*args)
            parts = dict(zip(("m", "z", "num"), zip(got, want)))
            parts["merged"] = (merge_group_partials(*got, topo),
                               merge_group_partials(*want, topo))
            for key, (a, b) in parts.items():
                ab, rel = errs(a, b)
                worst = max(worst, ab)
                log(f"  K2 {name}: {key:6s} max abs {ab:.3e}  rel {rel:.3e}")
                require(rel <= K2_REL_TOL, f"K2 {name} {key}: rel err {rel:.3e} > {K2_REL_TOL}")
    log(f"phase 1: K2 matches its plain twin (rel tol {K2_REL_TOL})")
    return worst


def phase2_gls(dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    worst = 0.0
    for n, B, iters, pm in ((20, 8, 5, 4), (50, 4, 5, 8), (100, 2, 3, 20)):
        rng = np.random.default_rng(n)
        D = coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32))
        noise = rng.random((B, n, n)).astype(np.float32)
        regret = np.maximum(D + 0.3 * (noise + noise.transpose(0, 2, 1)) - 0.4, 0.0)
        regret = regret.astype(np.float32)
        for gname, G in (("weight", D[:, None]), ("regret-like", regret[:, None]),
                         ("cycle of 2", np.stack([regret, D], axis=1))):
            Dt = torch.as_tensor(D, device=dev)
            Gt = torch.as_tensor(np.ascontiguousarray(G), device=dev)
            T = nearest_neighbor_batch(Gt[:, 0])
            got = gls_whole(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
            torch.cuda.synchronize()
            want = gls_fixed_plain(Dt, Gt, T, n_iters=iters, perturbation_moves=pm)
            for key in ("best_tours", "moves", "trace_costs", "trace_moves", "work"):
                require(torch.equal(getattr(got, key), getattr(want, key)),
                        f"K1 n={n} {gname}: {key} differs from the plain twin")
            ulp = torch.finfo(torch.float32).eps * want.best_costs.abs()
            dc = (got.best_costs - want.best_costs).abs()
            require(bool((dc <= ulp).all()), f"K1 n={n} {gname}: best costs differ by > 1 ulp")
            worst = max(worst, float(dc.max()))
            log(f"  K1 n={n} B={B} iters={iters} pm={pm} {gname}: identical "
                f"(moves {got.moves.tolist()})")
    log("phase 2: K1 matches its plain twin move for move")
    return worst


def phase3_main(model, ds, dev):
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.evaluate import evaluate
    from gnngls_tpu_torch.utils import is_valid_tour

    kernels.reset_launch_counts()
    t = time.time()
    out = evaluate(ds, model=model, guides=["regret_pred"], n_iters=N_ITERS,
                   perturbation_moves=PM, batch_size=BATCH, device=dev)
    wall = time.time() - t
    counts = dict(kernels.launches)
    log(f"phase 3: evaluate on {len(ds)} instances in {wall:.1f} s; launches {counts}")
    require(counts.get("gat_group", 0) > 0 and counts.get("gls_whole", 0) > 0,
            f"a kernel of the main path did not launch: {counts}")
    n = ds.n_nodes
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix

    D = coords_to_distance_matrix(ds.coords).astype(np.float64)
    tours = out["best_tours"]
    for b in range(len(ds)):
        require(is_valid_tour(n, tours[b]), f"instance {b}: invalid tour")
    exact = D[np.arange(len(ds))[:, None], tours[:, :-1], tours[:, 1:]].sum(-1)
    require(np.allclose(out["best_costs"], exact, rtol=1e-6),
            "best costs differ from the tours' costs")
    kc = out["result"].search_costs
    require(np.abs(kc - out["best_costs"]).max() < 1e-3,
            "the kernel's cost accounting drifted from the tours' costs")
    gaps = out["gaps"]
    tm = out["timings"]
    moves = int(out["moves"].sum())
    edges = len(ds) * n * (n - 1) // 2
    log(f"  gap mean {gaps.mean():.4f}%  median {np.median(gaps):.4f}%  max {gaps.max():.4f}%")
    log(f"  inference {tm['inference_s']:.3f} s ({edges / tm['inference_s']:.4g} edges/s); "
        f"search {tm['search_s']:.3f} s ({moves} accepted moves, "
        f"{moves / tm['search_s']:.4g} moves/s)")

    fx = json.loads((ROOT / "gnngls_tpu_torch/testdata/jax_tsp100_test64_it100.json").read_text())
    k = min(len(fx["best_cost"]), len(ds))
    mine = np.float32(out["best_costs"][:k])
    theirs = np.float32(fx["best_cost"][:k])
    eq = int((mine == theirs).sum())
    my_gap = float(((out["best_costs"][:k] / ds.opt_cost[:k]) - 1.0).mean() * 100.0)
    log(f"  vs JAX fixture (instances 0-{k - 1}): {eq}/{k} best costs equal, largest "
        f"difference {float(np.abs(mine - theirs).max()):.3e}; mean gap {my_gap:.4f}% "
        f"vs {fx['mean_gap']:.4f}%")
    require(k == len(fx["best_cost"]) and abs(my_gap - fx["mean_gap"]) <= 0.1,
            "mean gap over 0-63 differs from the JAX fixture by more than 0.1 pp")
    return out, counts


def phase4_timings(model, ds, dev, out, counts, k2_err, k1_err):
    """Time both kernels and their twins at the main path's shapes, and hold
    each kernel against its twin there too."""
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.ops.gat import project
    from gnngls_tpu_torch.ops.gat_group import gat_group_partials, gat_group_partials_plain
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    n = ds.n_nodes
    g = n - 1
    topo = build_topology(n)
    with torch.no_grad():
        x = torch.as_tensor(ds.get_scaled_batch(np.arange(BATCH))["features"], device=dev)
        h, el, er = project(model.layers[0].gat.params(), model.embed(x), model.cfg.n_heads)
        args = (el.contiguous(), er.contiguous(), h.contiguous(),
                torch.as_tensor(topo.city_edges, dtype=torch.int32, device=dev))
        B, E, H, F = h.shape
        k2_ms = cuda_ms(lambda: gat_group_partials(*args), reps=10, warmup=2)
        k2_plain = cuda_ms(lambda: gat_group_partials_plain(*args), reps=2)
        for key, a, b in zip(("m", "z", "num"), gat_group_partials(*args),
                             gat_group_partials_plain(*args)):
            ab, rel = errs(a, b)
            k2_err = max(k2_err, ab)
            require(rel <= K2_REL_TOL, f"K2 at B={B}: {key} rel err {rel:.3e} > {K2_REL_TOL}")
    k2_ops, k2_bytes = gat_partials_work(B, n, H, F)
    log(f"  K2 at B={B} n={n} H={H} F={F}: {k2_ms:.4f} ms/launch, plain {k2_plain:.3f} ms; "
        f"agree within rel {K2_REL_TOL}")

    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix

    Dt = torch.as_tensor(coords_to_distance_matrix(ds.coords), device=dev)
    Gt = torch.as_tensor(np.ascontiguousarray(out["guide_stack"], dtype=np.float32), device=dev)
    Tt = torch.as_tensor(np.ascontiguousarray(out["init_tours"], dtype=np.int32), device=dev)
    res = {}

    def run(fn, key):
        res[key] = fn(Dt, Gt, Tt, n_iters=N_ITERS, perturbation_moves=PM)

    k1_ms = cuda_ms(lambda: run(gls_whole, "kernel"), reps=3, warmup=1)
    k1_plain = cuda_ms(lambda: run(gls_fixed_plain, "plain"), reps=1, warmup=0)
    for key in ("best_tours", "moves", "trace_costs", "trace_moves", "work", "best_costs"):
        require(torch.equal(getattr(res["kernel"], key), getattr(res["plain"], key)),
                f"K1 at the main path's shape: {key} differs from the plain twin")
    Bk = Dt.shape[0]
    k1_ops, k1_bytes = gls_work(res["kernel"].work, n, Gt.shape[1], N_ITERS)
    log(f"  K1 at B={Bk} n={n} n_iters={N_ITERS} pm={PM}: {k1_ms:.2f} ms/launch, plain "
        f"{k1_plain:.1f} ms; identical outputs")

    return [
        row("gat_group", "gnngls_tpu_torch/csrc/gat_group.cu",
            "gnngls_tpu/ops/pallas_gat.py:41", counts.get("gat_group", 0), k2_err,
            k2_ms, k2_plain, k2_ops, k2_bytes, f"B={B} n={n} H={H} F={F}"),
        row("gls_whole", "gnngls_tpu_torch/csrc/gls_whole.cu",
            "gnngls_tpu/search/pallas_gls.py:257", counts.get("gls_whole", 0), k1_err,
            k1_ms, k1_plain, k1_ops, k1_bytes,
            f"shared layout, B={Bk} n={n} G=1 n_iters={N_ITERS} pm={PM}"),
    ]


def layer0_inputs(model, coords, dev):
    """The checkpoint's layer-0 el, er, h and city_edges on these instances."""
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.core.scaler import load_scalers
    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.ops.gat import project

    B, n, _ = coords.shape
    E = n * (n - 1) // 2
    d = {"coords": coords, "regret": np.zeros((B, E), np.float32),
         "in_solution": np.zeros((B, E), bool), "opt_cost": np.ones(B)}
    ds = TSPDataset.from_arrays(d, scalers=load_scalers(ROOT / "models/tsp100/scalers.json"))
    with torch.no_grad():
        x = torch.as_tensor(ds.get_scaled_batch(np.arange(B))["features"], device=dev)
        h, el, er = project(model.layers[0].gat.params(), model.embed(x), model.cfg.n_heads)
    city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=dev)
    return el.contiguous(), er.contiguous(), h.contiguous(), city


def phase5_gat_chunked(model, dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.ops.gat_group import (gat_group_partials_chunked,
                                                gat_group_partials_chunked_plain,
                                                merge_group_partials, source_chunk)

    worst = 0.0
    coords = np.random.default_rng(SEED500).random((2, N500, 2)).astype(np.float32)
    gs500 = source_chunk(N500, model.cfg.embed_dim)
    require(gs500 > 0, f"n={N500} does not take the source-chunked partials")
    rng = np.random.default_rng(40)
    n, H, F = 40, 4, 8
    E = n * (n - 1) // 2
    rnd = lambda *shape: torch.as_tensor(  # noqa: E731
        10 * rng.standard_normal(shape), dtype=torch.float32, device=dev)
    city40 = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32, device=dev)
    cases = [(f"checkpoint layer 0, B=2 n={N500} H=8 F=16 gs={gs500}", N500, gs500,
              layer0_inputs(model, coords, dev)),
             ("seeded x10 spread, B=3 n=40 H=4 F=8 gs=8", n, 8,
              (rnd(3, E, H), rnd(3, E, H), rnd(3, E, H, F), city40))]
    with torch.no_grad():
        for name, n, gs, args in cases:
            got = gat_group_partials_chunked(*args, gs)
            torch.cuda.synchronize()
            want = gat_group_partials_chunked_plain(*args, gs)
            require(torch.equal(got[0], want[0]), f"K3 {name}: the maxima differ")
            parts = dict(zip(("m", "z", "num"), zip(got, want)))
            topo = build_topology(n)
            parts["merged"] = (merge_group_partials(*got, topo),
                               merge_group_partials(*want, topo))
            for key, (a, b) in parts.items():
                ab, rel = errs(a, b)
                worst = max(worst, ab)
                log(f"  K3 {name}: {key:6s} max abs {ab:.3e}  rel {rel:.3e}")
                require(rel <= K3_REL_TOL, f"K3 {name} {key}: rel err {rel:.3e} > {K3_REL_TOL}")
    log(f"phase 5: K3 matches its plain twin (rel tol {K3_REL_TOL})")
    return worst


def phase6_gls_global(dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain
    from gnngls_tpu_torch.utils import is_valid_tour

    def case(n, B, seed):
        rng = np.random.default_rng(seed)
        D = torch.as_tensor(coords_to_distance_matrix(rng.random((B, n, 2)).astype(np.float32)),
                            device=dev)
        noise = torch.as_tensor(rng.random((B, n, n)), dtype=torch.float32, device=dev)
        regret = torch.clamp(D + 0.3 * (noise + noise.transpose(1, 2)) - 0.4, min=0.0)
        return D, regret, nearest_neighbor_batch(D)

    def same(a, b, what):
        for key in a._fields:
            require(torch.equal(getattr(a, key), getattr(b, key)), f"K1 {what}: {key} differs")

    D, regret, T = case(100, 8, 100)
    for gname, G in (("weight", D[:, None]), ("cycle of 2", torch.stack([regret, D], 1))):
        kw = dict(n_iters=5, perturbation_moves=PM)
        same(gls_whole(D, G.contiguous(), T, layout="global", **kw),
             gls_whole(D, G.contiguous(), T, layout="shared", **kw),
             f"n=100 B=8 {gname}, global vs shared layout")
        log(f"  K1 n=100 B=8 {gname}: global layout == shared layout, bit for bit")
    D, _, T = case(N500, 2, N500)
    kw = dict(n_iters=3, perturbation_moves=ORACLE_PM)
    got = gls_whole(D, D[:, None].contiguous(), T, **kw)
    torch.cuda.synchronize()
    same(got, gls_fixed_plain(D, D[:, None], T, **kw), f"n={N500} B=2, global vs plain")
    log(f"  K1 n={N500} B=2 n_iters=3 pm={ORACLE_PM}: global layout == plain twin, bit for "
        f"bit (moves {got.moves.tolist()})")
    D, _, T = case(1000, 1, 1000)
    got = gls_whole(D, D[:, None].contiguous(), T, n_iters=1, perturbation_moves=PM)
    tour = got.best_tours[0].cpu().numpy()
    require(is_valid_tour(1000, tour), "K1 n=1000: invalid tour")
    cost = float(D[0][got.best_tours[0, :-1].long(), got.best_tours[0, 1:].long()].sum())
    init = float(D[0][T[0, :-1].long(), T[0, 1:].long()].sum())
    require(cost < init, "K1 n=1000: the search did not improve the start")
    log(f"  K1 n=1000 B=1 n_iters=1: valid tour, cost {cost:.4f} from {init:.4f} "
        f"({int(got.moves[0])} moves)")
    log("phase 6: K1's global layout matches the shared layout and the plain twin")


def phase7_tsp500(model, dev):
    import numpy as np

    from gnngls_tpu_torch import kernels
    from gnngls_tpu_torch.core.scaler import load_scalers
    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix, generate_instances
    from gnngls_tpu_torch.evaluate import evaluate
    from gnngls_tpu_torch.utils import is_valid_tour

    kernels.reset_launch_counts()
    t = time.time()
    data = generate_instances(N_INST500, N500, seed=SEED500, solver="gls",
                              opt_iters=ORACLE_ITERS, device=dev)
    oracle_s = time.time() - t
    d = dict(data)
    d["regret"] = np.zeros_like(np.asarray(d["in_solution"], np.float32))
    ds = TSPDataset.from_arrays(d, scalers=load_scalers(ROOT / "models/tsp100/scalers.json"))
    t = time.time()
    out = evaluate(ds, model=model, guides=["regret_pred"], n_iters=N_ITERS500,
                   perturbation_moves=20, batch_size=BATCH500, device=dev)
    eval_s = time.time() - t
    counts = dict(kernels.launches)
    batches = -(-N_INST500 // BATCH500)
    log(f"phase 7: tsp500 path, {N_INST500} instances: oracle {oracle_s:.1f} s, evaluate "
        f"{eval_s:.1f} s; launches {counts}")
    want = {"gat_group_chunked": model.cfg.depth * batches, "gat_group": 0, "gls_whole": 2}
    require(all(counts.get(k, 0) == v for k, v in want.items()),
            f"tsp500 path launches {counts}, expected {want}")
    D = coords_to_distance_matrix(ds.coords).astype(np.float64)
    for name, tours in (("oracle", data["opt_tour"]), ("eval", out["best_tours"])):
        for b in range(N_INST500):
            require(is_valid_tour(N500, tours[b]), f"tsp500 {name} instance {b}: invalid tour")
    exact = D[np.arange(N_INST500)[:, None], out["best_tours"][:, :-1],
              out["best_tours"][:, 1:]].sum(-1)
    require(np.allclose(out["best_costs"], exact, rtol=1e-6),
            "tsp500: best costs differ from the tours' costs")
    gaps = out["gaps"]
    require(bool(np.isfinite(gaps).all()), "tsp500: gaps are not finite")
    tm = out["timings"]
    moves = int(out["moves"].sum())
    edges = N_INST500 * N500 * (N500 - 1) // 2
    log(f"  gap vs the oracle (n_iters={ORACLE_ITERS}): mean {gaps.mean():.4f}%  median "
        f"{np.median(gaps):.4f}%  max {gaps.max():.4f}%")
    log(f"  inference {tm['inference_s']:.3f} s ({edges / tm['inference_s']:.4g} edges/s); "
        f"search {tm['search_s']:.3f} s ({moves} accepted moves, "
        f"{moves / tm['search_s']:.4g} moves/s); total {tm['total_s']:.3f} s; peak device "
        f"memory {tm['peak_device_bytes'] / 2 ** 30:.3f} GiB")
    return data, out, counts


def phase8_fixture200(model, dev):
    import numpy as np
    import torch

    from gnngls_tpu_torch.core.graph import edge_vector_to_matrix
    from gnngls_tpu_torch.core.scaler import load_scalers
    from gnngls_tpu_torch.data.dataset import TSPDataset
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.evaluate import evaluate
    from gnngls_tpu_torch.search import batched

    fx = np.load(ROOT / "gnngls_tpu_torch/testdata/jax_tsp200_seed3.npz")
    B, n, _ = fx["coords"].shape
    coords = np.random.default_rng(SEED500).random((B, n, 2)).astype(np.float32)
    require(np.array_equal(coords, fx["coords"]), "n=200 fixture: other coordinates")
    E = n * (n - 1) // 2
    d = {"coords": coords, "regret": np.zeros((B, E), np.float32),
         "in_solution": np.zeros((B, E), bool), "opt_cost": np.ones(B)}
    ds = TSPDataset.from_arrays(d, scalers=load_scalers(ROOT / "models/tsp100/scalers.json"))
    n_iters, pm = int(fx["n_iters"]), int(fx["perturbation_moves"])
    out = evaluate(ds, model=model, guides=["regret_pred"], n_iters=n_iters,
                   perturbation_moves=pm, batch_size=B, device=dev)
    us, vs = np.triu_indices(n, k=1)
    pred = out["guide_stack"][:, 0, us, vs]  # the predictions, scattered to (n, n)
    err = float(np.abs(pred - fx["pred"]).max())
    log(f"  n={n} predictions vs the JAX fixture: max abs {err:.3e} (tol {PRED_TOL})")
    require(err <= PRED_TOL, f"n={n} predictions differ from JAX by {err:.3e}")
    mine = np.float32(out["best_costs"])
    eq = mine == fx["best_cost"]
    log(f"  n={n} search (n_iters={n_iters}, pm={pm}): best costs {mine.tolist()} vs JAX "
        f"{fx['best_cost'].tolist()}; moves {out['moves'].tolist()} vs {fx['moves'].tolist()}")
    if not eq.all():
        # explained only if the search on JAX's own predictions gives JAX's costs:
        # then the predictions' last-bit rounding on the card moved the search
        Ds = coords_to_distance_matrix(coords)
        R = edge_vector_to_matrix(fx["pred"], n)
        inits = batched.nearest_neighbor_batch(torch.as_tensor(R, device=dev)).cpu().numpy()
        res = batched.run_fixed_kernel(Ds, R[:, None], inits, n_iters=n_iters,
                                       perturbation_moves=pm, device=dev)
        require(np.array_equal(np.float32(res.best_costs), fx["best_cost"]),
                f"n={n}: the card's search on JAX's predictions differs from the fixture")
        log(f"  instances {np.flatnonzero(~eq).tolist()} differ through the predictions' "
            "rounding: the card's search on JAX's own predictions gives JAX's best costs")
    log(f"phase 8: the n={n} JAX fixture holds ({int(eq.sum())}/{B} best costs equal)")


def phase9_timings500(model, data, out, counts7, k3_err, dev):
    """K3 and K2 at B=16 n=500 H=8 F=16 on the path's layer-0 activations;
    K1's global layout at the eval and the oracle launches."""
    import numpy as np
    import torch

    from gnngls_tpu_torch.ops.gat_group import (gat_group_partials, gat_group_partials_chunked,
                                                gat_group_partials_chunked_plain,
                                                merge_group_partials, source_chunk)
    from gnngls_tpu_torch.core.graph import build_topology
    from gnngls_tpu_torch.data.generate import coords_to_distance_matrix
    from gnngls_tpu_torch.search.construct import nearest_neighbor_batch
    from gnngls_tpu_torch.search.gls_whole import gls_whole
    from gnngls_tpu_torch.search.local_search import gls_fixed_plain

    n = N500
    gs = source_chunk(n, model.cfg.embed_dim)
    args = layer0_inputs(model, data["coords"][:BATCH500], dev)
    B, E, H, F = args[2].shape
    with torch.no_grad():
        k3_ms = cuda_ms(lambda: gat_group_partials_chunked(*args, gs), reps=5, warmup=1)
        k2_ms = cuda_ms(lambda: gat_group_partials(*args), reps=5, warmup=1)
        k3_plain = cuda_ms(lambda: gat_group_partials_chunked_plain(*args, gs), reps=1)
        got = gat_group_partials_chunked(*args, gs)
        want = gat_group_partials_chunked_plain(*args, gs)
        require(torch.equal(got[0], want[0]), f"K3 at B={B} n={n}: the maxima differ")
        for key, a, b in zip(("m", "z", "num"), got, want):
            ab, rel = errs(a, b)
            k3_err = max(k3_err, ab)
            require(rel <= K3_REL_TOL, f"K3 at B={B} n={n}: {key} rel err {rel:.3e}")
        del want
        topo = build_topology(n)
        ab, rel = errs(merge_group_partials(*got, topo),
                       merge_group_partials(*gat_group_partials(*args), topo))
        require(rel <= K3_REL_TOL, f"K3 and K2 at n={n} disagree: rel {rel:.3e}")
    k3_ops, k3_bytes = gat_partials_work(B, n, H, F)
    log(f"  K3 at B={B} n={n} H={H} F={F} gs={gs}: {k3_ms:.4f} ms/launch, plain "
        f"{k3_plain:.3f} ms; K2 (one-shot) at the same shape {k2_ms:.4f} ms; "
        f"merged K3 vs K2 rel {rel:.3e}")

    rows = [row("gat_group_chunked", "gnngls_tpu_torch/csrc/gat_group_chunked.cu",
                "gnngls_tpu/ops/pallas_gat.py:79", counts7.get("gat_group_chunked", 0), k3_err,
                k3_ms, k3_plain, k3_ops, k3_bytes, f"B={B} n={n} H={H} F={F} gs={gs}",
                one_shot_k2_ms=k2_ms)]
    Dt = torch.as_tensor(coords_to_distance_matrix(data["coords"]), device=dev)
    launches = (
        ("eval", torch.as_tensor(np.ascontiguousarray(out["guide_stack"], dtype=np.float32),
                                 device=dev),
         torch.as_tensor(out["init_tours"], device=dev), N_ITERS500, 20),
        ("oracle", Dt[:, None].contiguous(), nearest_neighbor_batch(Dt), ORACLE_ITERS,
         ORACLE_PM))
    for name, Gt, Tt, iters, pm in launches:
        res = {}

        def run(fn, key):
            res[key] = fn(Dt, Gt, Tt, n_iters=iters, perturbation_moves=pm)

        ms = cuda_ms(lambda: run(gls_whole, "kernel"), reps=2, warmup=1)
        plain = cuda_ms(lambda: run(gls_fixed_plain, "plain"), reps=1, warmup=0)
        for key in res["kernel"]._fields:
            require(torch.equal(getattr(res["kernel"], key), getattr(res["plain"], key)),
                    f"K1 global layout at the {name} launch: {key} differs from the twin")
        ops, nbytes = gls_work(res["kernel"].work, n, Gt.shape[1], iters)
        shape = f"global layout, {name} launch: B={Dt.shape[0]} n={n} G={Gt.shape[1]} " \
                f"n_iters={iters} pm={pm}"
        log(f"  K1 {shape}: {ms:.2f} ms/launch, plain {plain:.1f} ms; identical outputs")
        # both launches of the tsp500 path run this layout: counts7 holds the two
        rows.append(row(f"gls_whole_global_{name}", "gnngls_tpu_torch/csrc/gls_whole.cu",
                        "gnngls_tpu/search/pallas_gls.py:257", counts7.get("gls_whole", 0),
                        0.0, ms, plain, ops, nbytes, shape))
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "gnngls_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from gnngls_tpu_torch.data.dataset import TSPDataset
        from gnngls_tpu_torch.models.convert import load_model
        from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig, exact_f32_matmuls

        exact_f32_matmuls()
        dev = torch.device("cuda")
        card = phase0_build()
        ds = TSPDataset.from_npz(ROOT / "data/tsp100/instances.npz",
                                 ROOT / "data/tsp100/test.txt",
                                 scalers_file=ROOT / "data/tsp100/scalers.json")
        model = load_model(ROOT / "models/tsp100/checkpoint_best_val.npz",
                           RegretGNNConfig(), device=dev)
        log(f"loaded {len(ds)} tsp100 test instances and the checkpoint")
        k2_err = phase1_gat(model, ds, dev)
        k1_err = phase2_gls(dev)
        out, counts = phase3_main(model, ds, dev)
        rows = phase4_timings(model, ds, dev, out, counts, k2_err, k1_err)
        log("phase 4: the tsp100 path's kernels timed")
        del out
        k3_err = phase5_gat_chunked(model, dev)
        phase6_gls_global(dev)
        data, out500, counts500 = phase7_tsp500(model, dev)
        phase8_fixture200(model, dev)
        rows += phase9_timings500(model, data, out500, counts500, k3_err, dev)
        bad = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
        require(not bad, f"imported modules the port must not use: {bad}")
        log(f"phase 9: done on {card}")
        print(json.dumps({"kernels": rows}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception:  # the smoke test's boundary: report and fail
        traceback.print_exc()
        print(f"chip_smoke: FAILED after {time.time() - T0:.1f} s", file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
