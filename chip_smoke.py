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
     n_iters=100 pm=20), bounds, and a `kernels` JSON line; then the result
     line.
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
PEAK_F32 = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
K2_REL_TOL = 1e-5  # max |kernel - plain| <= K2_REL_TOL * max |plain|
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
    k2_bytes = 4 * (2 * B * E * H + B * E * H * F + n * g + 2 * B * n * g * H + B * n * g * H * F)
    k2_ops = B * n * g * (g - 1) * H * (2 * F + 6)  # per pair: F FMAs, 2 scores, exp, sums
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
    work = out["result"].work.astype(np.float64)
    Bk = Dt.shape[0]
    per_ls = 3 * (n - 2) * (n - 3) / 2 + 5 * (n - 2) ** 2  # adds over all a2a candidates
    per_pert = 46 * n  # utility, two o2a scans under D + k*P per endpoint, re-costs
    k1_ops = float(work[:, 0].sum() * per_ls + work[:, 1].sum() * per_pert)
    k1_bytes = 4 * (Bk * n * n * (1 + Gt.shape[1]) + 2 * Bk * (n + 1)
                    + Bk * (4 + 2 * N_ITERS))
    log(f"  K1 at B={Bk} n={n} n_iters={N_ITERS} pm={PM}: {k1_ms:.2f} ms/launch, plain "
        f"{k1_plain:.1f} ms; identical outputs")

    def row(name, source, replaces, launches, err, ms, plain, ops, nbytes, shape):
        t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None, "shape": shape}

    return {"kernels": [
        row("gat_group", "gnngls_tpu_torch/csrc/gat_group.cu",
            "gnngls_tpu/ops/pallas_gat.py:41", counts.get("gat_group", 0), k2_err,
            k2_ms, k2_plain, k2_ops, k2_bytes, f"B={B} n={n} H={H} F={F}"),
        row("gls_whole", "gnngls_tpu_torch/csrc/gls_whole.cu",
            "gnngls_tpu/search/pallas_gls.py:257", counts.get("gls_whole", 0), k1_err,
            k1_ms, k1_plain, k1_ops, k1_bytes, f"B={Bk} n={n} G=1 n_iters={N_ITERS} pm={PM}"),
    ]}


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
        line = phase4_timings(model, ds, dev, out, counts, k2_err, k1_err)
        bad = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
        require(not bad, f"imported modules the port must not use: {bad}")
        log(f"phase 4: done on {card}")
        print(json.dumps(line), flush=True)
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
