"""Where the time of the port's evaluation and training paths goes on the card.

    python -m gnngls_tpu_torch.trace_eval [--out DIR] [--n_iters N] [--tsp500]
                                          [--gat_impl NAME] [--time_limit S]
                                          [--train STEPS]

Default: the tsp100 main path.  Runs `evaluate.evaluate` once to warm up,
then once more under torch.profiler (CPU and CUDA activities) on the 500
data/tsp100 test instances with the shipped checkpoint (n_iters 100).

--time_limit S: the same with the reference's default budget in place of
n_iters: S seconds of wall clock on the per-move engine (keep S small: the
engine launches thousands of small kernels an iteration, and the trace
grows with them).

--tsp500: the large-n path (benchmarks/tsp500_e2e.py's steps through the
port).  After a small warm-up at n=500, profiles `generate_instances(128,
500, seed=3, solver="gls", opt_iters=100)` (the GLS oracle) and then
`evaluate` of the tsp100 checkpoint on those instances (guide regret_pred,
n_iters 40, perturbation_moves 20, batch 16).

--gat_impl NAME (e.g. pallas_mxu, pallas_sep_fast): in place of `evaluate`,
`predict_regret(..., gat_impl=NAME)` at the same batch size, then the search
as benchmarks/tsp500_e2e.py runs it on those predictions (nearest neighbour
on the regret matrix, the whole-GLS kernel with it as the only guide, the
same n_iters and perturbation_moves).

--train STEPS: the training path in place of evaluation.  The shipped
checkpoint with its Adam state (train/checkpoint.restore_checkpoint) at its
params.json settings (batch 32, gat_impl "fast"); two train steps on
data/tsp100 train instances warm up, then STEPS more are profiled.

Prints:
  * the wall time of each stage (oracle, inference, search) and the peak
    device memory from evaluate's timings;
  * CUDA time by kernel name, largest first, with its share of kernel time;
  * the device's busy share of the profiled window (the union of kernel
    intervals over the wall time of the window), and so its idle share;
  * the count of kernel launches, and with --time_limit the chunks (outer
    iterations) the search ran.
The Chrome trace goes to DIR/trace_eval.json (DIR/trace_tsp500.json with
--tsp500; the route's name appended with --gat_impl, as in
trace_eval_pallas_mxu.json; trace_eval_wall.json with --time_limit;
trace_train.json with --train).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def busy_share(events, t0_us: float, t1_us: float) -> float:
    """Union of [start, end) device intervals over the window's length."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / max(t1_us - t0_us, 1e-9)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=ROOT / "build" / "trace_eval")
    ap.add_argument("--n_iters", type=int, default=None,
                    help="search budget (default 100, or 40 with --tsp500)")
    ap.add_argument("--tsp500", action="store_true",
                    help="profile the tsp500 path: oracle, then evaluate at n=500")
    ap.add_argument("--gat_impl", default=None,
                    help="predict through this GATConv route, then search on the predictions")
    ap.add_argument("--time_limit", type=float, default=None,
                    help="tsp100: search S seconds of wall clock on the per-move engine")
    ap.add_argument("--train", type=int, default=None, metavar="STEPS",
                    help="profile STEPS train steps resumed from the shipped checkpoint")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .core.scaler import load_scalers
    from .data.dataset import TSPDataset
    from .data.generate import generate_instances
    from .evaluate import evaluate, predict_regret, resolve_device, search_on_predictions
    from .models.convert import load_model
    from .models.regret_gat import RegretGNNConfig

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    model = load_model(ROOT / "models/tsp100/checkpoint_best_val.npz", RegretGNNConfig(),
                       device=dev)
    scalers = load_scalers(ROOT / "models/tsp100/scalers.json")

    def tsp500(n_inst, opt_iters):
        data = generate_instances(n_inst, 500, seed=3, solver="gls", opt_iters=opt_iters,
                                  device=dev)
        data["regret"] = np.zeros_like(data["in_solution"], dtype=np.float32)
        return TSPDataset.from_arrays(data, scalers=scalers)

    def run(ds, n_iters):
        """evaluate, or with --gat_impl its steps through that route."""
        if args.gat_impl is None:
            return evaluate(ds, **{**kw, "n_iters": n_iters})
        t0 = time.time()
        preds = predict_regret(model, ds, batch_size=kw["batch_size"], device=dev,
                               gat_impl=args.gat_impl)
        t1 = time.time()
        _, search_s = search_on_predictions(preds, ds.coords, n_iters=n_iters,
                                            perturbation_moves=kw["perturbation_moves"],
                                            device=dev)
        return {"timings": {"inference_s": t1 - t0, "search_s": search_s,
                            "total_s": time.time() - t0}}

    if args.train is not None:
        from .train.checkpoint import restore_checkpoint
        from .train.step import make_optimizer, train_step

        root = ROOT / "data" / "tsp100"
        train_set = TSPDataset.from_npz(root / "instances.npz", root / "train.txt",
                                        scalers_file=root / "scalers.json")
        bs = json.loads((ROOT / "models/tsp100/params.json").read_text())["batch_size"]
        opt = make_optimizer(model)
        restore_checkpoint(ROOT / "models/tsp100/checkpoint_best_val.npz", model, opt)

        def run(ds, steps):
            """`steps` train steps on consecutive batches of the train split."""
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            for i in range(steps):
                batch = ds.get_scaled_batch(np.arange(i * bs, (i + 1) * bs) % len(ds))
                float(train_step(model, opt, torch.as_tensor(batch["features"], device=dev),
                                 torch.as_tensor(batch["regret"], device=dev)))
            t = time.time() - t0
            return {"timings": {"train_s": t, "steps_per_s": steps / t,
                                "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}}

        ds, kw = train_set, {"n_iters": args.train}
        run(ds, 2)  # warm-up: cuBLAS handles, allocator
    elif args.tsp500:
        kw = dict(model=model, guides=["regret_pred"], n_iters=args.n_iters or 40,
                  perturbation_moves=20, batch_size=16, device=dev)
        run(tsp500(2, 1), 1)  # warm-up at n=500
    else:
        root = ROOT / "data" / "tsp100"
        ds = TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                                 scalers_file=root / "scalers.json")
        kw = dict(model=model, guides=["regret_pred"], n_iters=args.n_iters or 100,
                  perturbation_moves=20, batch_size=64, device=dev)
        if args.time_limit is not None:
            kw.update(n_iters=None, time_limit=args.time_limit)
        run(ds, kw["n_iters"])  # warm-up: kernel build, cuBLAS handles, allocator
    torch.cuda.synchronize()
    stages = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        if args.tsp500:
            ds = tsp500(128, 100)
            torch.cuda.synchronize()
            stages["oracle_and_dataset_s"] = time.time() - t0
        out = run(ds, kw["n_iters"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    stages.update(out["timings"])
    args.out.mkdir(parents=True, exist_ok=True)
    stem = ("trace_train" if args.train is not None
            else "trace_tsp500" if args.tsp500 else "trace_eval")
    suffix = (f"_{args.gat_impl}" if args.gat_impl
              else "_wall" if args.time_limit is not None else "")
    trace = args.out / f"{stem}{suffix}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    window = [e for e in events if e.get("ph") == "X" and "dur" in e]
    t_lo = min(e["ts"] for e in window)
    t_hi = max(e["ts"] + e["dur"] for e in window)
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    total_kernel = sum(by_name.values())
    print(f"card: {card}")
    print(f"profiled wall {wall:.3f} s; stages {json.dumps(stages)}")
    print(f"profiled window {(t_hi - t_lo) / 1e6:.3f} s; kernel time {total_kernel / 1e6:.3f} s; "
          f"device busy share {busy_share(kern, t_lo, t_hi):.4f}; {len(kern)} kernel launches")
    if "result" in out:
        print(f"search: engine {out['engine']}, {len(out['result'].chunk_times) - 1} chunks, "
              f"{int(out['moves'].sum())} accepted moves")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3:10.3f} ms  {us / max(total_kernel, 1e-9):7.2%}  {name[:110]}")
    print(f"trace -> {trace}")


if __name__ == "__main__":
    main()
