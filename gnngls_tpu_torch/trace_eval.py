"""Where the time of the tsp100 main path goes on the card.

    python -m gnngls_tpu_torch.trace_eval [--out DIR] [--n_iters 100]

Runs `evaluate.evaluate` once to warm up, then once more under
torch.profiler (CPU and CUDA activities) on the 500 data/tsp100 test
instances with the shipped checkpoint, and prints:
  * the wall time of each stage (inference, search) from evaluate's timings;
  * CUDA time by kernel name, largest first, with its share of the window;
  * the device's busy share of the profiled window (the union of kernel
    intervals over the wall time of the window), and so its idle share.
The Chrome trace goes to DIR/trace_eval.json.  Needs a CUDA device.
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
    ap.add_argument("--n_iters", type=int, default=100)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .data.dataset import TSPDataset
    from .evaluate import evaluate, resolve_device
    from .models.convert import load_model
    from .models.regret_gat import RegretGNNConfig

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    root = ROOT / "data" / "tsp100"
    ds = TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                             scalers_file=root / "scalers.json")
    model = load_model(ROOT / "models/tsp100/checkpoint_best_val.npz", RegretGNNConfig(),
                       device=dev)
    kw = dict(model=model, guides=["regret_pred"], n_iters=args.n_iters,
              perturbation_moves=20, batch_size=64, device=dev)
    evaluate(ds, **kw)  # warm-up: kernel build, cuBLAS handles, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = evaluate(ds, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
    args.out.mkdir(parents=True, exist_ok=True)
    trace = args.out / "trace_eval.json"
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
    print(f"evaluate wall {wall:.3f} s; stages {json.dumps(out['timings'])}")
    print(f"profiled window {(t_hi - t_lo) / 1e6:.3f} s; kernel time {total_kernel / 1e6:.3f} s; "
          f"device busy share {busy_share(kern, t_lo, t_hi):.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3:10.3f} ms  {us / max(total_kernel, 1e-9):7.2%}  {name[:110]}")
    print(f"trace -> {trace}")


if __name__ == "__main__":
    main()
