"""Run one cell of BENCHMARK.json once on the card and print its result.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run loads the program and its inputs,
warms up at the cell's own shapes (set-up, `setup_s`), sends requests in a
closed loop until `--seconds` have passed and the request in flight has
ended, and at least as many requests as the check needs (the window), checks what the window produced against the plain
reference, and prints one JSON line last on standard output:

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"],
     "card", "host", "sample", "checks"}

With --trace 0 the metrics are the cell's end-to-end metrics; with --trace 1
its per-layer metrics, read from a bounded slice of the window traced by
torch.profiler (see trace.py) and from the window's own spans, and `device`
adds busy_s and window_s of that slice; a traced run whose slice recorded no
step ends without a result.  "host" gives the window's CPU seconds of this
process and the seconds the hypervisor stole from the machine's cores in it,
"sample" what the check compared; "checks" names each compared number with
its value and limit, and the same lines end standard error.

Exits non-zero without a result when no CUDA device is present or fewer than
the cell asks for, when a request fails to run, or when JAX or the JAX
package is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import os  # noqa: E402

# One process with one intra-op CPU thread: the program's work is on the card
# and its host work single-threaded Python and NumPy, so idle OpenMP workers
# would only contend for the cores the launching thread runs on.
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Any, List, Optional  # noqa: E402

from portbench import manifest, roofline  # noqa: E402
from portbench.trace import Slice, Summary  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gnngls_tpu")


@dataclasses.dataclass
class Run:
    """What a reader sees."""

    cell: Any  # manifest.Cell
    setup_s: float
    window: tuple  # (start, end), host clock
    requests: List[Any]
    gaps: Any  # per-instance gaps (%) or None
    trace: Optional[Summary]
    peaks: dict
    model_flops: float  # the runner's model FLOPs an instance

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def instances(self) -> int:
        return sum(q.instances for q in self.requests)


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that are JAX or the JAX package, each
    compared whole (gnngls_tpu_torch is not gnngls_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def steal_s() -> float:
    """Seconds stolen by the hypervisor from all of the machine's cores so
    far (/proc/stat), or 0 where the system does not say."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        name, limit = (x.strip() for x in out[0].split(","))
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": "unknown", "power_limit": "unknown"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root: pathlib.Path = manifest.ROOT, device=None,
         t_start: float = T_START) -> int:
    """Run the cell; `device` other than None (tests on the CPU) skips the
    look for a card."""
    args = parse(argv)
    cell = manifest.load(args.workload, root)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / "build" / sub))  # caches stay in the checkout
    import torch

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            log(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), "
                f"found {have}; nothing measured")
            return 2
        device = "cuda"
    runner = manifest.load_file(root, "runners", cell.traffic["runner"]).Runner(
        root, cell, args.seed, device)
    runner.setup()
    if args.trace:
        Slice.prime()
    sl = Slice(**cell.trace["slice"]) if args.trace else None
    undo = runner.iteration_hook(sl.step) if sl and cell.trace["step"] == "iteration" else None
    requests = []
    least = int(getattr(runner, "min_requests", 1))
    cpu0, steal0 = time.process_time(), steal_s()
    t0 = time.time()
    setup_s = t0 - t_start
    if sl:
        sl.start()
    try:
        r = 0
        while True:
            requests.append(runner.request(r))
            r += 1
            if sl and cell.trace["step"] == "request":
                sl.step()
            if requests[-1].end - t0 >= args.seconds and len(requests) >= least:
                break
    except Exception:  # a request that fails ends the run without a result
        log(traceback.format_exc())
        log(f"portbench: request {len(requests)} failed; nothing measured")
        return 1
    finally:
        if sl:
            sl.stop()
        if undo:
            undo()
    window = (t0, requests[-1].end)
    host = {"cpu_s": time.process_time() - cpu0, "steal_s": steal_s() - steal0,
            "threads": torch.get_num_threads()}
    lat = sorted(q.end - q.start for q in requests)
    log(f"portbench: {len(requests)} requests in {window[1] - window[0]:.3f} s; latency "
        f"min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s")
    if sl and (sl.summary is None or not sl.summary.steps):
        log(f"portbench: the traced slice recorded no step (its steps are the cell's "
            f"{cell.trace['step']}s); nothing measured")
        return 4
    bad = forbidden_modules()
    if bad:
        log(f"portbench: loaded in this process after the window: {', '.join(bad)}")
        return 3
    peak = runner.memory_peak(requests)
    runner.release()
    failed = 0
    for q in requests:
        why = runner.malformed(q)
        if why:
            failed += 1
            log(f"portbench: malformed: {why}")
    checks = runner.check(requests)
    limits = cell.check["limits"]
    correct = failed == 0 and all(checks[k] <= limits[k] for k in limits)
    dev_name = torch.cuda.get_device_name() if device != "cpu" else "cpu"
    trace = sl.summary if sl else None
    run = Run(cell, setup_s, window, requests, runner.gaps(requests), trace,
              roofline.peaks(dev_name) if device != "cpu" else roofline.peaks("H100"),
              runner.model_flops_per_instance())
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": dev_name,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(requests), "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = trace.busy_s() if trace else 0.0
        dev["window_s"] = trace.window_s if trace else 0.0
        if trace:
            result["breakdown"] = {"device_ops": trace.device_ops(),
                                   "idle_gaps": trace.idle_gaps()}
    result["card"] = card() if device != "cpu" else {"name": "cpu", "power_limit": "none"}
    result["host"] = host
    result["sample"] = getattr(runner, "sample_info", {})
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    log(f"portbench: host {json.dumps(host)}; sample {json.dumps(result['sample'])}")
    for k, v in checks.items():
        log(f"check {k} {v!r} limit {limits[k]!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
