"""Generate a solved, regret-labelled dataset.

The arguments, refusals and outputs of gnngls_tpu/cli/generate_instances.py
(reference scripts/generate_instances.py): the output is one
`instances.npz` in `dir`; an existing `dir` is refused unless `--resume`
continues a killed run from its chunk shards under `<dir>/shards/` (either
package's).  Best-known tours come from `--solver` (default: Concorde on
PATH, Held-Karp for small n, else the GLS oracle); labels from the
warm-start forced-edge oracle on the whole-GLS kernel unless Held-Karp
solved the instances or LKH is on PATH.  `--device` defaults to cuda.

    python -m gnngls_tpu_torch.cli.generate_instances 32 100 data/new --opt_iters 100
    python -m gnngls_tpu_torch.cli.generate_instances 8 12 data/tiny --device cpu
"""

import argparse
import pathlib
import shutil


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate a dataset.")
    parser.add_argument("n_samples", type=int)
    parser.add_argument("n_nodes", type=int)
    parser.add_argument("dir", type=pathlib.Path)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--solver", type=str, default=None,
                        choices=[None, "held_karp", "gls", "concorde"])
    parser.add_argument("--label_method", type=str, default="auto",
                        choices=["auto", "held_karp", "gls", "lkh", "warm"])
    parser.add_argument("--opt_iters", type=int, default=100,
                        help="GLS budget for best-known tours (n > 22)")
    parser.add_argument("--chunk", type=int, default=250,
                        help="instances per resumable shard")
    parser.add_argument("--resume", action="store_true",
                        help="continue a killed run (dir may exist)")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    from ..data import generate as gen, labels as lb, solvers
    from ..core.device import resolve_device

    device = resolve_device(args.device)
    if args.dir.exists() and not args.resume:
        raise SystemExit(f"Output directory {args.dir} exists "
                         f"(pass --resume to continue a killed run).")
    args.dir.mkdir(parents=True, exist_ok=True)
    shards = args.dir / "shards"

    data = gen.generate_instances_sharded(
        shards, args.n_samples, args.n_nodes, seed=args.seed,
        solver=args.solver, opt_iters=args.opt_iters, chunk=args.chunk, device=device)

    method = args.label_method
    if method in ("auto", "warm") and str(data["solver"]) != "held_karp" \
            and not solvers.has_lkh():
        # heuristic best-known tours and warm labels: the shard-resumable path
        lb.warm_labels_chunked(data, shards, chunk=args.chunk, verbose=True, device=device)
    else:
        lb.compute_regret(data, method=method, verbose=True, device=device)
    gen.save_dataset(args.dir / "instances.npz", data)
    shutil.rmtree(shards, ignore_errors=True)
    print(f"wrote {args.n_samples} instances (n={args.n_nodes}, "
          f"solver={data['solver']}) to {args.dir / 'instances.npz'}")


if __name__ == "__main__":
    main()
