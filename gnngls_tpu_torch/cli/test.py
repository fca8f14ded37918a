"""Evaluate a model: regret inference + guided local search + gap report.

The flags of gnngls_tpu/cli/test.py (reference scripts/test.py).  data_path
is a split file next to instances.npz and scalers.json (or scalers.pkl), or
a reference listing of gpickles; model_path a gnngls_tpu npz checkpoint or a
reference .pt checkpoint, with params.json beside it.  A params.json with
"arch": "gated_gcn" names the residual gated GCN instead, its widths under
`GatedGCNConfig`'s names, and model_path an npz of its state-dict arrays
(`models.gated_gcn.load_model`); without "arch" it is the GAT.  The default
budget is the reference's: 10 s of wall clock (`--time_limit`), here for the whole
batch at once; `--n_iters` fixes the outer iterations instead, and
`--protocol_10s` calibrates them to the reference's 10 s move counts.
`--device` defaults to cuda; `--use_gpu` is accepted for reference-CLI
interop and changes nothing.

    python -m gnngls_tpu_torch.cli.test data/tsp100/test.txt \
        models/tsp100/checkpoint_best_val.npz runs regret_pred
"""

import argparse
import dataclasses
import json
import pathlib


def main(argv=None):
    parser = argparse.ArgumentParser(description="Test model")
    parser.add_argument("data_path", type=pathlib.Path)
    parser.add_argument("model_path", type=pathlib.Path)
    parser.add_argument("run_dir", type=pathlib.Path)
    parser.add_argument("guides", type=str, nargs="+")
    parser.add_argument("--time_limit", type=float, default=10.0)
    parser.add_argument("--perturbation_moves", type=int, default=20)
    parser.add_argument("--n_iters", type=int, default=None,
                        help="fixed outer-iteration budget instead of wall clock")
    parser.add_argument("--engine", type=str, default="auto",
                        choices=("auto", "xla", "pallas"),
                        help="search engine: pallas = the whole-GLS kernel (needs "
                             "--n_iters), xla = the per-move engine")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--use_gpu", action="store_true",
                        help="accepted for reference-CLI interop; a no-op")
    parser.add_argument("--protocol_10s", action="store_true",
                        help="replace --time_limit/--n_iters with the fixed budget "
                             "calibrated to the reference's 10 s/instance move counts "
                             "(evaluate.calibrate_protocol_iters)")
    args = parser.parse_args(argv)

    import numpy as np

    from .. import evaluate as ev
    from ..data import dataset as ds
    from ..models import gated_gcn
    from ..models.convert import load_model
    from ..models.regret_gat import RegretGNNConfig

    root = args.data_path.parent
    if (root / "instances.npz").exists():
        scalers_file = (root / "scalers.json" if (root / "scalers.json").exists()
                        else root / "scalers.pkl")
        test_set = ds.TSPDataset.from_npz(root / "instances.npz", args.data_path,
                                          scalers_file=scalers_file)
    else:
        test_set = ds.TSPDataset.from_reference_dir(args.data_path)

    model = None
    if "regret_pred" in args.guides:
        pj = json.load(open(args.model_path.parent / "params.json"))
        arch = pj.get("arch", "regret_gat")
        if arch == "gated_gcn":
            names = {f.name for f in dataclasses.fields(gated_gcn.GatedGCNConfig)}
            cfg = gated_gcn.GatedGCNConfig(**{k: v for k, v in pj.items() if k in names})
            model = gated_gcn.load_model(args.model_path, cfg, device=args.device)
        elif arch == "regret_gat":
            if "efeat_drop_idx" in pj:
                test_set.feat_drop_idx = list(pj["efeat_drop_idx"])
            cfg = RegretGNNConfig(
                in_dim=test_set.feat_dim, embed_dim=pj["embed_dim"], out_dim=1,
                n_layers=pj["n_layers"], n_heads=pj["n_heads"],
                depth_from_heads=pj.get("depth_from_heads", True))
            if args.model_path.suffix == ".pt":
                from ..models import torch_import

                model, _ = torch_import.load_checkpoint(args.model_path, cfg,
                                                          device=args.device)
            else:
                model = load_model(args.model_path, cfg, device=args.device)
        else:
            raise SystemExit(f"unknown arch {arch!r} in {args.model_path.parent / 'params.json'}")

    n_iters = args.n_iters
    if args.protocol_10s:
        n = test_set.n_nodes
        if n not in ev.REFERENCE_10S_MOVES:
            raise SystemExit(f"no measured 10s-protocol move target for n={n} "
                             f"(have {sorted(ev.REFERENCE_10S_MOVES)})")
        # Pinned to the weight guide: the targets were measured weight-guided,
        # and one anchor keeps the budgets of all guides equal.
        n_iters = ev.calibrate_protocol_iters(
            test_set, target_moves=ev.REFERENCE_10S_MOVES[n], guides=["weight"],
            device=args.device)
        print(f"10s-protocol calibrated budget: n_iters={n_iters} "
              f"(weight-guided anchor, {ev.REFERENCE_10S_MOVES[n]:.0f} target moves)")

    out = ev.evaluate(
        test_set, model=model, guides=args.guides, time_limit=args.time_limit,
        n_iters=n_iters, perturbation_moves=args.perturbation_moves,
        batch_size=args.batch_size, engine=args.engine, device=args.device)

    print(f"instances: {len(test_set)}  mean gap: {out['mean_gap']:.4f}%  "
          f"median: {float(np.median(out['gaps'])):.4f}%  "
          f"max: {float(out['gaps'].max()):.4f}%")
    if out["trace_mode"] == "per-iteration":
        print("note: the pallas engine traces at outer-iteration granularity (one "
              "best-cost snapshot per iteration); use --engine xla for per-move traces")
    rows = ev.search_progress_records(test_set, out)
    path = ev.write_run_dataframe(rows, args.run_dir)
    print(f"search progress -> {path}")


if __name__ == "__main__":
    main()
