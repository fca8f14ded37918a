"""Evaluate a model: regret inference + guided local search + gap report.

The flags of gnngls_tpu/cli/test.py (reference scripts/test.py).  data_path is
a split file next to instances.npz and scalers.json; model_path a gnngls_tpu
npz checkpoint with params.json beside it.  `--device` defaults to cuda;
`--use_gpu` is accepted for reference-CLI interop and changes nothing.
Wall-clock budgets (`--time_limit` without `--n_iters`), `--protocol_10s`,
reference gpickle datasets and `.pt` checkpoints wait for later slices and
raise NotImplementedError.
"""

import argparse
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
                        help="fixed outer-iteration budget (required for now)")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--use_gpu", action="store_true",
                        help="accepted for reference-CLI interop; a no-op")
    parser.add_argument("--protocol_10s", action="store_true",
                        help="not ported yet: raises NotImplementedError")
    args = parser.parse_args(argv)

    import numpy as np

    from .. import evaluate as ev
    from ..data import dataset as ds
    from ..models.convert import load_model
    from ..models.regret_gat import RegretGNNConfig

    if args.protocol_10s:
        raise NotImplementedError("--protocol_10s (calibrate_protocol_iters) "
                                  "waits for a later slice of the port")
    root = args.data_path.parent
    if not (root / "instances.npz").exists():
        test_set = ds.TSPDataset.from_reference_dir(args.data_path)
    else:
        test_set = ds.TSPDataset.from_npz(root / "instances.npz", args.data_path,
                                          scalers_file=root / "scalers.json")

    model = None
    if "regret_pred" in args.guides:
        if args.model_path.suffix == ".pt":
            raise NotImplementedError(".pt checkpoint import waits for the "
                                      "reference-API slice of the port")
        pj = json.load(open(args.model_path.parent / "params.json"))
        if "efeat_drop_idx" in pj:
            test_set.feat_drop_idx = list(pj["efeat_drop_idx"])
        cfg = RegretGNNConfig(
            in_dim=test_set.feat_dim, embed_dim=pj["embed_dim"], out_dim=1,
            n_layers=pj["n_layers"], n_heads=pj["n_heads"],
            depth_from_heads=pj.get("depth_from_heads", True))
        model = load_model(args.model_path, cfg)

    out = ev.evaluate(
        test_set, model=model, guides=args.guides, time_limit=args.time_limit,
        n_iters=args.n_iters, perturbation_moves=args.perturbation_moves,
        batch_size=args.batch_size, device=args.device)

    print(f"instances: {len(test_set)}  mean gap: {out['mean_gap']:.4f}%  "
          f"median: {float(np.median(out['gaps'])):.4f}%  "
          f"max: {float(out['gaps'].max()):.4f}%")
    rows = ev.search_progress_records(test_set, out)
    path = ev.write_run_dataframe(rows, args.run_dir)
    print(f"search progress -> {path}")


if __name__ == "__main__":
    main()
