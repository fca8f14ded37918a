"""Train the edge-regret model.

The flags and defaults of gnngls_tpu/cli/train.py (reference scripts/train.py):
data_dir holds instances.npz, scalers.json, train.txt and val.txt; the run
writes params.json, metrics.jsonl and its checkpoints into
<tb_dir>/<timestamp>_<uuid>.  `--device` defaults to cuda; `--use_gpu` is
accepted for reference-CLI interop and changes nothing.

    python -m gnngls_tpu_torch.cli.train data/tsp100 runs
    python -m gnngls_tpu_torch.cli.train data/tsp10 runs --device cpu --n_epochs 2
"""

import argparse
import datetime
import pathlib
import uuid


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train model")
    parser.add_argument("data_dir", type=pathlib.Path, help="Where to load dataset")
    parser.add_argument("tb_dir", type=pathlib.Path, help="Where to log run data")
    parser.add_argument("--embed_dim", type=int, default=128)
    parser.add_argument("--n_layers", type=int, default=3)
    parser.add_argument("--n_heads", type=int, default=8)
    parser.add_argument("--lr_init", type=float, default=1e-3)
    parser.add_argument("--lr_decay", type=float, default=0.99)
    parser.add_argument("--min_delta", type=float, default=1e-4)
    parser.add_argument("--patience", type=int, default=20)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--n_epochs", type=int, default=100)
    parser.add_argument("--checkpoint_freq", type=int, default=None)
    parser.add_argument("--target", type=str, default="regret",
                        choices=["regret", "in_solution"])
    parser.add_argument("--use_gpu", action="store_true",
                        help="accepted for reference-CLI interop; a no-op")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--strict_val", action="store_true",
                        help="monitor the real val set instead of the "
                             "reference's val-on-train quirk (train.py:137)")
    parser.add_argument("--resume", type=pathlib.Path, default=None,
                        help="checkpoint .npz to resume from (restores model, "
                             "BN and optimizer state; continues the epoch "
                             "count and lr schedule)")
    args = parser.parse_args(argv)

    from ..core.scaler import load_scalers
    from ..data import dataset as ds
    from ..core.device import resolve_device
    from ..train import loop as tl

    device = resolve_device(args.device)
    scalers = load_scalers(args.data_dir / "scalers.json")
    train_set = ds.TSPDataset.from_npz(args.data_dir / "instances.npz",
                                       args.data_dir / "train.txt")
    train_set.scalers = scalers
    val_set = ds.TSPDataset.from_npz(args.data_dir / "instances.npz",
                                     args.data_dir / "val.txt")
    val_set.scalers = scalers

    cfg = tl.TrainConfig(
        embed_dim=args.embed_dim, n_layers=args.n_layers, n_heads=args.n_heads,
        lr_init=args.lr_init, lr_decay=args.lr_decay, min_delta=args.min_delta,
        patience=args.patience, batch_size=args.batch_size,
        n_epochs=args.n_epochs, checkpoint_freq=args.checkpoint_freq,
        target=args.target, seed=args.seed, val_on_train=not args.strict_val)

    timestamp = datetime.datetime.now().strftime("%b%d_%H-%M-%S")
    run_dir = args.tb_dir / f"{timestamp}_{uuid.uuid4().hex}"
    print(f"run dir: {run_dir}")
    tl.train_model(train_set, val_set, cfg, run_dir, resume_from=args.resume, device=device)
    print(f"done; checkpoints in {run_dir}")


if __name__ == "__main__":
    main()
