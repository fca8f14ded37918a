"""Split a generated dataset and fit the train split's scalers.

The arguments, refusals and outputs of gnngls_tpu/cli/preprocess_dataset.py
(reference scripts/preprocess_dataset.py): a shuffled split carved train,
then test, then val; train.txt, val.txt and test.txt hold 0-based indices
into instances.npz; scalers.json holds min-max scalers fitted by partial_fit
over the train split; an existing scalers.json is refused.  Nothing here
runs on a device.

    python -m gnngls_tpu_torch.cli.preprocess_dataset data/new --n_train 24 --n_test 4 --n_val 4
"""

import argparse
import pathlib

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess a dataset.")
    parser.add_argument("dir", type=pathlib.Path)
    parser.add_argument("--n_train", type=int, default=100000)
    parser.add_argument("--n_test", type=int, default=1000)
    parser.add_argument("--n_val", type=int, default=10000)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

    if (args.dir / "scalers.json").is_file():
        raise SystemExit("scalers.json already exists.")

    from ..core.scaler import save_scalers
    from ..data import dataset as ds, generate as gen

    data = gen.load_dataset(args.dir / "instances.npz")
    n_total = data["coords"].shape[0]
    train, val, test = ds.split_dataset(n_total, args.n_train, args.n_test,
                                        args.n_val, seed=args.seed)
    for idx, name in ((train, "train.txt"), (val, "val.txt"), (test, "test.txt")):
        np.savetxt(args.dir / name, idx, fmt="%d")
        print(f"{name} contains {len(idx)} instances.")

    train_set = ds.TSPDataset.from_arrays(data, train)
    save_scalers(args.dir / "scalers.json", train_set.fit_scalers())
    print(f"wrote {args.dir / 'scalers.json'}")


if __name__ == "__main__":
    main()
