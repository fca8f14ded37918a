"""Command-line entry points of the port:

  python -m gnngls_tpu_torch.cli.test <data_path> <model_path> <run_dir> <guides...>
        [--n_iters N --time_limit S --perturbation_moves --batch_size --device cuda|cpu]
  python -m gnngls_tpu_torch.cli.train <data_dir> <tb_dir>
        [--embed_dim --n_heads --batch_size --n_epochs --resume --strict_val --device cuda|cpu]
  python -m gnngls_tpu_torch.cli.generate_instances <n_samples> <n_nodes> <dir>
        [--seed --solver --label_method --opt_iters --chunk --resume --device cuda|cpu]
  python -m gnngls_tpu_torch.cli.preprocess_dataset <dir>
        [--n_train --n_test --n_val --seed]
"""
