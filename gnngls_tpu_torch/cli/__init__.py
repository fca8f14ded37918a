"""Command-line entry point of the port:

  python -m gnngls_tpu_torch.cli.test <data_path> <model_path> <run_dir> <guides...>
        --n_iters N [--perturbation_moves --batch_size --device cuda|cpu --use_gpu]
"""
