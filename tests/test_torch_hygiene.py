"""The port stands alone: no jax, no gnngls_tpu, CUDA by default.

* Importing every module of gnngls_tpu_torch, chip_smoke.py and the rank
  helper of tests/test_torch_dist.py (tests/torch_dist_ranks.py) leaves jax,
  gnngls_tpu, pandas, networkx and matplotlib out of sys.modules (checked in
  a fresh interpreter, against the modules present before the imports).
* Without a card the entry points raise unless device="cpu" is asked for.
* What still raises NotImplementedError: training through the bf16 routes
  (`bf16`, `sep_fast`), whose gradients cannot be held to JAX's.  Every GAT
  route runs in eval mode, train mode runs on the plain f32 routes (`chunked`
  among them), the kernel routes, which have no backward, refuse it, and the
  evaluation modes and exact solvers ported since run.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.data import generate as tgen
from gnngls_tpu_torch.data import native_oracle as tnative
from gnngls_tpu_torch.cli import train as tcli_train
from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig, gat_conv_for
from gnngls_tpu_torch.search import batched as tbatched
from gnngls_tpu_torch.train import loop as tloop

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

_PROBE = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import chip_smoke, gnngls_tpu_torch, torch_dist_ranks
for m in pkgutil.walk_packages(gnngls_tpu_torch.__path__, "gnngls_tpu_torch."):
    importlib.import_module(m.name)
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in
             ("jax", "jaxlib", "gnngls_tpu", "pandas", "networkx", "matplotlib"))
print("BAD", bad)
print("COUNT", sum(m.startswith("gnngls_tpu_torch") for m in new))
"""


def test_port_imports_no_jax_and_no_reference_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT),
                                                               tests=str(ROOT / "tests"))],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    count = int(proc.stdout.split("COUNT")[1])
    assert count >= 35


def _tiny():
    root = ROOT / "data" / "tsp10"
    ds = tds.TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                                 scalers_file=root / "scalers.json")
    ds.coords = ds.coords[:2]
    ds.opt_cost = ds.opt_cost[:2]
    return ds


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.evaluate(_tiny(), guides=["weight"], n_iters=1)
    with pytest.raises(RuntimeError):
        tev.resolve_device("cuda")
    out = tev.evaluate(_tiny(), guides=["weight"], n_iters=1, device="cpu")
    assert out["device"] == "cpu" and np.isfinite(out["mean_gap"])
    # the whole-GLS kernel's entry point, the trainer and its command line
    D = np.ones((1, 5, 5), np.float32)
    tour = np.array([[0, 1, 2, 3, 4, 0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatched.run_fixed_kernel(D, D[:, None], tour, n_iters=1)
    res = tbatched.run_fixed_kernel(D, D[:, None], tour, n_iters=1, device="cpu")
    assert res.best_tours.shape == (1, 6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.train_model(_tiny(), _tiny(), tloop.TrainConfig(), ROOT / "missing_run_dir")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli_train.main([str(ROOT / "data" / "tsp10"), str(ROOT / "missing_run_dir")])
    assert not (ROOT / "missing_run_dir").exists()


def test_unported_modes_raise():
    # the chunked and bf16 routes are ported (they raised before the last slice)
    model = RegretGNN(RegretGNNConfig(embed_dim=8, n_heads=2)).eval()
    x = torch.rand((2, 10, 1))
    for impl in ("chunked", "bf16"):
        assert callable(gat_conv_for(impl))
        assert model(x, gat_impl=impl).shape == (2, 10, 1)
    # train mode runs (it raised before the training slice) on the plain routes;
    # the kernel routes have no backward and refuse it, naming the routes that train
    model.train()
    for impl in ("fast", "naive", "sep", "chunked"):
        assert model(x, gat_impl=impl).shape == (2, 10, 1)
    for impl in ("auto", "pallas", "pallas_mxu", "pallas_sep", "pallas_sep_fast"):
        with pytest.raises(ValueError, match="'fast', 'naive', 'sep', 'chunked'"):
            model(x, gat_impl=impl)
    # still refused: training through the bf16 routes (ROADMAP §3)
    for impl in ("sep_fast", "bf16"):
        with pytest.raises(NotImplementedError):
            model(x, gat_impl=impl)
    # the exact solvers are ported (they raised before the data-generation slice):
    # gnngls_tpu's rule, Held-Karp up to n=16 (22 with the native oracle), else GLS
    for solver in ("held_karp", "concorde"):
        assert tgen.resolve_solver(30, solver) == solver
    assert tgen.resolve_solver(16) == "held_karp" and tgen.resolve_solver(23) == "gls"
    assert tgen.resolve_solver(22) == ("held_karp" if tnative.available() else "gls")
    with pytest.raises(ValueError):
        tev.evaluate(_tiny(), guides=["regret_pred"], n_iters=1, device="cpu")
    # ported: a wall-clock budget, first-improvement, the reference's own inputs
    out = tev.evaluate(_tiny(), guides=["weight"], time_limit=0.05, device="cpu")
    assert out["engine"] == "xla" and len(out["result"].chunk_times) >= 2
    out = tev.evaluate(_tiny(), guides=["weight"], n_iters=1, first_improvement=True,
                       device="cpu")
    assert out["engine"] == "xla" and np.isfinite(out["mean_gap"])
    with pytest.raises(FileNotFoundError):  # a reader now, not a NotImplementedError
        tds.TSPDataset.from_reference_dir(ROOT / "data" / "tsp10" / "missing.txt")


def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path):
    """No result line without a card, nor from a directory holding only the script."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              timeout=120, cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
