"""The port stands alone: no jax, no gnngls_tpu, CUDA by default.

* Importing every module of gnngls_tpu_torch, chip_smoke.py and the rank
  helper of tests/test_torch_dist.py (tests/torch_dist_ranks.py) leaves jax,
  gnngls_tpu, pandas, networkx and matplotlib out of sys.modules (checked in
  a fresh interpreter, against the modules present before the imports).
* Without a card the entry points raise unless device="cpu" is asked for:
  evaluation, the whole-GLS kernel's entry point, the trainer and its
  command line, and the model loaders.
* What still raises: only the kernel routes in train mode (they have no
  backward; ValueError naming the routes that train) and unknown `gat_impl`
  names.  Every GAT route runs in eval mode, every plain route trains (the
  bf16 routes `bf16` and `sep_fast` among them), and the evaluation modes and
  exact solvers ported since run.
* The API that gnngls_tpu's callers use: the port's top-level names are the
  JAX package's, and every keyword-only parameter of a public function of
  gnngls_tpu is accepted by the function at the same path in the port (read
  from both packages' sources), but for the structural differences named in
  STRUCTURAL; and the keywords that `evaluate` adds are those PORT_ONLY names.
"""

import ast
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
from gnngls_tpu_torch.models import convert as tconvert
from gnngls_tpu_torch.models import torch_import as ttorch_import
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


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
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
    # the model loaders: npz (either package's), a reference .pt, a state dict
    npz, cfg = ROOT / "models" / "tsp20" / "checkpoint_best_val.npz", RegretGNNConfig()
    model = tconvert.load_model(npz, cfg, device="cpu")
    sd = ttorch_import.state_dict_from_params(model)
    torch.save(sd, tmp_path / "m.pt")
    for load in (lambda **kw: tconvert.load_model(npz, cfg, **kw),
                 lambda **kw: ttorch_import.load_checkpoint(tmp_path / "m.pt", cfg, **kw)[0],
                 lambda **kw: ttorch_import.model_from_state_dict(sd, cfg, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load()
        assert all(t.device.type == "cpu" for t in load(device="cpu").state_dict().values())


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
        with pytest.raises(ValueError, match="'fast', 'naive', 'sep', 'chunked', 'bf16', "
                           "'sep_fast'"):
            model(x, gat_impl=impl)
    # the bf16 routes train (they raised NotImplementedError before the bf16 training
    # slice): the forward runs in train mode and the gradient reaches every parameter
    for impl in ("sep_fast", "bf16"):
        model.zero_grad()
        out = model(x, gat_impl=impl)
        assert out.shape == (2, 10, 1)
        out.square().mean().backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in model.parameters())
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


def _top_level_names(pkg: str) -> set:
    """The names a package's __init__.py imports or assigns."""
    names = set()
    for node in ast.parse((ROOT / pkg / "__init__.py").read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names - {"annotations"}


def test_top_level_names_are_the_jax_packages():
    import gnngls_tpu_torch
    from gnngls_tpu_torch import utils

    names = _top_level_names("gnngls_tpu")
    assert {"is_equivalent_tour", "tour_to_edge_vector", "__version__"} <= names
    assert _top_level_names("gnngls_tpu_torch") == names
    for name in names - {"__version__"}:
        assert getattr(gnngls_tpu_torch, name) is getattr(utils, name)


# Keyword-only parameters of gnngls_tpu that the port leaves out on purpose:
# (module path, function) -> {parameter: reason}.
STRUCTURAL = {
    ("evaluate.py", "evaluate"): dict.fromkeys(
        ("params", "bn_state", "model_cfg"),
        "the port's model is an nn.Module that holds its weights, statistics and config"),
    ("models/regret_gat.py", "forward_ring"): {
        "n_heads": "read from model.cfg"},
    ("models/regret_gat.py", "forward_tp"): {
        "n_heads": "read from model.cfg",
        "train": "the BatchNorm mode is the module's, set by model.train() / eval()"},
    ("train/checkpoint.py", "load_checkpoint"): dict.fromkeys(
        ("params_like", "bn_state_like", "opt_state_like"),
        "pytree templates: the port loads into an nn.Module and its optimizer"),
    ("train/checkpoint.py", "save_checkpoint"): dict.fromkeys(
        ("params", "bn_state", "opt_state"),
        "pytrees: the port saves an nn.Module and its optimizer"),
}

# Keyword-only parameters of the port that gnngls_tpu's function at the same
# path lacks, each named with its reason.
PORT_ONLY = {
    ("evaluate.py", "evaluate"): {
        "model": "the nn.Module in place of params, bn_state and model_cfg (STRUCTURAL)",
        "device": "the port runs on a card or, when asked, on the CPU",
        "seed": "the draws of DIFUSCO's denoising loop, the one model that samples"},
}


def _public_functions(path: pathlib.Path) -> dict:
    """name -> ast.arguments of each public top-level function and method."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = node.args
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.update({f"{node.name}.{f.name}": f.args for f in node.body
                        if isinstance(f, ast.FunctionDef) and not f.name.startswith("_")})
    return out


def test_port_accepts_every_jax_keyword():
    jax_root, port_root = ROOT / "gnngls_tpu", ROOT / "gnngls_tpu_torch"
    missing, compared = {}, 0
    for jpath in sorted(jax_root.rglob("*.py")):
        rel = jpath.relative_to(jax_root)
        if not (port_root / rel).exists():
            continue
        jax_fns, port_fns = _public_functions(jpath), _public_functions(port_root / rel)
        for name in sorted(set(jax_fns) & set(port_fns)):
            j, t = jax_fns[name], port_fns[name]
            if t.kwarg is not None:
                continue
            compared += 1
            accepted = {a.arg for a in t.args + t.kwonlyargs}
            allowed = STRUCTURAL.get((rel.as_posix(), name), {})
            lost = [a.arg for a in j.kwonlyargs
                    if a.arg not in accepted and a.arg not in allowed]
            if lost:
                missing[f"{rel.as_posix()}::{name}"] = lost
    assert compared >= 50
    assert not missing, missing
    for (rel, name), params in STRUCTURAL.items():  # the allowlist names real gaps only
        j = _public_functions(jax_root / rel)[name]
        t = _public_functions(port_root / rel)[name]
        assert set(params) <= {a.arg for a in j.kwonlyargs}
        assert not set(params) & {a.arg for a in t.args + t.kwonlyargs}


def test_port_only_keywords_are_named():
    for (rel, name), params in PORT_ONLY.items():
        j = _public_functions(ROOT / "gnngls_tpu" / rel)[name]
        t = _public_functions(ROOT / "gnngls_tpu_torch" / rel)[name]
        extra = ({a.arg for a in t.args + t.kwonlyargs}
                 - {a.arg for a in j.args + j.kwonlyargs})
        assert extra == set(params), (rel, name)
