"""The model holds full-f32 matmuls for its work and gives the caller's
precision setting back, on the CPU.

A caller at torch.set_float32_matmul_precision("high") runs a forward, the
evaluation's `predict_regret`, a train step and an eval step on a 2-layer,
16-wide model: inside each call (read by hooks in the embedding's forward
and in the train step's backward) the precision is "highest"; after each
call, one that raises inside the held span included, the setting reads
"high", and every output, gradient and updated weight is bit-equal to the
same calls made at "highest" (the default).  On the CPU both settings give
the same products, so the reads inside the span are what show the hold.  A
caller that mixed torch's legacy TF32 flag with the precision API, whose
precision torch refuses to read back, keeps its legacy flag.
"""

import copy
import pathlib

import numpy as np
import pytest
import torch

from gnngls_tpu_torch import evaluate as tev
from gnngls_tpu_torch.data.dataset import TSPDataset
from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig, exact_f32_matmuls, init_params
from gnngls_tpu_torch.train import step

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _highest_after():
    """Each test leaves the process at the default precision, one torch thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(prev)


def _dataset():
    root = ROOT / "data" / "tsp10"
    ds = TSPDataset.from_npz(root / "instances.npz", root / "train.txt",
                             scalers_file=root / "scalers.json")
    ds.coords, ds.features = ds.coords[:4], ds.features[:4]
    ds.regret, ds.in_solution, ds.opt_cost = ds.regret[:4], ds.in_solution[:4], ds.opt_cost[:4]
    return ds


def _model():
    return init_params(RegretGNNConfig(embed_dim=16, n_heads=2),
                       torch.Generator().manual_seed(11))


def _run_each(setting: str) -> list:
    """Every call of the model's work at the caller's `setting`, checking
    that the setting reads back after each; returns their results."""
    torch.set_float32_matmul_precision(setting)
    ds = _dataset()
    batch = ds.get_scaled_batch(np.arange(4))
    x, y = torch.as_tensor(batch["features"]), torch.as_tensor(batch["regret"])
    model = _model()
    out, inside = [], []

    def read(where):
        inside.append((where, torch.get_float32_matmul_precision()))

    model.embed.register_forward_hook(lambda *_: read("forward"))

    def after(result):
        assert torch.get_float32_matmul_precision() == setting
        out.append(result)

    with torch.no_grad():
        after(model(x, gat_impl="fast"))
    after(tev.predict_regret(model, ds, batch_size=3, device="cpu"))
    with pytest.raises(RuntimeError):  # inside the held span: the embedding's matmul
        model(torch.cat([x, x], dim=-1), gat_impl="fast")
    after(None)
    trained = copy.deepcopy(model)  # the embedding's hook comes along

    def on_backward(module, inputs, output):  # returns None: the output stays
        if output.requires_grad:
            output.register_hook(lambda grad: read("backward"))

    trained.decision.register_forward_hook(on_backward)
    opt = step.make_optimizer(trained)
    for _ in range(2):
        after(step.train_step(trained, opt, x, y, gat_impl="sep"))
        after([p.grad.clone() for p in trained.parameters()])
    after([t.clone() for t in trained.state_dict().values()])
    with pytest.raises(RuntimeError):  # inside the held span: the loss's broadcast
        step.train_step(trained, opt, x, y[:3], gat_impl="sep")
    after(step.eval_step(model, x, y, gat_impl="sep"))
    # forward, predict_regret's two batches, two train steps, the raising
    # step's forward, eval_step; the two train steps' backwards
    assert [w for w, _ in inside].count("forward") == 7
    assert [w for w, _ in inside].count("backward") == 2
    assert {p for _, p in inside} == {"highest"}, inside
    return out


def _bit_equal(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if isinstance(a, list):
        return len(a) == len(b) and all(_bit_equal(u, v) for u, v in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_model_work_restores_the_callers_precision_and_moves_no_bit():
    highest = _run_each("highest")
    high = _run_each("high")
    assert len(high) == len(highest) == 9
    for i, (a, b) in enumerate(zip(high, highest)):
        assert _bit_equal(a, b), f"call {i} differs between 'high' and 'highest'"


def test_the_manager_restores_on_an_exception_and_nests():
    torch.set_float32_matmul_precision("medium")
    with pytest.raises(KeyError):
        with exact_f32_matmuls():
            assert torch.get_float32_matmul_precision() == "highest"
            with exact_f32_matmuls():
                assert torch.get_float32_matmul_precision() == "highest"
            assert torch.get_float32_matmul_precision() == "highest"
            raise KeyError("inside")
    assert torch.get_float32_matmul_precision() == "medium"


def test_a_caller_that_mixed_the_legacy_flag_keeps_it():
    """After the precision API, torch's legacy flag leaves a state whose
    precision torch will not read back; the model holds the legacy flag."""
    x = torch.rand((2, 45, 1), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = _model()(x, gat_impl="fast")
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = False
        with pytest.raises(RuntimeError, match="legacy"):
            torch.get_float32_matmul_precision()
        got = _model()(x, gat_impl="fast")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(RuntimeError, match="legacy"):  # the caller's state, as it was
        torch.get_float32_matmul_precision()
    assert torch.equal(got, want)
