"""The port's training loop, checkpoints and CLI against gnngls_tpu, on the CPU.

* The npz checkpoint both ways: the port reads the shipped tsp100 file (its
  316 keys, Adam at count 1638 and lr 1e-3 * 0.99**25) into a model and an
  optimizer and writes it back key for key and bit for bit; a file written
  by either package after an epoch on data/tsp10 restores in the other
  (JAX's `load_checkpoint` into its own templates), with count, mu and nu
  carried, and both packages resume from it to the same next epoch.
* `train_model` on data/tsp10 (40 train instances, embed 16, 2 heads,
  batch 8) through both packages from one start: JAX writes its
  `init_params` and `optimizer.init` as a checkpoint at epoch -1 and both
  resume from it.  Per-epoch train loss within 1e-4 relative, the same
  best-val epoch, final parameters and running statistics within 1e-3 of
  each leaf's largest value; with val_on_train, with the val set, and in
  bouts of max_epochs_per_call.  A leaf whose gradient is rounding noise
  (each ffn2.b; here also embed.b) is walked by Adam by up to lr a step
  on a sign each package draws on its own, and the running means after it
  follow: those are held within 0.05.  The monitored loss is an eval pass
  on the running statistics, which that walk moves: it is held within 5e-2
  relative.  gnngls_tpu differs
  from itself as much: its `fast` and `naive` routes, from this start,
  give train losses within 4e-7 and val losses up to 2.3% apart.
* `cli/train.py --device cpu` writes params.json, metrics.jsonl and its
  checkpoints, and the port's `cli/test.py` evaluates that checkpoint.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from gnngls_tpu.core.scaler import load_scalers as jload_scalers
from gnngls_tpu.data import dataset as jds
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu.train import loop as jloop
from gnngls_tpu.train import step as jstep
from gnngls_tpu_torch.cli import test as tcli_test
from gnngls_tpu_torch.cli import train as tcli_train
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.models import regret_gat as TM
from gnngls_tpu_torch.train import checkpoint as tck
from gnngls_tpu_torch.train import loop as tloop
from gnngls_tpu_torch.train import step as tstep

ROOT = pathlib.Path(__file__).resolve().parent.parent
TSP10 = ROOT / "data" / "tsp10"
SHIPPED = ROOT / "models" / "tsp100" / "checkpoint_best_val.npz"
LOSS_RTOL = 1e-4  # per-epoch train losses of the two packages, relative
VAL_RTOL = 5e-2  # per-epoch monitored (eval-mode) losses, relative
PARAM_TOL = 1e-3  # final parameters, of each leaf's largest value
# Leaves whose gradient is rounding noise, which Adam walks by up to lr a step, and
# the running means that follow them: each ffn2.b, whose shift bn2 removes, and,
# with one-feature inputs, embed.b, whose shift layer 0's bn1 nearly removes.
DRIFTING = ("ffn2/b", "bn2/mean", "embed/b", "layers/0/bn1/mean")
DRIFT_BAR = 0.05  # those leaves after 20 steps of lr 1e-3 (measured: up to 0.0195)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def datasets(split):
    j = jds.TSPDataset.from_npz(TSP10 / "instances.npz", TSP10 / f"{split}.txt")
    j.scalers = jload_scalers(TSP10 / "scalers.json")
    t = tds.TSPDataset.from_npz(TSP10 / "instances.npz", TSP10 / f"{split}.txt",
                                scalers_file=TSP10 / "scalers.json")
    return j, t


def small_cfg(**kw):
    base = dict(embed_dim=16, n_heads=2, batch_size=8, n_epochs=4)
    base.update(kw)
    return jloop.TrainConfig(**base), tloop.TrainConfig(**base)


def jax_start(path, cfg):
    """JAX's init_params and optimizer.init for cfg, saved at epoch -1."""
    mcfg = JM.RegretGNNConfig(embed_dim=cfg.embed_dim, n_heads=cfg.n_heads)
    params, bn = JM.init_params(jax.random.PRNGKey(cfg.seed), mcfg)
    jck.save_checkpoint(path, params=params, bn_state=bn,
                        opt_state=jstep.make_optimizer().init(params), epoch=-1)
    return path


def blobs(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def meta(path):
    return json.loads(bytes(blobs(path)["__meta__"].tobytes()).decode())


def assert_histories_match(got, want):
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    for a, b in zip(got, want):
        for key, tol in (("loss", LOSS_RTOL), ("val_loss", VAL_RTOL)):
            assert abs(a[key] - b[key]) <= tol * abs(b[key]), (key, a, b)
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-12)


def assert_params_match(got_path, want_path):
    a, b = blobs(got_path), blobs(want_path)
    for key in b:
        if key.startswith(("params::", "bn_state::")):
            err = float(np.abs(a[key] - b[key]).max())
            bar = DRIFT_BAR if key.endswith(DRIFTING) else PARAM_TOL * np.abs(b[key]).max()
            assert err <= bar, f"{key}: {err:.3e} > {bar:.3e}"


def test_shipped_checkpoint_round_trips_through_the_port(tmp_path):
    model = TM.RegretGNN(TM.RegretGNNConfig())
    opt = tstep.make_optimizer(model)
    got_meta = tck.restore_checkpoint(SHIPPED, model, opt)
    assert got_meta == meta(SHIPPED) and got_meta["epoch"] == 25
    steps = {int(st["step"]) for st in opt.state.values()}
    assert steps == {1638} and len(opt.state) == 11 * 8 + 4
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.99 ** 25, rel=1e-6)
    out = tmp_path / "again.npz"
    tck.save_checkpoint(out, model, opt, **{k: got_meta[k] for k in ("epoch", "loss", "val_loss")})
    want, got = blobs(SHIPPED), blobs(out)
    assert list(got) == list(want) and len(got) == 316
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # JAX restores the port's file into its own templates
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0), JM.RegretGNNConfig())
    o_like = jstep.make_optimizer().init(p_like)
    params, bn, ost, jmeta = jck.load_checkpoint(out, params_like=p_like, bn_state_like=s_like,
                                                 opt_state_like=o_like)
    assert int(ost.count) == int(ost.inner_state[0].count) == 1638 and jmeta == got_meta
    np.testing.assert_array_equal(np.asarray(ost.inner_state[0].nu.layers[7].ffn1.w),
                                  opt.state[model.layers[7].ffn1.w]["exp_avg_sq"].numpy())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_from_either_package_resumes_in_both(tmp_path, writer):
    (jtrain, ttrain), (jval, tval) = datasets("train"), datasets("val")
    jcfg, tcfg = small_cfg(n_epochs=1)
    start = jax_start(tmp_path / "start.npz", jcfg)
    if writer == "port":
        tloop.train_model(ttrain, tval, tcfg, tmp_path / "w", resume_from=start, device="cpu",
                          verbose=False)
    else:
        jloop.train_model(jtrain, jval, jcfg, tmp_path / "w", resume_from=start, verbose=False)
    written = tmp_path / "w" / "checkpoint_final.npz"
    assert meta(written)["epoch"] == 0 and int(blobs(written)["opt_state::count"]) == 5
    # each package restores the file with Adam's state carried
    model = TM.RegretGNN(TM.RegretGNNConfig(embed_dim=16, n_heads=2))
    opt = tstep.make_optimizer(model)
    tck.restore_checkpoint(written, model, opt)
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0),
                                    JM.RegretGNNConfig(embed_dim=16, n_heads=2))
    _, _, ost, _ = jck.load_checkpoint(written, params_like=p_like, bn_state_like=s_like,
                                       opt_state_like=jstep.make_optimizer().init(p_like))
    assert {int(st["step"]) for st in opt.state.values()} == {int(ost.count)} == {5}
    np.testing.assert_array_equal(opt.state[model.decision.w]["exp_avg"].numpy(),
                                  np.asarray(ost.inner_state[0].mu.decision.w))
    # and both resume from it to the same epoch 1
    jcfg, tcfg = small_cfg(n_epochs=2)
    _, _, jh = jloop.train_model(jtrain, jval, jcfg, tmp_path / "j", resume_from=written,
                                 verbose=False)
    _, th = tloop.train_model(ttrain, tval, tcfg, tmp_path / "t", resume_from=written,
                              device="cpu", verbose=False)
    assert [r["epoch"] for r in th] == [1]
    assert th[0]["lr"] == pytest.approx(1e-3 * 0.99, rel=1e-12)
    assert_histories_match(th, jh)
    assert_params_match(tmp_path / "t" / "checkpoint_final.npz",
                        tmp_path / "j" / "checkpoint_final.npz")


@pytest.mark.parametrize("mode", ["val_on_train", "val_set", "bouts"])
def test_train_model_matches_jax(tmp_path, mode):
    (jtrain, ttrain), (jval, tval) = datasets("train"), datasets("val")
    kw = {"val_on_train": mode == "val_on_train"}
    if mode == "bouts":
        kw["max_epochs_per_call"] = 2
    jcfg, tcfg = small_cfg(**kw)
    start = jax_start(tmp_path / "start.npz", jcfg)
    runs = {}
    for name, train_model, sets, cfg in (("jax", jloop.train_model, (jtrain, jval), jcfg),
                                         ("port", tloop.train_model, (ttrain, tval), tcfg)):
        extra = {"device": "cpu"} if name == "port" else {}
        run = tmp_path / name
        history = train_model(*sets, cfg, run, resume_from=start, verbose=False, **extra)[-1]
        if mode == "bouts":  # the first bout ends after epoch 1 without a final checkpoint
            assert [r["epoch"] for r in history] == [0, 1]
            assert not (run / "checkpoint_final.npz").exists()
            history += train_model(*sets, cfg, run, resume_from=run / "checkpoint_1.npz",
                                   verbose=False, **extra)[-1]
        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        assert [r["epoch"] for r in rows] == [r["epoch"] for r in history] == [0, 1, 2, 3]
        assert json.loads((run / "params.json").read_text()) == cfg.to_params_json()
        runs[name] = history
    assert_histories_match(runs["port"], runs["jax"])
    best = {name: meta(tmp_path / name / "checkpoint_best_val.npz")["epoch"] for name in runs}
    assert best["port"] == best["jax"]
    assert_params_match(tmp_path / "port" / "checkpoint_final.npz",
                        tmp_path / "jax" / "checkpoint_final.npz")
    assert int(blobs(tmp_path / "port" / "checkpoint_final.npz")["opt_state::count"]) == 20


def test_cli_train_on_cpu_then_evaluate(tmp_path, capsys):
    tcli_train.main([str(TSP10), str(tmp_path / "runs"), "--device", "cpu", "--embed_dim",
                     "16", "--n_heads", "2", "--n_epochs", "2", "--batch_size", "20",
                     "--checkpoint_freq", "1", "--strict_val", "--use_gpu"])
    (run,) = (tmp_path / "runs").iterdir()
    assert "done; checkpoints in" in capsys.readouterr().out
    params = json.loads((run / "params.json").read_text())
    assert params["embed_dim"] == 16 and params["val_on_train"] is False
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"]) for r in rows)
    names = {p.name for p in run.iterdir()}
    assert {"checkpoint_best_val.npz", "checkpoint_1.npz", "checkpoint_final.npz"} <= names
    tcli_test.main([str(TSP10 / "test.txt"), str(run / "checkpoint_final.npz"),
                    str(tmp_path / "eval"), "regret_pred", "--n_iters", "1", "--device", "cpu"])
    assert "mean gap" in capsys.readouterr().out
