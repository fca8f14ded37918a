"""The port's training pieces against gnngls_tpu, on the CPU, at a small width
(embed 16, 2 heads, depth 2, FFN hidden 32) with JAX-initialised weights
carried across.

* Train-mode BatchNorm: outputs and both running statistics within 1e-6 of
  the largest value (f32 reductions in another order).
* One train step on tsp10 batches: the loss within 1e-5 relative, the
  gradient of every leaf and the BatchNorm running statistics within 1e-4
  of each leaf's largest value, in MSE and in both BCE modes (bug-compat:
  the unscaled regret as target; strict: the in_solution labels), through
  the `fast`, `naive` and `sep` routes.  The bar needs a batch on which no
  FFN pre-activation lies within f32 rounding of 0: at such a ReLU kink
  either package's f32 forward may take the other side than exact
  arithmetic, which moves that layer's FFN gradients by about 1e-3 of their
  scale (at the full FFN width of 512, one batch of 8 in three has one).
  The test checks that every pre-activation of its batch, in the port's f64
  forward, lies at least 1e-5 from 0, ten times the f32 forwards' error
  there.  A leaf whose gradient
  vanishes in exact arithmetic holds only rounding noise, up to a few 1e-6 of
  the largest gradient: each ffn2.b, whose shift bn2 removes, and, with
  these one-feature inputs, embed.b and layer 0's attn_r.  A leaf whose
  largest JAX gradient is below 1e-4 of the largest over all leaves is
  therefore held to 1e-5 of that largest.
* Adam: three updates from the same gradients give optax's parameters, mu
  and nu within 1e-6 of each leaf's largest value.  Three whole train steps
  give JAX's losses within 1e-5 relative, and its parameters and running
  statistics within 1e-4 of each leaf's largest value, but for each ffn2.b
  and bn2's running mean: Adam moves an element by about lr times the sign
  of its gradient, and ffn2.b's gradient is rounding noise whose sign each
  package draws on its own, so ffn2.b walks by up to lr a step (and bn2's
  mean follows); those are held within 4 lr.
* `count_params` at the shipped width equals JAX's; `init_params` draws
  JAX's shapes from the stated distributions (means and standard
  deviations within five standard errors).
"""

import copy
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnngls_tpu.core.graph import build_topology as jbuild_topology
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.ops.norm import BatchNormParams, BatchNormState
from gnngls_tpu.ops.norm import batch_norm as jbatch_norm
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu.train import step as jstep
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.models import regret_gat as TM
from gnngls_tpu_torch.models.convert import state_from_jax_numpy
from gnngls_tpu_torch.ops.norm import BatchNorm
from gnngls_tpu_torch.train import step as tstep

ROOT = pathlib.Path(__file__).resolve().parent.parent
EMBED, HEADS, HIDDEN = 16, 2, 32
RELU_MARGIN = 1e-5  # the batch's FFN pre-activations lie at least this far from 0
LOSS_RTOL = 1e-5  # the loss, relative
GRAD_TOL = 1e-4  # each leaf, of its largest absolute value
VANISHING = 1e-4  # a leaf below this share of the largest gradient holds only noise
VANISHING_TOL = 1e-5  # such a leaf, of the largest gradient over all leaves
ADAM_TOL = 1e-6  # optax against torch.optim.Adam on the same gradients
STEPS_LR_BAR = 4.0  # whole train steps: a drifting leaf within this many learning rates
DRIFTING = ("ffn2/b", "bn2/mean")  # Adam walks ffn2.b on noise; bn2's mean follows it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_init(seed=0):
    cfg = JM.RegretGNNConfig(embed_dim=EMBED, n_heads=HEADS, hidden_dim=HIDDEN)
    params, bn = JM.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, params, bn


def port_model(params, bn):
    blobs = {f"params::{k}": v for k, v in jck._flatten(params).items()}
    blobs.update({f"bn_state::{k}": v for k, v in jck._flatten(bn).items()})
    model = TM.RegretGNN(TM.RegretGNNConfig(embed_dim=EMBED, n_heads=HEADS, hidden_dim=HIDDEN))
    model.load_state_dict(state_from_jax_numpy(blobs), strict=True)
    return model


def tsp10_batch(idx):
    root = ROOT / "data" / "tsp10"
    ds = tds.TSPDataset.from_npz(root / "instances.npz", root / "train.txt",
                                 scalers_file=root / "scalers.json")
    return ds.get_scaled_batch(idx)


def relu_margin(model, x, gat_impl):
    """The smallest |FFN pre-activation| of the model's f64 forward in train
    mode (on a copy)."""
    m = copy.deepcopy(model).double().train()
    pre = []
    for layer in m.layers:
        layer.ffn1.register_forward_hook(lambda mod, inp, o: pre.append(float(o.abs().min())))
    with torch.no_grad():
        m(torch.as_tensor(x, dtype=torch.float64), gat_impl=gat_impl)
    return min(pre)


def assert_leaves_close(port: dict, jax_flat: dict, tol: float, what="", vanishing=0.0):
    """Each port leaf (state-dict name -> tensor) against the JAX leaf at the
    same path: max |a - b| <= tol * max |b|; a leaf whose max |b| is below
    `vanishing` times the largest over all leaves is held to VANISHING_TOL
    of that largest."""
    top = max(float(np.abs(v).max()) for v in jax_flat.values())
    assert set(port) == {k.replace("/", ".") for k in jax_flat}
    for key, want in jax_flat.items():
        got = port[key.replace("/", ".")].detach().numpy()
        scale = float(np.abs(want).max())
        bar = VANISHING_TOL * top if scale < vanishing * top else tol * scale
        err = float(np.abs(got - want).max())
        assert err <= bar, f"{what} {key}: {err:.3e} > {bar:.3e}"


@pytest.mark.parametrize("shape", [(2, 45, 16), (1, 3, 4), (3, 190, 8)])
def test_batch_norm_train_mode_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = (3 * rng.standard_normal(shape) + rng.standard_normal(c)).astype(np.float32)
    scale, bias = rng.random(c).astype(np.float32), rng.standard_normal(c).astype(np.float32)
    mean, var = rng.standard_normal(c).astype(np.float32), rng.random(c).astype(np.float32)
    want, st = jbatch_norm(BatchNormParams(jnp.asarray(scale), jnp.asarray(bias)),
                           BatchNormState(jnp.asarray(mean), jnp.asarray(var)),
                           jnp.asarray(x), True)
    bn = BatchNorm(c)
    with torch.no_grad():
        for name, arr in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
            getattr(bn, name).copy_(torch.as_tensor(arr))
    got = bn.train()(torch.as_tensor(x))
    for a, b in ((got, want), (bn.mean, st.mean), (bn.var, st.var)):
        b = np.asarray(b)
        assert float(np.abs(a.detach().numpy() - b).max()) <= 1e-6 * float(np.abs(b).max())
    # eval mode reads the updated statistics, in the eval expression order
    want_eval, _ = jbatch_norm(BatchNormParams(jnp.asarray(scale), jnp.asarray(bias)), st,
                               jnp.asarray(x), False)
    with torch.no_grad():
        got_eval = bn.eval()(torch.as_tensor(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=1e-5, atol=1e-5)


TARGETS = {"mse": ("regret", "regret"), "bce_bug_compat": ("in_solution", "regret_unscaled"),
           "bce_strict": ("in_solution", "in_solution")}


@pytest.mark.parametrize("gat_impl,target", [
    ("fast", "mse"), ("fast", "bce_bug_compat"), ("fast", "bce_strict"),
    ("naive", "mse"), ("naive", "bce_strict"), ("sep", "mse"), ("sep", "bce_bug_compat")])
def test_train_step_matches_jax(gat_impl, target):
    kind, key = TARGETS[target]
    batch = tsp10_batch(np.arange(8))
    x, y = batch["features"], batch[key]
    pos_weight = float(y[0].size / y[0].sum() - 1.0) if kind == "in_solution" else 1.0
    cfg, params, bn = jax_init()
    topo = jbuild_topology(10)

    @jax.jit
    def value_and_grad(p, s):
        def loss(p):
            pred, new_bn = JM.forward(p, s, topo, jnp.asarray(x), n_heads=HEADS, train=True,
                                      gat_impl=gat_impl)
            if kind == "regret":
                return jstep.mse_loss(pred, y), new_bn
            return jstep.bce_with_logits_loss(pred, y, pos_weight), new_bn
        return jax.value_and_grad(loss, has_aux=True)(p)

    (jloss, jbn), jgrad = value_and_grad(params, bn)
    model = port_model(params, bn).train()
    assert relu_margin(model, x, gat_impl) >= RELU_MARGIN, "the batch sits on a ReLU kink"
    loss = tstep.loss_fn(model(torch.as_tensor(x), gat_impl=gat_impl), torch.as_tensor(y),
                         target_kind=kind, pos_weight=pos_weight)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert_leaves_close(grads, jck._flatten(jgrad), GRAD_TOL, "grad", VANISHING)
    stats = {name: t for name, t in model.state_dict().items()
             if name.endswith((".mean", ".var"))}
    assert_leaves_close(stats, jck._flatten(jbn), GRAD_TOL, what="bn state")


def test_adam_matches_optax():
    cfg, params, bn = jax_init(1)
    model = port_model(params, bn)
    opt = jstep.make_optimizer()
    ost = opt.init(params)
    torch_opt = tstep.make_optimizer(model)
    rng = np.random.default_rng(5)
    lr = 1e-3
    for k in range(3):
        lr *= 0.99
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                                  * (1e-3 if k else 1.0)), params)
        ost = jstep.set_lr(ost, lr)
        upd, ost = opt.update(grads, ost, params)
        params = optax.apply_updates(params, upd)
        tstep.set_lr(torch_opt, lr)
        flat = jck._flatten(grads)
        for name, p in model.named_parameters():
            p.grad = torch.as_tensor(np.array(flat[name.replace(".", "/")]))
        torch_opt.step()
    names = dict(model.named_parameters())
    assert_leaves_close(names, jck._flatten(params), ADAM_TOL, what="param")
    inner = ost.inner_state[0]
    for moment, torch_key in ((inner.mu, "exp_avg"), (inner.nu, "exp_avg_sq")):
        got = {name: torch_opt.state[p][torch_key] for name, p in names.items()}
        assert_leaves_close(got, jck._flatten(moment), ADAM_TOL, what=torch_key)
    assert all(int(torch_opt.state[p]["step"]) == int(inner.count) == 3 for p in names.values())


def test_three_train_steps_match_jax():
    cfg, params, bn = jax_init(2)
    opt = jstep.make_optimizer()
    state = jstep.TrainState(params, bn, opt.init(params))
    jtrain, _ = jstep.make_train_step(cfg, 10, opt)
    model = port_model(params, bn)
    torch_opt = tstep.make_optimizer(model)
    for k in range(3):
        batch = tsp10_batch(np.arange(8 * k, 8 * k + 8))
        state, jloss = jtrain(state, jnp.asarray(batch["features"]), jnp.asarray(batch["regret"]))
        loss = tstep.train_step(model, torch_opt, torch.as_tensor(batch["features"]),
                                torch.as_tensor(batch["regret"]))
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    sd = model.state_dict()
    for key, want in {**jck._flatten(state.params), **jck._flatten(state.bn_state)}.items():
        err = float(np.abs(sd[key.replace("/", ".")].numpy() - want).max())
        bar = STEPS_LR_BAR * 1e-3 if key.endswith(DRIFTING) else GRAD_TOL * np.abs(want).max()
        assert err <= bar, f"{key}: {err:.3e} > {bar:.3e}"


def test_count_params_matches_jax_at_full_width():
    params, _ = JM.init_params(jax.random.PRNGKey(0), JM.RegretGNNConfig())
    model = TM.init_params(TM.RegretGNNConfig(), torch.Generator().manual_seed(0))
    assert TM.count_params(model) == JM.count_params(params) == 1_191_297


def test_init_params_draws_the_stated_distributions():
    cfg = TM.RegretGNNConfig()
    model = TM.init_params(cfg, torch.Generator().manual_seed(3))
    again = TM.init_params(cfg, torch.Generator().manual_seed(3))
    params, bn = JM.init_params(jax.random.PRNGKey(0), JM.RegretGNNConfig())
    shapes = {k: v.shape for k, v in jck._flatten(params).items()}
    shapes.update({k: v.shape for k, v in jck._flatten(bn).items()})
    sd = model.state_dict()
    assert {k.replace("/", "."): s for k, s in shapes.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    for name, t in sd.items():
        assert torch.equal(t, again.state_dict()[name]), name
        leaf = name.rsplit(".", 1)[1]
        if leaf in ("scale", "var"):
            assert bool((t == 1).all()), name
            continue
        if leaf in ("bias", "mean"):
            assert bool((t == 0).all()), name
            continue
        x = t.double().flatten()
        N = x.numel()
        if leaf in ("w", "b"):  # U(-1/sqrt(c_in), 1/sqrt(c_in))
            c_in = sd[name.rsplit(".", 1)[0] + ".w"].shape[0]
            bound = 1 / math.sqrt(c_in)
            assert float(x.abs().max()) <= bound, name
            std = bound / math.sqrt(3)
        else:  # Xavier normal, gain sqrt(2)
            fans = (t.shape[0], t.shape[1]) if leaf == "fc_w" else (t.shape[1], t.shape[1])
            std = math.sqrt(2.0) * math.sqrt(2.0 / sum(fans))
        if N < 8:
            continue
        assert abs(float(x.mean())) <= 5 * std / math.sqrt(N), name
        assert abs(float(x.std()) / std - 1) <= 5 / math.sqrt(2 * N) + 1 / N, name


def test_train_mode_refuses_the_kernel_routes():
    _, params, bn = jax_init()
    model = port_model(params, bn).train()
    x = torch.zeros((1, 45, 1))
    for impl in ("auto", "pallas", "pallas_mxu", "pallas_sep", "pallas_sep_fast@2"):
        with pytest.raises(ValueError, match="fast"):
            model(x, gat_impl=impl)
    assert bool((model.layers[0].bn1.mean == 0).all())  # refused before any update
    # sep_fast, a bf16 route, trains (tests/test_torch_train_bf16.py holds it to JAX)
    x = torch.as_tensor(tsp10_batch(np.arange(2))["features"])
    model(x, gat_impl="sep_fast").sum().backward()
    assert not bool((model.layers[0].bn1.mean == 0).all())
    assert torch.isfinite(model.layers[0].gat.fc_w.grad).all()
    model.eval()(x)  # eval mode still takes the kernel route's twin
