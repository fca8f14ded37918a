"""Training through the bf16 GATConv routes (`bf16`, `sep_fast`) against
gnngls_tpu on the CPU, at tests/test_torch_train.py's width (embed 16, 2
heads, depth 2, FFN hidden 32) with JAX-initialised weights carried across.

A bf16 rounding is a step.  Where the two packages compute a value in f32
in another order, the rounding can land on the other bf16 neighbour, and
the layers and their BatchNorms carry that on: f32 noise of 1e-7 in the
input features moves JAX's own model gradients by more than the f32
routes' bar of 1e-4 of a leaf's scale.  So the routes are held three ways.

* (a) Layer by layer, teacher-forced: the main bar.  JAX's forward is
  rebuilt from its public pieces (the loop body of gnngls_tpu/models/
  regret_gat.py: `linear`, the route's conv, `batch_norm`, `jax.nn.relu`)
  and equals `forward(train=True)` bit for bit.  Each layer's input h_l and
  output cotangent (jax.vjp of the rest of the model and the loss, layer by
  layer) are captured.  Each of the port's AttentionLayers takes JAX's h_l
  and backprops JAX's cotangent, as do the embedding and the decision with
  the loss.  Every parameter gradient, every input cotangent and the
  BatchNorm batch statistics are held at the f32 routes' bars: GRAD_TOL of
  each leaf's scale, VANISHING_TOL of the largest for a vanishing leaf.
  The seam forced is the step of every bf16 rounding of the GATConv, both
  ways.  A rounding adds its error, bf16(v) - v, to v; at each of the
  port's roundings the test adds the error JAX made at its own v in place
  of the port's.  In the forward v is what JAX casts to bf16: p and the
  gathered features before the aggregation (`bf16`); the payloads A·h and
  C·h and the direct row's p and features (`sep_fast`).  In the backward v
  is the cotangent JAX casts: the f32 result of the transposed contraction.
  Both are read off JAX's jaxpr as it is evaluated primitive by primitive.
  All else, the values the errors are added to included, is the port's own
  f32 arithmetic.  Unforced, the port's f32 values put some roundings on the
  other neighbour, and layer 0's attn_l, whose gradient is a sum that nearly
  cancels, misses the bar; with only the forward steps forced it still
  does, as the cotangents' roundings are steps too.  Forcing JAX's rounded
  values in place of its steps misses too: they then no longer match the
  port's own f32 values around them, and the cancelling sums amplify the
  mismatch.
  A vanishing leaf is one whose gradient vanishes in exact arithmetic: it
  is chosen by JAX's gradient through the route's f32 twin (`fast` for
  `bf16`, `sep` for `sep_fast`), below VANISHING of the largest.  embed.b is
  one: in the f32 model a shift of the embedding is nearly removed by
  layer 0's BatchNorm, and through the bf16 routes its gradient is the
  rounding's residue, a few 1e-4 of the largest.  It is the sum of JAX's
  own cotangent over the batch, which cancels to 1e-4 of its terms, so the
  order of that f32 sum alone moves it by more than 1e-4 of its own scale.
* (b) The whole train step, against JAX's own conditioning: one step of
  each package from the same init on the same batch.  The port's per-leaf
  miss (its error over its bar, times GRAD_TOL) is at most SPREAD_FACTOR
  times the largest that JAX shows against itself when its input features
  move by NOISE (relative, N_NOISE seeded perturbations); JAX's spread
  exceeds GRAD_TOL for `sep_fast`, and the f32 twin's, under the same
  perturbations, stays below it.  The loss within LOSS_RTOL.
* (c) The loss trajectory: `train_model` of both packages through each
  route on data/tsp10 (embed 16, 2 heads, batch 8) for three epochs from
  JAX's init; per-epoch train loss within TRAJ_RTOL relative (1e-3 for
  `bf16`; `sep_fast` misses it, and the miss is written beside the bar),
  the monitored (eval-mode) loss within VAL_RTOL, as tests/
  test_torch_train_loop.py holds the f32 routes.
* `make_dp_train_step` at world size 1 on gloo through `sep_fast` equals
  `train_step` through it in float64 within TRAIN_TOL64 of each leaf.

Every case runs on a batch whose FFN pre-activations lie at least
RELU_MARGIN from 0 through the route (tests/test_torch_train.py).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.extend.core import Literal

from gnngls_tpu.core.graph import build_topology as jtopo
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.ops import gat as jgat
from gnngls_tpu.ops import gat_sep as jgsep
from gnngls_tpu.ops.linear import linear
from gnngls_tpu.ops.norm import batch_norm
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu.train import loop as jloop
from gnngls_tpu.train import step as jstep
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.models import regret_gat as TM
from gnngls_tpu_torch.ops import gat as tgat
from gnngls_tpu_torch.ops import gat_sep as tgsep
from gnngls_tpu_torch.parallel import mesh as pm
from gnngls_tpu_torch.parallel import multihost, train_dp
from gnngls_tpu_torch.train import loop as tloop
from gnngls_tpu_torch.train import step as tstep

from test_torch_dist import _free_port
from test_torch_gat_routes import tsp20_batch
from test_torch_train import (GRAD_TOL, HEADS, LOSS_RTOL, RELU_MARGIN, TARGETS, VANISHING,
                              VANISHING_TOL, jax_init, port_model, relu_margin, tsp10_batch)
from test_torch_train_loop import VAL_RTOL, datasets, jax_start, small_cfg

ROUTES = ("bf16", "sep_fast")
F32_TWIN = {"bf16": "fast", "sep_fast": "sep"}
# Batches free of ReLU kinks through both routes and their twins.
BATCHES = {10: (tsp10_batch, np.arange(24, 32)), 20: (tsp20_batch, np.arange(8, 12))}
# JAX's spread: the largest miss over N_NOISE seeded perturbations of the
# input features by NOISE, relative.  Four seeds put it under half the port's
# miss for sep_fast (mse: 4.213e-3 against 1.035e-2); over sixteen it reaches
# 5.55e-3.  The port's miss lies above every seed's in that case: it differs
# from JAX by f32 noise in every op, not only in the inputs.
NOISE, N_NOISE, SPREAD_FACTOR = 1e-7, 16, 2.0
# Per-epoch train loss of the two packages, relative.  sep_fast misses 1e-3:
# measured 5.426e-4, 1.533e-3 and 1.030e-3 over the three epochs (bf16: 2.966e-4,
# 3.476e-4, 6.169e-4), so it is held at 2e-3.
TRAJ_RTOL = {"bf16": 1e-3, "sep_fast": 2e-3}
TRAIN_TOL64 = 1e-6  # float64 data-parallel step against train_step, of each leaf
ROUND = tgat.to_bf16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_conv(route):
    if route in ("bf16", "fast"):
        return functools.partial(jgat.gat_conv, fast=route == "bf16")
    return functools.partial(jgsep.gat_conv_sep, fast=route == "sep_fast")


def evaluate_jaxpr(fn, *args):
    """fn(*args) bound primitive by primitive, as eager JAX runs it: (its
    flat outputs, the f32 inputs of its top-level casts to bf16 in order,
    the outputs of its top-level sorts)."""
    closed = jax.make_jaxpr(fn)(*args)
    env = dict(zip(closed.jaxpr.constvars, closed.consts))
    env.update(zip(closed.jaxpr.invars, jax.tree_util.tree_leaves(args)))

    def read(v):
        return v.val if isinstance(v, Literal) else env[v]

    casts, sorts = [], []
    for eqn in closed.jaxpr.eqns:
        vals = [read(v) for v in eqn.invars]
        if (eqn.primitive is jax.lax.convert_element_type_p
                and eqn.params["new_dtype"] == jnp.bfloat16 and vals[0].dtype == jnp.float32
                and vals[0].ndim):
            casts.append(np.asarray(vals[0]))
        out = eqn.primitive.bind(*vals, **eqn.params)
        out = out if eqn.primitive.multiple_results else [out]
        if eqn.primitive is jax.lax.sort_p:
            sorts.append([np.asarray(o) for o in out])
        env.update(zip(eqn.outvars, out))
    return [read(v) for v in closed.jaxpr.outvars], casts, sorts


def assert_bits_equal(got, want, what):
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), what


def jax_loss(kind, y, pos_weight):
    if kind == "regret":
        return lambda pred: jstep.mse_loss(pred, y)
    return lambda pred: jstep.bce_with_logits_loss(pred, y, pos_weight)


def case(n, target):
    load, idx = BATCHES[n]
    kind, key = TARGETS[target]
    batch = load(idx)
    x, y = batch["features"], batch[key]
    pos_weight = float(y[0].size / y[0].sum() - 1.0) if kind == "in_solution" else 1.0
    return x, y, kind, pos_weight


def jax_value_and_grad(route, n, kind, y, pos_weight):
    loss_of = jax_loss(kind, y, pos_weight)

    @jax.jit
    def value_and_grad(p, s, x):
        def loss(p):
            pred, new_bn = JM.forward(p, s, jtopo(n), x, n_heads=HEADS, train=True,
                                      gat_impl=route)
            return loss_of(pred), new_bn
        return jax.value_and_grad(loss, has_aux=True)(p)

    return value_and_grad


def leaf_misses(port: dict, want: dict, twin: dict = None) -> dict:
    """Each leaf's error over its bar, times GRAD_TOL: at most GRAD_TOL where
    the leaf holds the f32 routes' bar.  The bar is GRAD_TOL of the leaf's
    largest value, or, given the f32 twin's gradients, VANISHING_TOL of the
    largest over all leaves where the twin's gradient of the leaf is below
    VANISHING of its largest."""
    top = max(float(np.abs(v).max()) for v in want.values())
    twin_top = twin and max(float(np.abs(v).max()) for v in twin.values())
    out = {}
    for key, w in want.items():
        vanishing = twin is not None and float(np.abs(twin[key]).max()) < VANISHING * twin_top
        bar = VANISHING_TOL * top if vanishing else GRAD_TOL * float(np.abs(w).max())
        got = port[key.replace("/", ".")]
        got = got.detach().numpy() if torch.is_tensor(got) else got
        out[key] = GRAD_TOL * float(np.abs(got - w).max()) / bar
    return out


def assert_within(misses: dict, what: str):
    bad = {k: f"{v:.3e}" for k, v in misses.items() if v > GRAD_TOL}
    assert not bad, f"{what} over {GRAD_TOL}: {bad}"


def scan_cotangents_unsorted(casts, perm, hf):
    """The scans' cotangents JAX casts, (B, n, K, H*F) in each group's sorted
    order, put back in the groups' own order as (B, n, K, H, F)."""
    out = []
    for c in casts:
        if c.ndim == 4 and c.shape[-1] == hf:
            sorted_ = c.reshape(perm.shape + (-1,))
            c = np.empty_like(sorted_)
            np.put_along_axis(c, np.broadcast_to(perm[..., None], sorted_.shape), sorted_, axis=-3)
        out.append(c)
    return out


def jax_teacher(route, n, params, bn, x, loss_of):
    """JAX's forward rebuilt from its pieces and checked against
    `forward(train=True)`; each layer's input, output cotangent, parameter
    gradients and new batch statistics; the values each conv rounds to bf16
    (forward inputs, backward cotangents)."""
    topo, conv = jtopo(n), jax_conv(route)

    def conv_of(gp, h):
        return conv(gp, topo, h, HEADS)

    def post(lp, ls, u):  # the layer after the skip-connected GATConv
        h, bn1 = batch_norm(lp.bn1, ls.bn1, u, True)
        h = h + linear(lp.ffn2, jax.nn.relu(linear(lp.ffn1, h)))
        h, bn2 = batch_norm(lp.bn2, ls.bn2, h, True)
        return h, JM.AttentionLayerState(bn1=bn1, bn2=bn2)

    hs, states, convs = [linear(params.embed, x)], [], []
    for lp, ls in zip(params.layers, bn.layers):
        convs.append(conv_of(lp.gat, hs[-1]))
        h, st = post(lp, ls, hs[-1] + convs[-1])
        hs.append(h)
        states.append(st)
    pred = linear(params.decision, hs[-1])
    want, want_bn = JM.forward(params, bn, topo, x, n_heads=HEADS, train=True, gat_impl=route)
    assert_bits_equal((pred, states), (want, want_bn.layers), "the rebuilt forward")

    loss, head_vjp = jax.vjp(lambda p, h: loss_of(linear(p, h)), params.decision, hs[-1])
    g_decision, g = head_vjp(jnp.ones_like(loss))
    gs, g_layers, steps = [g], [], []
    for l in reversed(range(len(params.layers))):
        lp, ls = params.layers[l], bn.layers[l]
        c, conv_vjp = jax.vjp(conv_of, lp.gat, hs[l])
        out, post_vjp = jax.vjp(lambda q, u: post(q, ls, u)[0], lp, hs[l] + c)
        assert_bits_equal((c, out), (convs[l], hs[l + 1]), f"layer {l}'s vjp forward")
        g_lp, g_u = post_vjp(gs[0])
        g_gat, g_h = conv_vjp(g_u)
        outs, back, _ = evaluate_jaxpr(conv_vjp, g_u)
        assert_bits_equal(outs, (g_gat, g_h), f"layer {l}'s conv vjp, evaluated")
        outs, fwd, sorts = evaluate_jaxpr(conv_of, lp.gat, hs[l])
        assert_bits_equal(outs, c, f"layer {l}'s conv, evaluated")
        if sorts:
            back = scan_cotangents_unsorted(back, sorts[0][1], lp.gat.fc_w.shape[1])
        gs.insert(0, g_u + g_h)
        g_layers.insert(0, g_lp._replace(gat=g_gat))
        steps.insert(0, (fwd, back))
    g_embed = jax.vjp(lambda p: linear(p, x), params.embed)[1](gs[0])[0]
    grads = jck._flatten(JM.RegretGNNParams(g_embed, g_layers, g_decision))
    return dict(hs=hs, gs=gs, grads=grads, states=jck._flatten(JM.RegretGNNState(states)),
                steps=steps)


class _Step(torch.autograd.Function):
    """A bf16 rounding of the port's x that takes JAX's step: x plus the
    rounding error JAX made at its own value (bf16(v) - v) in the forward,
    and in the backward the port's cotangent plus the error JAX made
    rounding its own, the one of the same shape nearest the port's (within
    STEP_MATCH of its scale)."""

    @staticmethod
    def forward(ctx, x, value, cotangents):
        assert value.shape == x.shape
        ctx.cotangents = cotangents
        return x + (ROUND(value) - value)

    @staticmethod
    def backward(ctx, g):
        cands = [(i, c) for i, c in enumerate(ctx.cotangents)
                 if c is not None and c.shape == tuple(g.shape)]
        dists = [float(np.abs(c - g.numpy()).max()) for _, c in cands]
        k = int(np.argmin(dists))
        assert dists[k] <= STEP_MATCH * float(g.abs().max()), "no JAX cotangent near the port's"
        i, c = cands[k]
        ctx.cotangents[i] = None  # each is used once
        c = torch.as_tensor(c)
        return g + (ROUND(c) - c), None, None


STEP_MATCH = 1e-3


def jax_steps(monkeypatch, fwd, back):
    """The port's `to_bf16` (ops/gat.py, ops/gat_sep.py) taking JAX's steps,
    call by call in order."""
    fwd, back = list(fwd), list(back)

    def to_bf16(t):
        return _Step.apply(t, torch.as_tensor(fwd.pop(0)), back)

    monkeypatch.setattr(tgat, "to_bf16", to_bf16)
    monkeypatch.setattr(tgsep, "to_bf16", to_bf16)
    return fwd, back


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n,target", [(10, "mse"), (10, "bce_strict"), (20, "mse")])
def test_layers_teacher_forced_match_jax(route, n, target, monkeypatch):
    x, y, kind, pos_weight = case(n, target)
    _, params, bn = jax_init()
    jt = jax_teacher(route, n, params, bn, jnp.asarray(x), jax_loss(kind, y, pos_weight))
    (_, _), twin = jax_value_and_grad(F32_TWIN[route], n, kind, y, pos_weight)(
        params, bn, jnp.asarray(x))
    twin = jck._flatten(twin)

    model = port_model(params, bn).train()
    assert relu_margin(model, x, route) >= RELU_MARGIN, "the batch sits on a ReLU kink"
    model.embed(torch.as_tensor(x)).backward(torch.as_tensor(np.array(jt["gs"][0])))
    conv, topo = TM.gat_conv_for(route), build_topology(n)
    cotangents = {}
    for l, layer in enumerate(model.layers):
        with monkeypatch.context() as m:
            fwd, back = jax_steps(m, *jt["steps"][l])
            h = torch.tensor(np.array(jt["hs"][l]), requires_grad=True)
            layer(h, conv, topo).backward(torch.as_tensor(np.array(jt["gs"][l + 1])))
            assert not fwd and all(c is None for c in back), "a rounding was not matched"
        cotangents[f"h.{l}"] = h.grad
    h = torch.tensor(np.array(jt["hs"][-1]), requires_grad=True)
    tstep.loss_fn(model.decision(h), torch.as_tensor(y), target_kind=kind,
                  pos_weight=pos_weight).backward()
    cotangents[f"h.{len(model.layers)}"] = h.grad

    grads = {name: p.grad for name, p in model.named_parameters()}
    assert_within(leaf_misses(grads, jt["grads"], twin), "grad")
    want = {f"h/{l}": np.asarray(g) for l, g in enumerate(jt["gs"])}
    assert_within(leaf_misses(cotangents, want), "input cotangent")
    stats = {k: t for k, t in model.state_dict().items() if k.endswith((".mean", ".var"))}
    assert_within(leaf_misses(stats, jt["states"]), "batch statistics")


def perturbed(x, seed):
    rng = np.random.default_rng(seed)
    return (x * (1.0 + NOISE * rng.standard_normal(x.shape))).astype(np.float32)


def jax_spread(route, n, kind, y, pos_weight, params, bn, x, twin):
    """The largest per-leaf miss of JAX's gradient at the perturbed inputs
    against its gradient at x; and that gradient and loss."""
    value_and_grad = jax_value_and_grad(route, n, kind, y, pos_weight)
    (loss, new_bn), grads = value_and_grad(params, bn, jnp.asarray(x))
    grads = jck._flatten(grads)
    spread = 0.0
    for seed in range(N_NOISE):
        _, moved = value_and_grad(params, bn, jnp.asarray(perturbed(x, seed)))
        moved = {k.replace("/", "."): v for k, v in jck._flatten(moved).items()}
        spread = max(spread, max(leaf_misses(moved, grads, twin).values()))
    return spread, float(loss), grads, jck._flatten(new_bn)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("target", ["mse", "bce_strict"])
def test_whole_step_within_jax_spread(route, target):
    n = 10
    x, y, kind, pos_weight = case(n, target)
    _, params, bn = jax_init()
    (_, _), twin = jax_value_and_grad(F32_TWIN[route], n, kind, y, pos_weight)(
        params, bn, jnp.asarray(x))
    twin = jck._flatten(twin)
    spread, jloss, jgrads, jstats = jax_spread(route, n, kind, y, pos_weight, params, bn, x, twin)
    twin_spread = jax_spread(F32_TWIN[route], n, kind, y, pos_weight, params, bn, x, twin)[0]
    assert twin_spread < GRAD_TOL, f"JAX's {F32_TWIN[route]} route moves by {twin_spread:.3e}"
    if route == "sep_fast":
        assert spread > GRAD_TOL, f"JAX's sep_fast spread {spread:.3e} is within the f32 bar"

    model = port_model(params, bn).train()
    assert relu_margin(model, x, route) >= RELU_MARGIN, "the batch sits on a ReLU kink"
    loss = tstep.loss_fn(model(torch.as_tensor(x), gat_impl=route), torch.as_tensor(y),
                         target_kind=kind, pos_weight=pos_weight)
    loss.backward()
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    grads = {name: p.grad for name, p in model.named_parameters()}
    misses = leaf_misses(grads, jgrads, twin)
    worst = max(misses, key=misses.get)
    assert misses[worst] <= SPREAD_FACTOR * spread, \
        f"{worst}: {misses[worst]:.3e} > {SPREAD_FACTOR} x JAX's spread {spread:.3e}"
    stats = {k: t for k, t in model.state_dict().items() if k.endswith((".mean", ".var"))}
    assert_within(leaf_misses(stats, jstats), "batch statistics")


@pytest.mark.parametrize("route", ROUTES)
def test_train_model_trajectory_matches_jax(tmp_path, route):
    (jtrain, ttrain), (jval, tval) = datasets("train"), datasets("val")
    jcfg, tcfg = small_cfg(n_epochs=3, gat_impl=route)
    start = jax_start(tmp_path / "start.npz", jcfg)
    _, _, jh = jloop.train_model(jtrain, jval, jcfg, tmp_path / "jax", resume_from=start,
                                 verbose=False)
    _, th = tloop.train_model(ttrain, tval, tcfg, tmp_path / "port", resume_from=start,
                              device="cpu", verbose=False)
    assert [r["epoch"] for r in th] == [r["epoch"] for r in jh] == [0, 1, 2]
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= TRAJ_RTOL[route] * abs(b["loss"]), (a, b)
        assert abs(a["val_loss"] - b["val_loss"]) <= VAL_RTOL * abs(b["val_loss"]), (a, b)
        assert np.isfinite(a["loss"]) and np.isfinite(a["val_loss"])


def test_dp_train_step_through_sep_fast_at_world_size_one():
    x, y, kind, _ = case(10, "mse")
    _, params, bn = jax_init()
    model = port_model(params, bn).double()
    dp_model = copy.deepcopy(model)
    x64, y64 = torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(y, dtype=torch.float64)
    multihost.initialize(coordinator_address=f"localhost:{_free_port()}", num_processes=1,
                         process_id=0)
    try:
        mesh = pm.make_mesh(axes=("data",))
        step, _ = train_dp.make_dp_train_step(dp_model, tstep.make_optimizer(dp_model), mesh,
                                              gat_impl="sep_fast")
        shard = train_dp.shard_batch(mesh, {"x": x64.numpy(), "y": y64.numpy()})
        dp_loss = float(step(shard["x"], shard["y"]))
    finally:
        dist.destroy_process_group()
    loss = float(tstep.train_step(model, tstep.make_optimizer(model), x64, y64,
                                  gat_impl="sep_fast"))
    assert abs(dp_loss - loss) <= 1e-12 * abs(loss)
    want = {k: p.grad.numpy() for k, p in model.named_parameters()}
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, p in dp_model.named_parameters():
        scale = float(np.abs(want[k]).max())
        bar = TRAIN_TOL64 * (scale if scale >= VANISHING * top else top)
        assert float(np.abs(p.grad.numpy() - want[k]).max()) <= bar, k
    stats = model.state_dict()
    for k, t in dp_model.state_dict().items():
        if k.endswith((".mean", ".var")):
            assert float((t - stats[k]).abs().max()) <= TRAIN_TOL64 * float(stats[k].abs().max())
