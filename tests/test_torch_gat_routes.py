"""The `chunked` and `bf16` GATConv routes, and the gradients of the routes
that differentiate through bf16 roundings, against gnngls_tpu on the CPU.

* `chunked` (gat_conv_chunked) against JAX's at 2e-5 of the output scale,
  as K2's conv is held, at an n that city_chunk divides and at n whose chunk
  falls back to a smaller divisor; and in train mode: one train step on tsp20
  batches (two chunks of 10 cities) against JAX's at tests/test_torch_train.py's
  bars (the batch checked free of ReLU kinks).
* `bf16` (gat_conv(fast=True)) against JAX's at 1e-4 of the scale; the port's
  f32 route misses that bar on the same data, so the bf16 rounding is JAX's.
* The GATConv's gradient (with respect to x and the three parameters) of the
  `bf16`, `sep_fast` and `chunked` routes, on the same inputs and cotangent
  as jax.vjp: within 1e-4 of each leaf's scale (1e-5 of the largest for a
  leaf below 1e-4 of it).  For the bf16 routes the f32 route's gradient
  misses that bar, so the backward rounds where JAX's transposes round.
  The bf16 routes train: their forward runs in train mode and the gradient
  reaches every parameter.  Their whole-model gradients are held to JAX's in
  tests/test_torch_train_bf16.py, layer by layer and against JAX's own
  spread: a bf16 rounding is a step, and f32 noise of 1e-7 in the inputs
  moves either package's model gradients by 1e-3 to 1e-2 of a leaf's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.core.graph import build_topology as jtopo
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.ops import gat as jgat
from gnngls_tpu.ops import gat_sep as jgsep
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu.train import step as jstep
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.models import regret_gat as TM
from gnngls_tpu_torch.ops import gat as tgat
from gnngls_tpu_torch.ops.gat_sep import gat_conv_sep
from gnngls_tpu_torch.train import step as tstep

from test_torch_train import (GRAD_TOL, LOSS_RTOL, RELU_MARGIN, ROOT, VANISHING,
                              assert_leaves_close, port_model, relu_margin)

CONV, BF16 = 2e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(n, H, F, scale, seed, batch=(2,)):
    """Both packages' params and x, drawn with a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    c = H * F
    w, al, ar = (rng.normal(size=s) * scale for s in ((c, c), (H, F), (H, F)))
    x = rng.normal(size=batch + (n * (n - 1) // 2, c))
    w, al, ar, x = (np.asarray(a, np.float32) for a in (w, al, ar, x))
    return (w, al, ar), x


def _bar(rel, want):
    return rel * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("n,city_chunk,H,F", [(32, 16, 2, 8), (20, 16, 4, 8), (12, 5, 2, 4),
                                              (16, 16, 8, 16)])
def test_chunked_matches_jax(n, city_chunk, H, F):
    """n=32: two chunks of 16; n=20: 16 does not divide, chunks of 10; n=12
    with city_chunk 5: chunks of 4; n=16 at the shipped head shape."""
    arrays, x = _case(n, H, F, 0.5, n)
    want = np.asarray(jgat.gat_conv_chunked(jgat.GATParams(*map(jnp.asarray, arrays)), jtopo(n),
                                            jnp.asarray(x), H, city_chunk=city_chunk))
    got = tgat.gat_conv_chunked(tgat.GATParams(*map(torch.as_tensor, arrays)), build_topology(n),
                                torch.as_tensor(x), H, city_chunk=city_chunk).numpy()
    assert np.abs(got - want).max() <= _bar(CONV, want)
    dense = tgat.gat_conv(tgat.GATParams(*map(torch.as_tensor, arrays)), build_topology(n),
                          torch.as_tensor(x), H).numpy()
    assert np.abs(dense - want).max() <= _bar(CONV, want)
    # unbatched input keeps its shape
    one = tgat.gat_conv_chunked(tgat.GATParams(*map(torch.as_tensor, arrays)), build_topology(n),
                                torch.as_tensor(x[0]), H, city_chunk=city_chunk)
    assert one.shape == want.shape[1:]


@pytest.mark.parametrize("n,H,F,scale", [(10, 2, 8, 0.3), (10, 2, 8, 1.25), (16, 8, 16, 0.5),
                                         (7, 1, 8, 1.0)])
def test_bf16_matches_jax_and_the_f32_route_does_not(n, H, F, scale):
    arrays, x = _case(n, H, F, scale, 100 + n)
    want = np.asarray(jgat.gat_conv(jgat.GATParams(*map(jnp.asarray, arrays)), jtopo(n),
                                    jnp.asarray(x), H, fast=True))
    tp = tgat.GATParams(*map(torch.as_tensor, arrays))
    got = tgat.gat_conv(tp, build_topology(n), torch.as_tensor(x), H, fast=True).numpy()
    assert np.abs(got - want).max() <= _bar(BF16, want)
    f32 = tgat.gat_conv(tp, build_topology(n), torch.as_tensor(x), H).numpy()
    assert np.abs(f32 - want).max() > _bar(BF16, want)
    assert TM.gat_conv_for("bf16")(tp, build_topology(n), torch.as_tensor(x), H).numpy().tobytes() \
        == got.tobytes()


def _jax_conv(route):
    if route == "chunked":
        return jgat.gat_conv_chunked
    if route == "bf16":
        return lambda p, topo, x, H: jgat.gat_conv(p, topo, x, H, fast=True)
    return lambda p, topo, x, H: jgsep.gat_conv_sep(p, topo, x, H, fast=True)


def _leaf_errors(got, want):
    """Each leaf's max error over its bar (1e-4 of its scale; 1e-5 of the
    largest scale where its own is below 1e-4 of that)."""
    top = max(float(np.abs(w).max()) for w in want)
    out = []
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        bar = 1e-5 * top if scale < VANISHING * top else GRAD_TOL * scale
        out.append(float(np.abs(g - w).max()) / bar)
    return out


@pytest.mark.parametrize("route,n,H,F,rank1", [
    ("bf16", 10, 2, 8, False), ("bf16", 10, 2, 8, True), ("bf16", 12, 4, 4, False),
    ("sep_fast", 10, 2, 8, False), ("sep_fast", 10, 2, 8, True), ("sep_fast", 12, 4, 4, False),
    ("chunked", 20, 2, 8, False), ("chunked", 12, 4, 4, True)])
def test_route_gradient_matches_jax_vjp(route, n, H, F, rank1):
    """rank1: x as layer 0 sees it, an affine image of a one-feature input."""
    arrays, x = _case(n, H, F, 0.5, 7 * n + H)
    rng = np.random.default_rng(n)
    if rank1:
        d = rng.random(x.shape[:-1] + (1,))
        x = (d * rng.normal(size=x.shape[-1]) + rng.normal(size=x.shape[-1])).astype(np.float32)
    ct = rng.normal(size=x.shape[:-1] + (H * F,)).astype(np.float32)
    conv = _jax_conv(route)

    def f(w, al, ar, xx):
        return jnp.sum(conv(jgat.GATParams(w, al, ar), jtopo(n), xx, H) * ct)

    want = [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*arrays, x)]

    def port_grads(port_route):
        leaves = [torch.tensor(a, requires_grad=True) for a in (*arrays, x)]
        out = TM.gat_conv_for(port_route)(tgat.GATParams(*leaves[:3]), build_topology(n),
                                          leaves[3], H)
        (out * torch.as_tensor(ct)).sum().backward()
        return [t.grad.numpy() for t in leaves]

    assert max(_leaf_errors(port_grads(route), want)) <= 1.0
    if route != "chunked":  # the same data through f32 misses: the rounding is JAX's
        f32 = {"bf16": "fast", "sep_fast": "sep"}[route]
        assert max(_leaf_errors(port_grads(f32), want)) > 1.0


def tsp20_batch(idx):
    root = ROOT / "data" / "tsp20"
    ds = tds.TSPDataset.from_npz(root / "instances.npz", root / "train.txt",
                                 scalers_file=root / "scalers.json")
    return ds.get_scaled_batch(idx)


@pytest.mark.parametrize("target", ["mse", "bce_strict"])
def test_chunked_train_step_matches_jax(target):
    """tests/test_torch_train.py's step at n=20, where the route's default
    city_chunk of 16 falls back to two chunks of 10 cities."""
    from test_torch_train import TARGETS, jax_init

    kind, key = TARGETS[target]
    batch = tsp20_batch(np.arange(4))
    x, y = batch["features"], batch[key]
    pos_weight = float(y[0].size / y[0].sum() - 1.0) if kind == "in_solution" else 1.0
    _, params, bn = jax_init()

    @jax.jit
    def value_and_grad(p, s):
        def loss(p):
            pred, new_bn = JM.forward(p, s, jtopo(20), jnp.asarray(x), n_heads=2, train=True,
                                      gat_impl="chunked")
            if kind == "regret":
                return jstep.mse_loss(pred, y), new_bn
            return jstep.bce_with_logits_loss(pred, y, pos_weight), new_bn
        return jax.value_and_grad(loss, has_aux=True)(p)

    (jloss, jbn), jgrad = value_and_grad(params, bn)
    model = port_model(params, bn).train()
    assert relu_margin(model, x, "chunked") >= RELU_MARGIN, "the batch sits on a ReLU kink"
    loss = tstep.loss_fn(model(torch.as_tensor(x), gat_impl="chunked"), torch.as_tensor(y),
                         target_kind=kind, pos_weight=pos_weight)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert_leaves_close(grads, jck._flatten(jgrad), GRAD_TOL, "grad", VANISHING)
    stats = {name: t for name, t in model.state_dict().items()
             if name.endswith((".mean", ".var"))}
    assert_leaves_close(stats, jck._flatten(jbn), GRAD_TOL, what="bn state")


def test_bf16_routes_train_and_run_in_eval():
    model = TM.init_params(TM.RegretGNNConfig(embed_dim=8, n_heads=2),
                           torch.Generator().manual_seed(0)).train()
    x = torch.rand((2, 10, 1), generator=torch.Generator().manual_seed(1))
    for impl in ("sep_fast", "bf16"):
        assert impl in TM.TRAIN_ROUTES
        model.zero_grad()
        model(x, gat_impl=impl).square().mean().backward()
        for name, p in model.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), (impl, name)
        assert float(model.layers[0].gat.attn_l.grad.abs().max()) > 0
    assert not bool((model.layers[0].bn1.mean == 0).all())  # train mode updated the statistics
    model.eval()
    for impl in ("sep_fast", "bf16", "chunked"):
        assert torch.isfinite(model(x, gat_impl=impl)).all()
    # sep_fast in float64: the payloads still round to bf16, held in float64
    p = tgat.GATParams(*(torch.rand(s, dtype=torch.float64) for s in ((8, 8), (2, 4), (2, 4))))
    xx = torch.rand((1, 10, 8), dtype=torch.float64)
    out = gat_conv_sep(p, build_topology(5), xx, 2, fast=True)
    assert out.dtype == torch.float64
    assert not torch.equal(out, gat_conv_sep(p, build_topology(5), xx, 2))
