"""K5, the threshold-mask separable GAT, and the sorted-prefix `sep` route:
the port's plain twins and the model's routes against gnngls_tpu.

The JAX side runs `gat_conv_pallas_sep[_partials]` as tests/test_pallas_gat_sep.py
runs it on the CPU (Pallas interpret mode, jitted here so that each shape
compiles once), `gat_conv_sep` and the naive oracle.  The cases are those of
tests/test_pallas_gat_sep.py: spreads 0.3 and 1.25 (the B_i envelope), the
shipped head count, tied maxima and a group chunk that does not divide n.

Tolerances.  f32 payloads: 1e-5 of the largest JAX value for the partials
and 2e-5 of the output scale for the conv (the projection and the sums run
in another order, so the same data differ at the rounding level), 3e-5 of
the scale against the naive oracle, as the JAX package's own tests hold it.
bf16 payloads against JAX's bf16 payloads: 1e-4 of the scale.  The port
rounds Ah = bf16(bf16(A) h) as the TPU kernel does, so the two differ only
by the f32 sums' order; the same data through f32 payloads differ from JAX's
bf16 ones by 1e-3 to 6e-3 of the scale, and every bf16 test asserts that its
f32 counterpart misses the bar, so a route that skipped the rounding fails.
bf16 payloads against an f32 reference (the naive oracle): 2e-3 of the scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.core.graph import build_topology as jtopology
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.ops import gat as jgat
from gnngls_tpu.ops import gat_sep as jgsep
from gnngls_tpu.ops import pallas_gat_sep as jpsep
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu_torch import kernels
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.models.convert import state_from_jax_numpy
from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig, gat_conv_for
from gnngls_tpu_torch.ops import gat as tgat
from gnngls_tpu_torch.ops import gat_group_sep as tsep
from gnngls_tpu_torch.ops.gat_group_sep import (gat_conv_group_sep, gat_sep_partials,
                                                gat_sep_partials_plain)
from gnngls_tpu_torch.ops.gat_sep import gat_conv_sep

F32_PARTIALS, F32_CONV, NAIVE, BF16, BF16_VS_F32 = 1e-5, 2e-5, 3e-5, 1e-4, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(n, H, F, scale, batch=(2,), const=False, seed=None):
    """Params drawn as tests/test_pallas_gat_sep.py draws them, and x; both
    packages' params and x."""
    rng = np.random.default_rng(n if seed is None else seed)
    c = H * F
    w, al, ar = (rng.normal(size=s) * scale for s in ((c, c), (H, F), (H, F)))
    E = n * (n - 1) // 2
    x = np.ones(batch + (E, c)) if const else rng.normal(size=batch + (E, c))
    w, al, ar, x = (np.asarray(a, np.float32) for a in (w, al, ar, x))
    jp = jgat.GATParams(jnp.asarray(w), jnp.asarray(al), jnp.asarray(ar))
    tp = tgat.GATParams(torch.as_tensor(w), torch.as_tensor(al), torch.as_tensor(ar))
    return jp, tp, x


def _port_partials(tp, n, H, x, fast):
    h, el, er = tgat.project(tp, torch.as_tensor(x), H)
    city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32)
    return gat_sep_partials(el, er, h, city, fast)


def _close(mine, theirs, rel):
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(np.asarray(mine), theirs, rtol=0,
                               atol=rel * max(1.0, np.abs(theirs).max()))


def _misses(f32, bf16_ref):
    """The f32-payload result lies farther than BF16 from the bf16-payload
    reference: the bar tells the two modes apart."""
    f32, bf16_ref = np.asarray(f32), np.asarray(bf16_ref)
    assert np.abs(f32 - bf16_ref).max() > BF16 * max(1.0, np.abs(bf16_ref).max())


KERNEL_CASES = [(12, 4, 8, 0.3), (9, 2, 8, 1.25), (10, 8, 16, 0.1)]


@pytest.mark.parametrize("n,H,F,scale", KERNEL_CASES)
def test_sep_partials_match_jax_kernel(n, H, F, scale):
    """Both payload modes against gat_conv_pallas_sep_partials, and the conv
    with f32 payloads against the naive oracle."""
    jp, tp, x = _case(n, H, F, scale)
    topo = jtopology(n)
    both = jax.jit(lambda p, xx: [jpsep.gat_conv_pallas_sep_partials(
        p, topo, xx, H, fast=fast, interpret=True) for fast in (False, True)])
    mine = {}
    for fast, parts in zip((False, True), both(jp, jnp.asarray(x))):
        m, z, mine[fast] = _port_partials(tp, n, H, x, fast)
        _close(m, parts[0], F32_PARTIALS)
        _close(z, parts[1], F32_PARTIALS)
        _close(mine[fast], parts[2], BF16 if fast else F32_PARTIALS)
    _misses(mine[False], parts[2])
    got = gat_conv_group_sep(tp, build_topology(n), torch.as_tensor(x), H)
    _close(got, jgat.gat_conv_naive(jp, topo, jnp.asarray(x), H), NAIVE)


def test_sep_tied_maxima_stay_finite():
    """Constant features tie every group maximum: the first argmax alone is
    masked for M2, so B and D stay finite (the JAX package's regression)."""
    n, H, F = 8, 2, 4
    jp, tp, x = _case(n, H, F, 0.3, batch=(1,), const=True, seed=7)
    ref = jgat.gat_conv_naive(jp, jtopology(n), jnp.asarray(x), H)
    for fast in (False, True):
        got = gat_conv_group_sep(tp, build_topology(n), torch.as_tensor(x), H, fast=fast)
        assert torch.isfinite(got).all()
        _close(got, ref, BF16_VS_F32 if fast else NAIVE)
        _, z, _ = _port_partials(tp, n, H, x, fast)
        assert torch.isfinite(z).all()


def test_sep_group_chunk_that_does_not_divide_n():
    """gnngls_tpu falls back to a divisor of n for gc=4 at n=7; the port has no
    grid to tile, so the name's @gc changes nothing."""
    n, H, F = 7, 2, 4
    jp, tp, x = _case(n, H, F, 0.3, batch=(1,), seed=1)
    topo = jtopology(n)
    want = jpsep.gat_conv_pallas_sep(jp, topo, jnp.asarray(x), H, group_chunk=4,
                                     interpret=True)
    conv = gat_conv_for("pallas_sep@4")
    _close(conv(tp, build_topology(n), torch.as_tensor(x), H), want, F32_CONV)


def test_twin_city_blocks_do_not_change_the_result(monkeypatch):
    n, H, F = 11, 4, 8
    _, tp, x = _case(n, H, F, 1.25)
    h, el, er = tgat.project(tp, torch.as_tensor(x), H)
    city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32)
    for fast in (False, True):
        whole = gat_sep_partials_plain(el, er, h, city, fast)
        monkeypatch.setattr(tsep, "_MASK_ELEMENTS", 3 * 2 * 10 * 10 * H)  # 3 cities a block
        blocks = gat_sep_partials_plain(el, er, h, city, fast)
        monkeypatch.undo()
        for a, b in zip(blocks, whole):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,H,F,batch", [(4, 1, 4, (2,)), (20, 8, 16, (1,)), (10, 4, 8, (3, 2))])
def test_sorted_prefix_sep_matches_jax(n, H, F, batch):
    jp, tp, x = _case(n, H, F, 0.3, batch=batch)
    topo, tt = jtopology(n), build_topology(n)
    both = jax.jit(lambda p, xx: [jgsep.gat_conv_sep(p, topo, xx, H, fast=fast)
                                  for fast in (False, True)])
    for fast, want in zip((False, True), both(jp, jnp.asarray(x))):
        got = gat_conv_sep(tp, tt, torch.as_tensor(x), H, fast=fast)
        assert got.shape == want.shape
        _close(got, want, BF16 if fast else F32_CONV)
    _misses(gat_conv_sep(tp, tt, torch.as_tensor(x), H), want)
    _close(gat_conv_sep(tp, tt, torch.as_tensor(x), H),
           jgat.gat_conv_naive(jp, topo, jnp.asarray(x), H), NAIVE)


def _small_models(n_heads=2, embed=16, seed=0):
    jcfg = JM.RegretGNNConfig(in_dim=1, embed_dim=embed, n_heads=n_heads, hidden_dim=32)
    params, bn = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    blobs = {f"params::{k}": v for k, v in jck._flatten(params).items()}
    blobs.update({f"bn_state::{k}": v for k, v in jck._flatten(bn).items()})
    model = RegretGNN(RegretGNNConfig(in_dim=1, embed_dim=embed, n_heads=n_heads,
                                      hidden_dim=32))
    model.load_state_dict(state_from_jax_numpy(blobs), strict=True)
    return jcfg, params, bn, model


@pytest.mark.parametrize("gat_impl", ["pallas_mxu", "pallas_sep", "pallas_sep_fast", "sep",
                                      "sep_fast"])
def test_model_forward_routes_match_jax(gat_impl):
    """The whole model (embed 16, 2 heads) through each route against JAX's
    forward with the same gat_impl."""
    jcfg, params, bn, model = _small_models()
    n = 8
    topo = jtopology(n)
    x = np.random.default_rng(1).random((2, topo.n_edges, 1)).astype(np.float32)
    fwd = jax.jit(lambda p, s, xx: JM.forward(p, s, topo, xx, n_heads=2, gat_impl=gat_impl)[0])
    want = np.asarray(fwd(params, bn, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.as_tensor(x), gat_impl=gat_impl).numpy()
        f32 = model(torch.as_tensor(x), gat_impl=gat_impl.replace("_fast", "")).numpy()
    if "fast" in gat_impl:
        _close(got, want, BF16)
        _misses(f32, want)
    else:
        _close(got, want, F32_CONV)


def test_route_names():
    for name in ("chunked", "bf16"):
        with pytest.raises(NotImplementedError, match="queue 5"):
            gat_conv_for(name)
    for name in ("pallas_sep@0", "pallas_sep@x", "pallas_sep@", "pallas_sepx", "Fast", "gat"):
        with pytest.raises(ValueError):
            gat_conv_for(name)
    for name in ("auto", "pallas", "pallas_mxu", "naive", "fast", "sep", "sep_fast",
                 "pallas_sep", "pallas_sep_fast", "pallas_sep_fast@10"):
        assert callable(gat_conv_for(name))
    model = RegretGNN(RegretGNNConfig(embed_dim=16, n_heads=2))
    with pytest.raises(ValueError, match="unknown gat_impl"):
        model(torch.zeros((1, 10, 1)), gat_impl="dense")


def test_sep_wrapper_input_checks():
    city = torch.as_tensor(build_topology(5).city_edges)
    el = torch.zeros((1, 10, 2))
    with pytest.raises(TypeError):
        gat_sep_partials(el, el, torch.zeros((1, 10, 2, 8)), city.long())
    with pytest.raises(TypeError):
        gat_sep_partials(el, el, torch.zeros((1, 10, 2, 8), dtype=torch.bfloat16), city)
    with pytest.raises(ValueError):  # not a CUDA device: no kernel, no twin
        gat_sep_partials(el.to("meta"), el.to("meta"), torch.zeros((1, 10, 2, 8),
                         device="meta"), city.to("meta"), True)
    # a launcher's report that the payloads do not fit becomes ValueError
    with pytest.raises(ValueError, match="shared memory"):
        kernels.check(kernels.SMEM_EXCEEDED, "gat_sep_launch")
