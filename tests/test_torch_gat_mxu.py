"""K4, the per-head matmul GAT partials: the port's plain twin, its route and
the `gat_impl` selector against gnngls_tpu.

The JAX side runs `_group_partials_mxu` and `gat_conv_pallas(mxu=True)` as its
own tests run them on the CPU, in Pallas interpret mode.  The port's m and z
are (B, n, g, H); JAX's are lane-replicated (B, n, g, H*F), so every F-th lane
is compared.  Tolerances: the maxima are the same f32 values, so m is held
exactly; z and num to 1e-5 of the largest JAX value (the sums run in another
order); the conv to 2e-5 of the output scale, as tests/test_torch_gat.py holds
K2's; the shipped model's taps to benchmarks/PARITY.md's 5e-4.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.core.graph import build_topology as jtopology
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.ops import gat as jgat
from gnngls_tpu.ops import pallas_gat as jpallas
from gnngls_tpu.ops import pallas_gat_sep as jpsep
from gnngls_tpu.ops.linear import linear as jlinear
from gnngls_tpu.ops.norm import batch_norm as jbatch_norm
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu_torch import kernels
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.data.dataset import TSPDataset
from gnngls_tpu_torch.models.convert import load_model
from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig
from gnngls_tpu_torch.ops import gat as tgat
from gnngls_tpu_torch.ops.gat_group import (gat_conv_group, gat_group_partials_mxu,
                                            gat_group_partials_mxu_plain,
                                            gat_group_partials_plain, source_chunk)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(n, H, F, B, seed, spread):
    """Seeded projection weights and x (B, E, H*F), f32 numpy."""
    rng = np.random.default_rng(seed)
    c = H * F
    w = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
    al, ar = (rng.standard_normal((H, F)).astype(np.float32) for _ in range(2))
    x = (spread * rng.standard_normal((B, n * (n - 1) // 2, c))).astype(np.float32)
    return (w, al, ar), x


@pytest.mark.parametrize("n,H,F,spread", [(10, 4, 8, 3.0), (16, 2, 8, 10.0), (12, 8, 16, 1.0)])
def test_mxu_partials_match_jax_kernel(n, H, F, spread):
    B = 2
    rng = np.random.default_rng(n)
    E = n * (n - 1) // 2
    el, er = (spread * rng.standard_normal((B, E, H)).astype(np.float32) for _ in range(2))
    h = rng.standard_normal((B, E, H, F)).astype(np.float32)
    city = jnp.asarray(jtopology(n).city_edges)
    m_j, z_j, num_j = (np.asarray(a) for a in jpallas._group_partials_mxu(
        jnp.asarray(el)[:, city], jnp.asarray(er)[:, city],
        jnp.asarray(h).reshape(B, E, H * F)[:, city], interpret=True))
    m, z, num = gat_group_partials_mxu(torch.as_tensor(el), torch.as_tensor(er),
                                       torch.as_tensor(h), torch.as_tensor(build_topology(n).city_edges))
    g = n - 1
    assert m.shape == z.shape == (B, n, g, H) and num.shape == (B, n, g, H, F)
    np.testing.assert_array_equal(m.numpy(), m_j[..., ::F])
    for mine, theirs in ((z, z_j[..., ::F]), (num.reshape(B, n, g, H * F), num_j)):
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=1e-5 * np.abs(theirs).max())


def _tf32(x):
    """cvt.rna.tf32.f32: the low 13 mantissa bits rounded away, to nearest
    with ties away from zero."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulate_k4(el, er, h, city, split=True):
    """csrc/gat_group_mxu.cu's per-group arithmetic in numpy: el, er (B, E, H)
    and h (B, E, H, F) f32, city (n, g) -> m, z (B, n, g, H), num (B, n, g, H, F).

    m from el's two largest values (the top one, or the second where the top
    sits at the target); p = exp(leaky(el_j + er_i) - m_i), 0 at the self pair
    and the padded sources; z as a quad of lanes sums it (lane t the sources
    k0+t and k0+t+4 of each 8-source step, then (t0+t1)+(t2+t3)); num as
    mma.sync accumulates it step by step, each product exact and each step
    rounded to f32 once, in 3xTF32 (small*big, big*small, big*big) or, with
    split=False, one TF32 product."""
    f32, f64 = np.float32, np.float64
    g = city.shape[1]
    gp = -(-g // 8) * 8
    el_c, er_c = (a[:, city].transpose(0, 1, 3, 2) for a in (el, er))  # (B, n, H, g)
    h_c = h[:, city].transpose(0, 1, 3, 2, 4)  # (B, n, H, g, F)
    leaky = lambda s: np.maximum(s, f32(0.2) * s)  # noqa: E731
    srt = np.sort(el_c, axis=-1)
    t1, t2 = srt[..., -1:], srt[..., -2:-1]
    ti = np.argmax(el_c, axis=-1)[..., None]
    i = np.arange(g)
    m = leaky(np.where(i == ti, t2, t1) + er_c)
    p = np.exp(leaky(el_c[..., None, :] + er_c[..., :, None]) - m[..., None]).astype(f32)
    p[..., i, i] = 0
    p = np.pad(p, [(0, 0)] * 4 + [(0, gp - g)])
    hp = np.pad(h_c, [(0, 0)] * 3 + [(0, gp - g), (0, 0)])
    part = np.zeros(p.shape[:-1] + (4,), f32)
    acc = np.zeros(p.shape[:-1] + (h.shape[-1],), f32)
    for k0 in range(0, gp, 8):
        for t in range(4):
            part[..., t] += p[..., k0 + t]
            part[..., t] += p[..., k0 + t + 4]
        a, b = p[..., k0:k0 + 8], hp[..., k0:k0 + 8, :]
        if split:
            a_big, b_big = _tf32(a), _tf32(b)
            terms = ((_tf32(a - a_big), b_big), (a_big, _tf32(b - b_big)), (a_big, b_big))
        else:
            terms = ((_tf32(a), _tf32(b)),)
        for x, y in terms:
            acc = (acc.astype(f64) + np.matmul(x.astype(f64), y.astype(f64))).astype(f32)
    z = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    return m.transpose(0, 1, 3, 2), z.transpose(0, 1, 3, 2), acc.transpose(0, 1, 3, 2, 4)


def _jax_mxu_partials(n, H, F, spread):
    """test_mxu_partials_match_jax_kernel's inputs and JAX's K4 on them."""
    B = 2
    rng = np.random.default_rng(n)
    E = n * (n - 1) // 2
    el, er = (spread * rng.standard_normal((B, E, H)).astype(np.float32) for _ in range(2))
    h = rng.standard_normal((B, E, H, F)).astype(np.float32)
    city = jtopology(n).city_edges
    jc = jnp.asarray(city)
    out = jpallas._group_partials_mxu(jnp.asarray(el)[:, jc], jnp.asarray(er)[:, jc],
                                      jnp.asarray(h).reshape(B, E, H * F)[:, jc],
                                      interpret=True)
    m_j, z_j, num_j = (np.asarray(a) for a in out)
    return (el, er, h, city), (m_j[..., ::F], z_j[..., ::F], num_j.reshape(B, n, n - 1, H, F))


@pytest.mark.parametrize("n,H,F,spread", [(10, 4, 8, 3.0), (16, 2, 8, 10.0), (12, 8, 16, 1.0)])
def test_kernel_arithmetic_matches_jax_kernel(n, H, F, spread):
    """The CUDA kernel's arithmetic (3xTF32 products, z in quad order, m by
    the top-2 identity) against JAX's K4: m bit-equal, z and num within 1e-5
    of the largest JAX value, the bar the kernel is held to on the card."""
    args, (m_j, z_j, num_j) = _jax_mxu_partials(n, H, F, spread)
    m, z, num = _emulate_k4(*args)
    np.testing.assert_array_equal(m, m_j)
    for mine, theirs in ((z, z_j), (num, num_j)):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-5 * np.abs(theirs).max())


@pytest.mark.parametrize("n,H,F,spread", [(10, 4, 8, 3.0), (16, 2, 8, 10.0), (12, 8, 16, 1.0)])
def test_one_tf32_product_misses_the_bar(n, H, F, spread):
    """Why the kernel splits its operands: with one TF32 product (10 mantissa
    bits) num misses 1e-5 of the largest JAX value on the same inputs."""
    args, (_, _, num_j) = _jax_mxu_partials(n, H, F, spread)
    num = _emulate_k4(*args, split=False)[2]
    assert np.abs(num - num_j).max() > 1e-5 * np.abs(num_j).max()


def _edge_inputs(case):
    """Inputs where the kernel's shortcuts could go wrong."""
    n, H, F = {"n3": (3, 2, 8), "ties": (14, 4, 16), "spread40": (20, 8, 16)}[case]
    rng = np.random.default_rng(len(case))
    E = n * (n - 1) // 2
    el, er = (rng.standard_normal((2, E, H)).astype(np.float32) for _ in range(2))
    if case == "ties":  # four values only: maxima repeat, and some sit at the target
        el = np.round(rng.random((2, E, H)) * 3).astype(np.float32)
    if case == "spread40":  # most p underflow to 0
        el, er = 40 * el, 40 * er
    h = rng.standard_normal((2, E, H, F)).astype(np.float32)
    return el, er, h, build_topology(n).city_edges


@pytest.mark.parametrize("case", ["n3", "ties", "spread40"])
def test_kernel_arithmetic_matches_the_twin(case):
    """The emulation against the plain twin on the CPU: n=3 (one source a
    target, one mostly padded tile), tied maxima (the top value repeated,
    and unique at some targets), a spread of 40."""
    el, er, h, city = _edge_inputs(case)
    want = [a.numpy() for a in gat_group_partials_mxu_plain(
        torch.as_tensor(el), torch.as_tensor(er), torch.as_tensor(h), torch.as_tensor(city))]
    m, z, num = _emulate_k4(el, er, h, city)
    np.testing.assert_array_equal(m, want[0])
    for mine, theirs in ((z, want[1]), (num, want[2])):
        assert np.isfinite(mine).all()
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-5 * np.abs(theirs).max())


def test_mxu_twin_equals_k2_twin():
    """K4's partials are K2's: the same maxima, z and num to f32 rounding."""
    n, H, F = 14, 4, 8
    rng = np.random.default_rng(3)
    E = n * (n - 1) // 2
    el, er = (torch.as_tensor(5 * rng.standard_normal((2, E, H)), dtype=torch.float32)
              for _ in range(2))
    h = torch.as_tensor(rng.standard_normal((2, E, H, F)), dtype=torch.float32)
    city = torch.as_tensor(build_topology(n).city_edges)
    got = gat_group_partials_mxu_plain(el, er, h, city)
    want = gat_group_partials_plain(el, er, h, city)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("n", [10, 16])
def test_mxu_conv_matches_jax(n):
    H, F = 4, 8
    (w, al, ar), x = _params(n, H, F, 2, n, 3.0)
    jp = jgat.GATParams(jnp.asarray(w), jnp.asarray(al), jnp.asarray(ar))
    tp = tgat.GATParams(torch.as_tensor(w), torch.as_tensor(al), torch.as_tensor(ar))
    want = np.asarray(jpallas.gat_conv_pallas(jp, jtopology(n), jnp.asarray(x), H,
                                              interpret=True, mxu=True))
    got = gat_conv_group(tp, build_topology(n), torch.as_tensor(x), H, mxu=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * max(1.0, np.abs(want).max()))


def test_mxu_warns_and_takes_k3_past_the_one_shot_size():
    """At n=120 and H*F=128 gnngls_tpu's rule picks chunk 64: pallas_mxu warns
    and runs the source-chunked partials, as gat_conv_pallas does."""
    n, H, F = 120, 8, 16
    assert source_chunk(n, H * F) == 64
    (w, al, ar), x = _params(n, H, F, 1, 5, 1.0)
    tp = tgat.GATParams(torch.as_tensor(w), torch.as_tensor(al), torch.as_tensor(ar))
    topo = build_topology(n)
    with pytest.warns(UserWarning, match="source-chunked"):
        got = gat_conv_group(tp, topo, torch.as_tensor(x), H, mxu=True)
    want = gat_conv_group(tp, topo, torch.as_tensor(x), H)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mxu_with_an_explicit_chunk_raises():
    n, H, F = 10, 2, 8
    (w, al, ar), x = _params(n, H, F, 1, 1, 1.0)
    tp = tgat.GATParams(torch.as_tensor(w), torch.as_tensor(al), torch.as_tensor(ar))
    with pytest.raises(ValueError, match="src_chunk"):
        gat_conv_group(tp, build_topology(n), torch.as_tensor(x), H, src_chunk=8, mxu=True)


def test_mxu_wrapper_input_checks():
    city = torch.as_tensor(build_topology(5).city_edges)
    el = torch.zeros((1, 10, 2))
    with pytest.raises(TypeError):
        gat_group_partials_mxu(el, el, torch.zeros((1, 10, 2, 8)), city.long())
    with pytest.raises(ValueError):
        gat_group_partials_mxu(el, el, torch.zeros((1, 9, 2, 8)), city)
    with pytest.raises(ValueError):  # not a CUDA device: no kernel, no twin
        gat_group_partials_mxu(el.to("meta"), el.to("meta"), torch.zeros((1, 10, 2, 8),
                               device="meta"), city.to("meta"))
    # a launcher's report that the score tile does not fit becomes ValueError
    with pytest.raises(ValueError, match="shared memory"):
        kernels.check(kernels.SMEM_EXCEEDED, "gat_group_mxu_launch")


def _jax_taps(params, bn, x, n, conv):
    """JAX's layer stack with `conv` as the GATConv, jitted once for all 8
    layers (interpret mode compiles slowly): every tap and the output."""
    topo = jtopology(n)
    jconv = jax.jit(lambda p, h: conv(p, topo, h, 8))
    h = jlinear(params.embed, x)
    taps = [np.asarray(h)]
    for lp, ls in zip(params.layers, bn.layers):
        h = h + jconv(lp.gat, h)
        h, _ = jbatch_norm(lp.bn1, ls.bn1, h, False)
        h = h + jlinear(lp.ffn2, jax.nn.relu(jlinear(lp.ffn1, h)))
        h, _ = jbatch_norm(lp.bn2, ls.bn2, h, False)
        taps.append(np.asarray(h))
    return taps, np.asarray(jlinear(params.decision, h))


@pytest.mark.parametrize("gat_impl", ["pallas_mxu", "pallas_sep"])
def test_shipped_model_taps_match_jax(gat_impl):
    """The shipped tsp100 model on 2 tsp20 instances, every tap within 5e-4 of
    JAX's forward through the same Pallas kernel (interpret mode)."""
    root = ROOT / "data" / "tsp20"
    ds = TSPDataset.from_npz(root / "instances.npz", root / "test.txt",
                             scalers_file=ROOT / "models/tsp100/scalers.json")
    x = ds.get_scaled_batch([0, 1])["features"]
    cfg = JM.RegretGNNConfig()
    p_like, s_like = JM.init_params(jax.random.PRNGKey(0), cfg)
    path = ROOT / "models" / "tsp100" / "checkpoint_best_val.npz"
    params, bn, _, _ = jck.load_checkpoint(path, params_like=p_like, bn_state_like=s_like)
    if gat_impl == "pallas_mxu":
        def conv(p, t, h, nh):
            return jpallas.gat_conv_pallas(p, t, h, nh, interpret=True, mxu=True)
    else:
        def conv(p, t, h, nh):
            return jpsep.gat_conv_pallas_sep(p, t, h, nh, interpret=True)
    taps, y_j = _jax_taps(params, bn, jnp.asarray(x), ds.n_nodes, conv)
    model = load_model(path, RegretGNNConfig(), device="cpu")
    mine = []
    with torch.no_grad():
        y = model(torch.as_tensor(x), taps=mine, gat_impl=gat_impl).numpy()
    assert len(mine) == len(taps) == 9
    for i, (a, b) in enumerate(zip(mine, taps)):
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 5e-4, f"{gat_impl} tap {i} max abs err {err:.2e}"
    assert float(np.abs(y - y_j).max()) <= 5e-4
