"""The sorted-prefix GAT partials (ops/gat_sorted.py), through the routes of
K3 and K5, against gnngls_tpu on the CPU.

On the CPU `gat_group_partials_chunked` and `gat_sep_partials` run the plain
twin of csrc/gat_sorted.cu.  They are held against JAX's K3
(`_group_partials_chunked`), K5 (`gat_conv_pallas_sep_partials`, both payload
modes), both in Pallas interpret mode as the JAX package's own tests run
them, and JAX's sorted-prefix `gat_conv_sep_partials`.

Every case feeds both packages the same el, er and h: the projection is the
identity and each head's attention vectors pick one feature (el = h_0,
er = h_1), so JAX's and the port's projections are exact and equal.  That
lets the cases set el and er directly: the smallest group (n=3), K not a
power of two, a 10x logit spread, tied maxima, groups whose maximum stands
about 60 above the rest (the row i = j*, computed directly), and thresholds
that equal an el exactly (el_j + er_i = 0 goes to the negative branch, for
a target's own term too).

Tolerances: m exactly equal (leaky and rounding are monotone, so the row max
is the same float); z and num within 1e-5 of the largest JAX value with f32
payloads (the same terms, summed in another order); with bf16 payloads
within 1e-4 of the scale of JAX's K5 (tests/test_torch_gat_sep.py's BF16
bar), which rounds the payloads as the port does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.core.graph import build_topology as jtopology
from gnngls_tpu.ops import gat as jgat
from gnngls_tpu.ops import gat_sep as jgsep
from gnngls_tpu.ops import pallas_gat as jpallas
from gnngls_tpu.ops import pallas_gat_sep as jpsep
from gnngls_tpu_torch import kernels
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.ops import gat as tgat
from gnngls_tpu_torch.ops.gat_group import (gat_conv_group, gat_group_partials_chunked,
                                            gat_group_partials_chunked_plain)
from gnngls_tpu_torch.ops.gat_group_sep import (gat_conv_group_sep, gat_sep_partials,
                                                gat_sep_partials_plain)
from gnngls_tpu_torch.ops.gat_sorted import gat_sorted_partials, gat_sorted_partials_plain

F32, BF16 = 1e-5, 1e-4
GS = 4  # K3's source chunk in these cases: several chunks, the last one ragged


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(kind, n, H, F, B=2):
    """Seeded h (B, E, H, F) f32 whose features 0 and 1 are el and er."""
    rng = np.random.default_rng(n * 31 + H)
    E = n * (n - 1) // 2
    h = rng.standard_normal((B, E, H, F)).astype(np.float32)
    el, er = h[..., 0], h[..., 1]
    if kind == "spread10":
        el *= 10
        er *= 10
    elif kind == "tied":  # every group's maximum ties: el is constant
        el[:] = 0.25
    elif kind == "gap60":  # the edges (0,1), (2,3), ...: each group's max stands ~60 above
        city = build_topology(n).city_edges
        for u in range(0, n - 1, 2):
            el[:, np.intersect1d(city[u], city[u + 1])[0]] += 60.0
    elif kind == "threshold":
        city = build_topology(n).city_edges
        er[:, ::3] = -el[:, ::3]  # a target's own el_i + er_i = 0
        # within group 0, targets whose threshold -er_i equals another source's el
        er[:, city[0, 1::2]] = -el[:, city[0, 2::2][:len(city[0, 1::2])]]
    return h


def _both(h):
    """The params and x that project to exactly h in both packages, and
    (el, er, h) as numpy."""
    B, E, H, F = h.shape
    c = H * F
    w = np.eye(c, dtype=np.float32)
    al = np.zeros((H, F), np.float32)
    ar = np.zeros((H, F), np.float32)
    al[:, 0] = 1.0
    ar[:, 1] = 1.0
    x = h.reshape(B, E, c)
    jp = jgat.GATParams(jnp.asarray(w), jnp.asarray(al), jnp.asarray(ar))
    tp = tgat.GATParams(torch.as_tensor(w), torch.as_tensor(al), torch.as_tensor(ar))
    return jp, tp, x, (h[..., 0].copy(), h[..., 1].copy(), h)


CASES = [("random", 3, 2, 8), ("random", 12, 4, 8), ("spread10", 20, 8, 16),
         ("tied", 9, 2, 8), ("gap60", 16, 2, 8), ("threshold", 10, 2, 8)]
IDS = [f"{k}-n{n}" for k, n, _, _ in CASES]


def _port_args(el, er, h, n):
    city = torch.as_tensor(build_topology(n).city_edges, dtype=torch.int32)
    return torch.as_tensor(el), torch.as_tensor(er), torch.as_tensor(h), city


def _close(mine, theirs, rel, scale_floor=0.0):
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(np.asarray(mine), theirs, rtol=0,
                               atol=rel * max(scale_floor, np.abs(theirs).max()))


def test_cases_project_exactly():
    """Both projections give h, el = h_0 and er = h_1 bit for bit."""
    h = _inputs("threshold", 10, 2, 8)
    jp, tp, x, (el, er, _) = _both(h)
    hj, elj, erj = jgat._project(jp, jnp.asarray(x), 2)
    ht, elt, ert = tgat.project(tp, torch.as_tensor(x), 2)
    for a, b, want in ((hj, ht, h), (elj, elt, el), (erj, ert, er)):
        assert np.array_equal(np.asarray(a), want) and np.array_equal(b.numpy(), want)


@pytest.mark.parametrize("kind,n,H,F", CASES, ids=IDS)
def test_k3_route_matches_jax_k3(kind, n, H, F):
    _, _, _, (el, er, h) = _both(_inputs(kind, n, H, F))
    B = h.shape[0]
    city = jnp.asarray(jtopology(n).city_edges)
    rep = lambda a: jnp.repeat(jnp.asarray(a), F, axis=-1)[:, city]  # noqa: E731
    hc = jnp.asarray(h).reshape(B, -1, H * F)[:, city]
    gp = -(-(n - 1) // GS) * GS
    pad = ((0, 0), (0, 0), (0, gp - (n - 1)), (0, 0))
    m_j, z_j, num_j = (np.asarray(a) for a in jpallas._group_partials_chunked(
        jnp.pad(rep(el), pad, constant_values=-3.0e38), rep(er), jnp.pad(hc, pad), GS,
        interpret=True))
    m, z, num = gat_group_partials_chunked(*_port_args(el, er, h, n), GS)
    assert np.array_equal(m.numpy(), m_j[..., ::F])
    _close(z, z_j[..., ::F], F32)
    _close(num.reshape(num_j.shape), num_j, F32)


@pytest.mark.parametrize("kind,n,H,F", CASES, ids=IDS)
def test_k5_route_matches_jax_k5(kind, n, H, F):
    jp, _, x, (el, er, h) = _both(_inputs(kind, n, H, F))
    topo = jtopology(n)
    both = jax.jit(lambda p, xx: [jpsep.gat_conv_pallas_sep_partials(
        p, topo, xx, H, fast=fast, interpret=True) for fast in (False, True)])
    for fast, (m_j, z_j, num_j) in zip((False, True), both(jp, jnp.asarray(x))):
        m, z, num = gat_sep_partials(*_port_args(el, er, h, n), fast)
        assert np.array_equal(m.numpy(), np.asarray(m_j))
        _close(z, z_j, F32)
        if fast:
            _close(num, num_j, BF16, scale_floor=1.0)
        else:
            _close(num, num_j, F32)


@pytest.mark.parametrize("kind,n,H,F", CASES, ids=IDS)
def test_sorted_partials_match_jax_gat_sep(kind, n, H, F):
    jp, _, x, (el, er, h) = _both(_inputs(kind, n, H, F))
    m_j, z_j, num_j = jax.jit(lambda p, xx: jgsep.gat_conv_sep_partials(
        p, jtopology(n), xx, H))(jp, jnp.asarray(x))
    args = _port_args(el, er, h, n)
    for m, z, num in (gat_sep_partials(*args), gat_group_partials_chunked(*args, GS)):
        assert np.array_equal(m.numpy(), np.asarray(m_j))
        _close(z, z_j, F32)
        _close(num, num_j, F32)


@pytest.mark.parametrize("kind,n,H,F", [c for c in CASES if c[0] in ("gap60", "threshold")],
                         ids=["gap60", "threshold"])
def test_convs_match_jax(kind, n, H, F):
    """The two routes' convs, the two groups of each edge merged, against
    JAX's convs on the cases that reach the row j* and the thresholds."""
    jp, tp, x, _ = _both(_inputs(kind, n, H, F))
    topo, tt = jtopology(n), build_topology(n)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    want = np.asarray(jpallas.gat_conv_pallas(jp, topo, xj, H, interpret=True, src_chunk=GS))
    _close(gat_conv_group(tp, tt, xt, H, src_chunk=GS), want, 2e-5, scale_floor=1.0)
    for fast in (False, True):
        want = np.asarray(jpsep.gat_conv_pallas_sep(jp, topo, xj, H, fast=fast,
                                                    interpret=True))
        _close(gat_conv_group_sep(tp, tt, xt, H, fast=fast), want, BF16 if fast else 2e-5,
               scale_floor=1.0)


@pytest.mark.parametrize("kind,n,H,F", CASES, ids=IDS)
def test_twin_matches_the_tpu_kernels_twins(kind, n, H, F):
    """The new twin against the plain arithmetic of K3 and K5, which the card
    holds the kernel against too."""
    args = _port_args(*_both(_inputs(kind, n, H, F))[3], n)
    k3 = gat_group_partials_chunked_plain(*args, GS)
    for fast in (False, True):
        mine = gat_sorted_partials_plain(*args, fast)
        refs = [gat_sep_partials_plain(*args, fast)] + ([] if fast else [k3])
        for ref in refs:
            assert torch.equal(mine[0], ref[0])
            for a, b in zip(mine[1:], ref[1:]):
                assert bool(torch.isfinite(a).all())
                assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_twin_city_blocks_do_not_change_the_result(monkeypatch):
    from gnngls_tpu_torch.ops import gat_sorted

    args = _port_args(*_both(_inputs("spread10", 11, 2, 8))[3], 11)
    for fast in (False, True):
        whole = gat_sorted_partials_plain(*args, fast)
        monkeypatch.setattr(gat_sorted, "_BLOCK_ELEMENTS", 2 * 3 * 10 * 2 * 8)  # 3 cities
        blocks = gat_sorted_partials_plain(*args, fast)
        monkeypatch.undo()
        for a, b in zip(blocks, whole):
            assert torch.equal(a, b)


def test_launch_counters_name_the_route():
    """On the CPU nothing launches and nothing is counted; the wrappers check
    their inputs before they pick the twin or the card."""
    before = dict(kernels.launches)
    args = _port_args(*_both(_inputs("random", 5, 1, 8))[3], 5)
    gat_sorted_partials(*args)
    gat_group_partials_chunked(*args, 1)
    gat_sep_partials(*args, True)
    assert dict(kernels.launches) == before
    el, er, h, city = args
    with pytest.raises(TypeError):
        gat_sorted_partials(el, er, h, city.long())
    with pytest.raises(ValueError):  # not a CUDA device: no kernel, no twin
        gat_sorted_partials(el.to("meta"), er.to("meta"), h.to("meta"), city.to("meta"))
