"""K3, the source-chunked GAT partials: the port's plain twin and conv
against gnngls_tpu.

The JAX side runs `_group_partials_chunked` and `gat_conv_pallas(src_chunk=..)`
as its own tests run them on the CPU, in Pallas interpret mode.  The port's
m and z are (B, n, g, H); JAX's are lane-replicated (B, n, g, H*F), so every
F-th lane is compared.  Tolerances: 1e-5 of the largest JAX value for the
partials, 2e-5 of the output scale for the conv (as tests/test_torch_gat.py
holds K2's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.core.graph import build_topology as jtopology
from gnngls_tpu.ops import gat as jgat
from gnngls_tpu.ops import pallas_gat as jpallas
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.ops import gat as tgat
from gnngls_tpu_torch.ops.gat_group import (gat_conv_group, gat_group_partials_chunked,
                                            gat_group_partials_chunked_plain,
                                            gat_group_partials_plain, source_chunk)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _projected(n, H, F, B, seed, spread):
    """Seeded el, er (B, E, H) and h (B, E, H, F), f32 numpy."""
    rng = np.random.default_rng(seed)
    E = n * (n - 1) // 2
    el, er = (spread * rng.standard_normal((B, E, H)).astype(np.float32) for _ in range(2))
    h = rng.standard_normal((B, E, H, F)).astype(np.float32)
    return el, er, h


def _jax_chunked(el, er, h, n, gs):
    """JAX's K3 on the port's inputs, gathered, padded and lane-replicated
    as gat_conv_pallas does it (pallas_gat.py:212-257)."""
    B, E, H, F = h.shape
    city = jnp.asarray(jtopology(n).city_edges)
    rep = lambda a: jnp.repeat(jnp.asarray(a), F, axis=-1)[:, city]  # noqa: E731
    el_rep, er_rep = rep(el), rep(er)
    hc = jnp.asarray(h).reshape(B, E, H * F)[:, city]
    g = n - 1
    gp = -(-g // gs) * gs
    el_rep = jnp.pad(el_rep, ((0, 0), (0, 0), (0, gp - g), (0, 0)), constant_values=-3.0e38)
    hc = jnp.pad(hc, ((0, 0), (0, 0), (0, gp - g), (0, 0)))
    return (np.asarray(a) for a in jpallas._group_partials_chunked(
        el_rep, er_rep, hc, gs, interpret=True))


# (18, 4, 8, 8): g=17, so the last chunk holds one real source; for target 16
# that source is the target itself.
@pytest.mark.parametrize("n,H,F,gs", [(20, 2, 8, 8), (17, 4, 8, 8), (30, 8, 16, 16),
                                      (18, 4, 8, 8)])
def test_chunked_partials_match_jax_kernel(n, H, F, gs):
    B = 2
    el, er, h = _projected(n, H, F, B, n + gs, 3.0)
    m_j, z_j, num_j = _jax_chunked(el, er, h, n, gs)
    city = torch.as_tensor(build_topology(n).city_edges)
    m, z, num = gat_group_partials_chunked(torch.as_tensor(el), torch.as_tensor(er),
                                           torch.as_tensor(h), city, gs)
    g = n - 1
    assert m.shape == z.shape == (B, n, g, H) and num.shape == (B, n, g, H, F)
    for mine, theirs in ((m, m_j[..., ::F]), (z, z_j[..., ::F]),
                         (num.reshape(B, n, g, H * F), num_j)):
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=1e-5 * np.abs(theirs).max())


def test_chunked_partials_merge_to_the_one_shot_softmax():
    """Chunked and one-shot partials differ in m (chunk maxima are merged),
    but give the same softmax once z and num are divided out."""
    n, H, F, gs = 18, 4, 8, 8
    el, er, h = (torch.as_tensor(a) for a in _projected(n, H, F, 2, 5, 10.0))
    city = torch.as_tensor(build_topology(n).city_edges)
    m1, z1, n1 = gat_group_partials_plain(el, er, h, city)
    m2, z2, n2 = gat_group_partials_chunked_plain(el, er, h, city, gs)
    torch.testing.assert_close(m2, m1, rtol=0, atol=0)
    torch.testing.assert_close(n2 / z2[..., None], n1 / z1[..., None], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,spread", [(12, 1.0), (20, 10.0)])
def test_chunked_conv_matches_jax(n, spread):
    H, F, B = 4, 8, 2
    rng = np.random.default_rng(n)
    c = H * F
    E = n * (n - 1) // 2
    w = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
    al, ar = (rng.standard_normal((H, F)).astype(np.float32) for _ in range(2))
    x = (spread * rng.standard_normal((B, E, c))).astype(np.float32)
    jp = jgat.GATParams(jnp.asarray(w), jnp.asarray(al), jnp.asarray(ar))
    tp = tgat.GATParams(torch.as_tensor(w), torch.as_tensor(al), torch.as_tensor(ar))
    want = np.asarray(jpallas.gat_conv_pallas(jp, jtopology(n), jnp.asarray(x), H,
                                              interpret=True, src_chunk=8))
    got = gat_conv_group(tp, build_topology(n), torch.as_tensor(x), H, src_chunk=8).numpy()
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)


def test_source_chunk_rule():
    """gnngls_tpu's rule at the shipped width HF=128: one-shot through n=111."""
    assert all(source_chunk(n, 128) == 0 for n in (3, 20, 100, 111))
    assert source_chunk(112, 128) > 0
    assert (source_chunk(120, 128), source_chunk(200, 128), source_chunk(500, 128)) == \
        (64, 40, 16)


def test_chunked_wrapper_input_checks():
    tt = build_topology(5)
    el = torch.zeros((1, 10, 2))
    h = torch.zeros((1, 10, 2, 8))
    city = torch.as_tensor(tt.city_edges)
    with pytest.raises(ValueError):
        gat_group_partials_chunked(el, el, h, city, 0)
    with pytest.raises(TypeError):
        gat_group_partials_chunked(el, el, h, city.long(), 4)
    with pytest.raises(ValueError):  # not a CUDA device: no kernel, no twin
        gat_group_partials_chunked(el.to("meta"), el.to("meta"), h.to("meta"),
                                   city.to("meta"), 4)
