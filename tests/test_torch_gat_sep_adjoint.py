"""The sorted-prefix route's adjoint (ops/gat_sep.py, `sep` and `sep_fast`).

The reads at rank are one autograd Function (`_AtRank`) whose adjoint,
`rank_sums`, sums each rank's cotangents in increasing target order: on the
card a kernel (csrc/rank_sums.cu, held to its twin in test_torch_cuda.py),
on the CPU its twin, torch's scatter-add, which adds in that order.
Autograd's own adjoint of the gathers is that scatter-add, which on CUDA
accumulates with atomics in no fixed order.  Held here on the CPU against
the gather formulation as autograd differentiates it, kept below as the
reference (`_reference_at_rank`), at B=2, n=8, H=2, F=4:

* the forward equal bit for bit, in float32 and float64, both payload modes;
* in float64 every gradient leaf within 1e-12 of its scale;
* torch.autograd.gradcheck in float64, of the Function alone and of the
  route's partials;
* the cases put many targets on one rank and use the ranks 0 and K (no
  target above, or none below, the threshold), asserted on the data;
* the twin's summation order, which the kernel reproduces.
"""

import numpy as np
import pytest
import torch

from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig
from gnngls_tpu_torch.ops import gat as tgat
from gnngls_tpu_torch.ops import gat_sep
from gnngls_tpu_torch.ops.gat_group import merge_group_partials

B, N, H, F = 2, 8, 2, 4
K = N - 1
GRAD_TOL = 1e-12  # float64, of each leaf's largest value


def _reference_at_rank(s, sh, idx):
    """The reads at rank as gathers, differentiated by autograd."""
    return s.gather(-2, idx), sh.gather(-3, idx[..., None].expand(sh.shape))


def _params(seed, l_scale, r_scale, dtype):
    """GAT params and x with el spread by l_scale and er by r_scale: a wide
    er puts whole groups' thresholds past every el (ranks 0 and K), a
    narrow el packs the thresholds of many targets onto one rank."""
    rng = np.random.default_rng(seed)
    c = H * F
    w = rng.normal(size=(c, c)) / np.sqrt(c)
    al, ar = rng.normal(size=(H, F)) * l_scale, rng.normal(size=(H, F)) * r_scale
    x = rng.normal(size=(B, N * (N - 1) // 2, c))
    p = tgat.GATParams(*(torch.tensor(a, dtype=dtype) for a in (w, al, ar)))
    return p, torch.tensor(x, dtype=dtype)


CASES = [(0, 1.0, 1.0), (1, 0.05, 2.0), (2, 0.2, 0.6)]


def _ranks(p, x):
    """pos (B, n, K, H), as the route computes it."""
    topo = build_topology(N)
    h, el, er = tgat.project(p, x, H)
    city = torch.as_tensor(topo.city_edges)
    el_c, er_c = el[..., city, :], er[..., city, :]
    el_s = torch.sort(el_c, dim=-2).values
    return torch.searchsorted(el_s.transpose(-1, -2).contiguous(),
                              (-er_c).transpose(-1, -2).contiguous(),
                              right=True).transpose(-1, -2), el_c, er_c


def test_cases_share_ranks_and_reach_both_ends():
    """Across the cases: ranks 0 and K both occur, and some rank holds at
    least four targets of one group and head."""
    seen0 = seenK = False
    most = 0
    for seed, ls, rs in CASES:
        pos = _ranks(*_params(seed, ls, rs, torch.float64))[0]
        seen0 |= bool((pos == 0).any())
        seenK |= bool((pos == K).any())
        counts = torch.nn.functional.one_hot(pos, K + 1).sum(-3)  # (B, n, H, K+1)
        most = max(most, int(counts[..., 1:K].max()))
    assert seen0 and seenK and most >= 4


def _partials(p, x, fast, reference, monkeypatch):
    if reference:
        monkeypatch.setattr(gat_sep._AtRank, "apply", _reference_at_rank)
    try:
        return gat_sep.gat_conv_sep_partials(p, build_topology(N), x, H, fast)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_forward_unchanged_bit_for_bit(case, fast, dtype, monkeypatch):
    p, x = _params(*case, dtype)
    got = _partials(p, x, fast, False, monkeypatch)
    want = _partials(p, x, fast, True, monkeypatch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _conv_grads(p, x, fast, reference, monkeypatch):
    """Gradients of a seeded scalar of gat_conv_sep's output w.r.t. x and
    the three parameter leaves, float64."""
    leaves = [t.clone().requires_grad_(True) for t in (x, *p)]
    xg, pg = leaves[0], tgat.GATParams(*leaves[1:])
    if reference:
        monkeypatch.setattr(gat_sep._AtRank, "apply", _reference_at_rank)
    try:
        out = gat_sep.gat_conv_sep(pg, build_topology(N), xg, H, fast)
    finally:
        monkeypatch.undo()
    ct = torch.as_tensor(np.random.default_rng(7).normal(size=tuple(out.shape)),
                         dtype=out.dtype)
    return torch.autograd.grad((out * ct).sum(), leaves)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_the_gather_formulation(case, fast, monkeypatch):
    p, x = _params(*case, torch.float64)
    got = _conv_grads(p, x, fast, False, monkeypatch)
    want = _conv_grads(p, x, fast, True, monkeypatch)
    for name, a, b in zip(("x", "fc_w", "attn_l", "attn_r"), got, want):
        scale = float(b.abs().max())
        assert scale > 0, name
        assert float((a - b).abs().max()) <= GRAD_TOL * scale, name


@pytest.mark.parametrize("seed", [3, 4])
def test_at_rank_gradcheck(seed):
    """The Function alone, with whole groups at ranks 0 and K-1 and five
    targets on one rank."""
    rng = np.random.default_rng(seed)
    shape = (B, N, K, H)
    idx = torch.as_tensor(rng.integers(0, K, size=shape))
    idx[0, 0, :, 0] = 0
    idx[0, 1, :, 1] = K - 1
    idx[1, 2, :5, 0] = 3
    s = torch.tensor(rng.normal(size=shape), requires_grad=True)
    sh = torch.tensor(rng.normal(size=shape + (F,)), requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: gat_sep._AtRank.apply(a, b, idx), (s, sh))
    got = gat_sep._AtRank.apply(s, sh, idx)
    want = _reference_at_rank(s, sh, idx)
    ct = [torch.as_tensor(rng.normal(size=tuple(t.shape))) for t in want]
    g1 = torch.autograd.grad(sum((t * c).sum() for t, c in zip(got, ct)), (s, sh))
    g2 = torch.autograd.grad(sum((t * c).sum() for t, c in zip(want, ct)), (s, sh))
    for a, b in zip(g1, g2):
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())


def test_rank_sums_twin_adds_in_target_order():
    """The twin sums each rank's cotangents in increasing target order, the
    order csrc/rank_sums.cu adds in (values where the order shows in f32)."""
    rng = np.random.default_rng(5)
    shape = (3, 40, 2)
    idx = torch.as_tensor(np.minimum(rng.geometric(0.3, size=shape) - 1, 39))
    g = torch.as_tensor(rng.normal(size=shape) * 10.0 ** rng.integers(-4, 8, size=shape),
                        dtype=torch.float32)
    gh = torch.as_tensor(rng.normal(size=shape + (3,)) * 1e6, dtype=torch.float32)
    gs, gsh = gat_sep.rank_sums(idx, g, gh)
    want_s, want_h = torch.zeros_like(g), torch.zeros_like(gh)
    for r in range(shape[0]):
        for h in range(shape[2]):
            for i in range(shape[1]):  # increasing target order
                k = int(idx[r, i, h])
                want_s[r, k, h] = want_s[r, k, h] + g[r, i, h]
                want_h[r, k, h] = want_h[r, k, h] + gh[r, i, h]
    assert torch.equal(gs, want_s) and torch.equal(gsh, want_h)
    shuffled = torch.zeros_like(g).index_put_(  # another order gives other bits here
        (torch.arange(3)[:, None, None], idx.flip(1), torch.arange(2)), g.flip(1),
        accumulate=True)
    assert not torch.equal(shuffled, want_s)


def test_rank_sums_refuses_tensors_off_the_cpu_and_the_card():
    idx = torch.zeros((1, 4, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        gat_sep.rank_sums(idx, torch.zeros((1, 4, 2), device="meta"),
                          torch.zeros((1, 4, 2, 3), device="meta"))


@pytest.mark.parametrize("case", CASES[:2])
def test_route_partials_gradcheck(case):
    """float64 gradcheck of the partials w.r.t. x and the parameters, where
    no score lies within 1e-4 of the leaky kink: the finite differences'
    steps of 1e-6 move a score by about 1e-5, so they do not cross it."""
    p, x = _params(*case, torch.float64)
    _, el_c, er_c = _ranks(p, x)
    assert float((el_c[..., None, :, :] + er_c[..., :, None, :]).abs().min()) > 1e-4
    topo = build_topology(N)

    def f(xx, w, al, ar):
        m, z, num = gat_sep.gat_conv_sep_partials(tgat.GATParams(w, al, ar), topo, xx, H)
        return merge_group_partials(m, z, num, topo)

    leaves = [t.clone().requires_grad_(True) for t in (x, *p)]
    assert torch.autograd.gradcheck(f, leaves, eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("route", ["sep", "sep_fast"])
def test_model_gradients_match_the_gather_formulation(route, monkeypatch):
    """A train-mode RegretGNN (embed 8, 2 heads, depth 2) through the route,
    float64: every parameter's gradient within 1e-12 of its scale, or of the
    largest leaf's where its own is below 1e-4 of that (a bias before a
    BatchNorm has a gradient that vanishes in exact arithmetic)."""
    torch.manual_seed(0)
    model = RegretGNN(RegretGNNConfig(embed_dim=H * F, n_heads=H, n_layers=2,
                                      depth_from_heads=False)).double().train()
    for q in model.parameters():
        torch.nn.init.normal_(q, std=0.5)
    x = torch.as_tensor(np.random.default_rng(11).random((B, N * (N - 1) // 2, 1)))

    def grads(reference):
        model.zero_grad()
        if reference:
            monkeypatch.setattr(gat_sep._AtRank, "apply", _reference_at_rank)
        try:
            model(x, gat_impl=route).square().mean().backward()
        finally:
            monkeypatch.undo()
        return {k: q.grad.clone() for k, q in model.named_parameters()}

    got, want = grads(False), grads(True)
    top = max(float(g.abs().max()) for g in want.values())
    for k in want:
        scale = float(want[k].abs().max())
        bar = GRAD_TOL * (scale if scale >= 1e-4 * top else top)
        assert float((got[k] - want[k]).abs().max()) <= bar, k
