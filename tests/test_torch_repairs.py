"""Two faults of the port against gnngls_tpu, held repaired.

* `RegretGNN.forward` takes an unbatched x (E, in_dim), as JAX's `forward`
  and `gat_conv_pallas` do, for every route; the result matches JAX's
  forward on the same seed-made inputs within 2e-5 of the output scale (the
  sums run in another order), 2e-3 with bf16 payloads.
* `resolve_solver(n, None)` raises where gnngls_tpu would name "concorde" (a
  binary on PATH), until the exact solvers are ported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnngls_tpu.core.graph import build_topology as jtopology
from gnngls_tpu.models import regret_gat as JM
from gnngls_tpu.train import checkpoint as jck
from gnngls_tpu_torch.data import generate as tgen
from gnngls_tpu_torch.models.convert import state_from_jax_numpy
from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jcfg = JM.RegretGNNConfig(embed_dim=16, n_heads=2)
    params, bn = JM.init_params(jax.random.PRNGKey(3), jcfg)
    blobs = {f"params::{k}": v for k, v in jck._flatten(params).items()}
    blobs.update({f"bn_state::{k}": v for k, v in jck._flatten(bn).items()})
    model = RegretGNN(RegretGNNConfig(embed_dim=16, n_heads=2))
    model.load_state_dict(state_from_jax_numpy(blobs), strict=True)
    return params, bn, model


# (port route, JAX route): "auto" is the group partials, which JAX's "pallas" runs
@pytest.mark.parametrize("port,jax_impl", [("auto", "pallas"), ("naive", "naive"),
                                           ("pallas_mxu", "pallas_mxu"),
                                           ("pallas_sep_fast", "pallas_sep_fast")])
def test_unbatched_forward_matches_jax(models, port, jax_impl):
    params, bn, model = models
    n = 10
    topo = jtopology(n)
    x = np.random.default_rng(5).random((topo.n_edges, 1)).astype(np.float32)
    fwd = jax.jit(lambda p, s, xx: JM.forward(p, s, topo, xx, n_heads=2, gat_impl=jax_impl)[0])
    want = np.asarray(fwd(params, bn, jnp.asarray(x)))
    taps = []
    with torch.no_grad():
        got = model(torch.as_tensor(x), taps=taps, gat_impl=port)
        batched = model(torch.as_tensor(x)[None], gat_impl=port)
    assert got.shape == want.shape == (topo.n_edges, 1)
    assert all(t.shape == (topo.n_edges, 16) for t in taps) and len(taps) == 3
    tol = 2e-3 if "fast" in port else 2e-5  # bf16 payloads: tests/test_torch_gat_sep.py
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))
    torch.testing.assert_close(got, batched[0], rtol=0, atol=0)


def test_resolve_solver_concorde_tier(monkeypatch):
    """A concorde binary on PATH takes every n, as in gnngls_tpu (the port's
    exact solvers are ported, so it no longer raises)."""
    from gnngls_tpu.data import generate as jgen
    from gnngls_tpu_torch.data import solvers as tsolvers

    monkeypatch.setattr(tsolvers.shutil, "which",
                        lambda name: "/usr/local/bin/concorde" if name == "concorde" else None)
    assert tgen.resolve_solver(150, None) == jgen.resolve_solver(150, None) == "concorde"
    assert tgen.resolve_solver(10, None) == jgen.resolve_solver(10, None) == "concorde"
    assert tgen.resolve_solver(150, "gls") == "gls"
    monkeypatch.setattr(tsolvers.shutil, "which", lambda name: None)
    assert tgen.resolve_solver(150, None) == "gls"
