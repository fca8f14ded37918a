"""Data generation and preprocessing of the port against gnngls_tpu on the CPU:
the exact solvers, the native oracle, the solver rule, instance generation
(one shot and sharded, resumed across packages), the scaler, the split, the
TSPLIB writer and both data CLIs.

Tolerances: none where both packages run the same arithmetic (Held-Karp in
numpy, the native C++ oracle, the scaler, the split, the CLIs' files: equal,
byte for byte where they are files).  The GLS oracle at n=30 runs K1's twin
against JAX's XLA engine: the same cycles (a best tour may run the other way
where the search met one cycle in both directions at one cost), costs within
1e-6 relative (their f32 sums differ in order, ROADMAP section 3).
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

from gnngls_tpu.cli import generate_instances as jcli_gen
from gnngls_tpu.cli import preprocess_dataset as jcli_pre
from gnngls_tpu.core import scaler as jscaler
from gnngls_tpu.data import dataset as jds
from gnngls_tpu.data import generate as jgen
from gnngls_tpu.data import native_oracle as jnative
from gnngls_tpu.data import solvers as jsolvers
from gnngls_tpu_torch.cli import generate_instances as tcli_gen
from gnngls_tpu_torch.cli import preprocess_dataset as tcli_pre
from gnngls_tpu_torch.core import scaler as tscaler
from gnngls_tpu_torch.core.graph import build_topology
from gnngls_tpu_torch.data import dataset as tds
from gnngls_tpu_torch.data import generate as tgen
from gnngls_tpu_torch.data import native_oracle as tnative
from gnngls_tpu_torch.data import solvers as tsolvers

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU: keep torch to one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_D(n, seed):
    pos = np.random.default_rng(seed).random((n, 2))
    return np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)


@pytest.mark.parametrize("n", [5, 6, 7, 8])
def test_held_karp_equals_jax(n):
    D = rand_D(n, n)
    assert tsolvers.HELD_KARP_MAX_N == jsolvers.HELD_KARP_MAX_N
    assert tsolvers.held_karp(D) == jsolvers.held_karp(D)
    for e in map(tuple, build_topology(n).edges):
        assert tsolvers.held_karp_fixed_edge(D, e) == jsolvers.held_karp_fixed_edge(D, e)
    with pytest.raises(ValueError, match="held_karp limited"):
        tsolvers.held_karp(rand_D(17, 0))


def test_native_oracle_is_the_ports_own_build():
    assert tnative.build() and tnative.available()
    lib = pathlib.Path(tnative._load()._name)
    assert lib.parent == ROOT / "build" / "gnngls_tpu_torch" and "native" not in lib.parts
    assert "-march=native" not in tnative.CXX_FLAGS


@pytest.mark.parametrize("n", [6, 9, 12])
def test_native_oracle_equals_jax(n):
    """The port's build against the JAX package's library: same tours and
    costs, bit for bit, for every entry point."""
    assert jnative.available()
    D = rand_D(n, 100 + n)
    for fn in ("held_karp", "local_search"):
        t, c = getattr(tnative, fn)(D)
        jt, jc = getattr(jnative, fn)(D)
        np.testing.assert_array_equal(t, jt)
        assert c == jc
    for u, v in map(tuple, build_topology(n).edges[:: 7]):
        t, c = tnative.held_karp_fixed_edge(D, u, v)
        jt, jc = jnative.held_karp_fixed_edge(D, u, v)
        np.testing.assert_array_equal(t, jt)
        assert c == jc
    for max_exact in (16, 8):  # exact, then big-M local search past max_exact
        c, b = tnative.regret_costs(D, max_exact)
        jc, jb = jnative.regret_costs(D, max_exact)
        np.testing.assert_array_equal(c, jc)
        assert b == jb
    Ds = np.stack([D, rand_D(n, 7)])
    np.testing.assert_array_equal(tnative.regret_costs_batch(Ds, workers=2),
                                  jnative.regret_costs_batch(Ds, workers=2))


@pytest.mark.parametrize("concorde", [False, True])
def test_resolve_solver_follows_jax(monkeypatch, concorde):
    which = lambda name: "/usr/bin/" + name if concorde and name == "concorde" else None  # noqa: E731
    monkeypatch.setattr(tsolvers.shutil, "which", which)
    for n in (5, 16, 17, 22, 23, 100):
        assert tgen.resolve_solver(n) == jgen.resolve_solver(n)
        for name in ("gls", "held_karp", "concorde"):
            assert tgen.resolve_solver(n, name) == name
    assert tgen.resolve_solver(20) == ("concorde" if concorde else "held_karp")
    with pytest.raises(ValueError, match="unknown solver"):
        tgen.solve_instances(np.zeros((1, 5, 2), np.float32), "lkh")


def test_external_solvers_absent_raise_as_jax(tmp_path):
    coords = np.random.default_rng(0).random((6, 2)).astype(np.float32)
    assert tsolvers.has_concorde() == jsolvers.has_concorde() is False
    assert tsolvers.has_lkh() == jsolvers.has_lkh() is False
    for fn, args in (("concorde_tour", (coords,)), ("lkh_fixed_edge_tour", (coords, (0, 3)))):
        with pytest.raises(RuntimeError) as want:
            getattr(jsolvers, fn)(*args)
        with pytest.raises(RuntimeError, match=str(want.value)):
            getattr(tsolvers, fn)(*args)


@pytest.mark.parametrize("fixed", [None, (2, 4)])
def test_tsplib_writer_text_equals_jax(tmp_path, fixed):
    coords = np.random.default_rng(1).random((7, 2)).astype(np.float32)
    tsolvers._write_tsplib(tmp_path / "t.tsp", coords, 1e6, fixed_edge=fixed)
    jsolvers._write_tsplib(tmp_path / "j.tsp", coords, 1e6, fixed_edge=fixed)
    text = (tmp_path / "t.tsp").read_text()
    assert text == (tmp_path / "j.tsp").read_text()
    assert text.startswith("NAME: TSP\nTYPE: TSP\nDIMENSION: 7\n") and text.endswith("EOF\n")
    assert ("FIXED_EDGES_SECTION\n3 5\n-1\n" in text) == (fixed is not None)


@pytest.mark.parametrize("n,solver", [(8, None), (30, "gls")])
def test_generate_instances_equals_jax(n, solver):
    """n=8 resolves to Held-Karp (native): tours and costs equal; n=30 runs the
    GLS oracle (opt_iters 3)."""
    want = jgen.generate_instances(3, n, seed=4, solver=solver, opt_iters=3)
    got = tgen.generate_instances(3, n, seed=4, solver=solver, opt_iters=3, device="cpu")
    assert set(got) == set(want) and str(got["solver"]) == str(want["solver"])
    for key in ("coords", "opt_tour", "in_solution"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["opt_cost"], want["opt_cost"], rtol=0 if n == 8 else 1e-6)


@pytest.mark.parametrize("n,solver", [(8, None), (30, "gls")])
def test_generate_sharded_equals_and_resumes_jax(tmp_path, n, solver):
    """Shards of 4 over 6 instances: the same arrays and shard files (keys,
    meta) as gnngls_tpu's; each package resumes the other's directory, and a
    changed parameter is refused with the same message."""
    kw = dict(seed=3, solver=solver, opt_iters=3, chunk=4, batch=2, verbose=False)
    want = jgen.generate_instances_sharded(tmp_path / "j", 6, n, **kw)
    got = tgen.generate_instances_sharded(tmp_path / "t", 6, n, device="cpu", **kw)
    for key in want:
        if key == "opt_cost" and n == 30:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
        elif key != "opt_tour" or n == 8:  # GLS: the same cycles (in_solution),
            np.testing.assert_array_equal(got[key], want[key])  # perhaps run backwards
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == [
        "gen_00000000.npz", "gen_00000004.npz"]
    for name in names:
        with np.load(tmp_path / "t" / name) as a, np.load(tmp_path / "j" / name) as b:
            assert a.files == b.files
            for key in a.files:
                if key.startswith("meta_"):
                    assert str(a[key]) == str(b[key])
    # cross resume: each package reads the other's shards without solving again
    (tmp_path / "t" / "gen_00000004.npz").unlink()
    mixed = tgen.generate_instances_sharded(tmp_path / "j", 6, n, device="cpu", **kw)
    np.testing.assert_array_equal(mixed["opt_tour"], want["opt_tour"])
    back = jgen.generate_instances_sharded(tmp_path / "t", 6, n, **kw)
    np.testing.assert_array_equal(back["coords"], want["coords"])
    np.testing.assert_array_equal(back["opt_tour"][:4], got["opt_tour"][:4])
    np.testing.assert_array_equal(back["in_solution"], got["in_solution"])
    with pytest.raises(ValueError) as err:
        jgen.generate_instances_sharded(tmp_path / "j", 6, n, **{**kw, "seed": 4})
    with pytest.raises(ValueError, match=re.escape(str(err.value))):
        tgen.generate_instances_sharded(tmp_path / "j", 6, n, device="cpu",
                                        **{**kw, "seed": 4})


def test_scaler_json_byte_for_byte(tmp_path):
    rng = np.random.default_rng(2)
    X, Y = rng.normal(size=(40, 3)), rng.random((25, 1)) * 3
    mine = {"features": tscaler.MinMaxScaler().fit(X[:20]).partial_fit(X[20:]),
            "regret": tscaler.MinMaxScaler().fit(Y)}
    theirs = {"features": jscaler.MinMaxScaler().fit(X[:20]).partial_fit(X[20:]),
              "regret": jscaler.MinMaxScaler().fit(Y)}
    tscaler.save_scalers(tmp_path / "t.json", mine)
    jscaler.save_scalers(tmp_path / "j.json", theirs)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    back = tscaler.load_scalers(tmp_path / "j.json")
    for key in mine:
        assert back[key].to_dict() == theirs[key].to_dict()
        np.testing.assert_array_equal(back[key].transform(X[:, :1] if key == "regret" else X),
                                      theirs[key].transform(X[:, :1] if key == "regret" else X))
    # the constructor still takes a fitted range; an unfitted scaler has none
    assert tscaler.MinMaxScaler([1.0], [3.0]).to_dict() == {"data_min": [1.0], "data_max": [3.0]}
    assert tscaler.MinMaxScaler().data_min_ is None


def test_fit_scalers_and_split_equal_jax():
    data = jgen.generate_instances(10, 7, seed=2)
    data["regret"] = np.random.default_rng(0).random(data["in_solution"].shape).astype(np.float32)
    for kw in ({"seed": 0}, {"seed": 5}, {"rng": "rng"}):
        got, want = (split(10, 6, 2, 2, **{k: np.random.default_rng(11) if v == "rng" else v
                                           for k, v in kw.items()})
                     for split in (tds.split_dataset, jds.split_dataset))
        assert [len(a) for a in got] == [6, 2, 2]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    train, _, _ = tds.split_dataset(10, 6, 2, 2, seed=0)
    mine = tds.TSPDataset.from_arrays(data, train).fit_scalers()
    theirs = jds.TSPDataset.from_arrays(data, train).fit_scalers()
    assert {k: v.to_dict() for k, v in mine.items()} == {k: v.to_dict() for k, v in theirs.items()}


def test_data_clis_equal_jax(tmp_path):
    """Both CLIs on 6 instances at n=8 (Held-Karp tours, native labels):
    instances.npz's arrays, the split files and scalers.json equal; the
    refusals are JAX's."""
    for pkg, gen_main, pre_main in (("j", jcli_gen.main, jcli_pre.main),
                                    ("t", tcli_gen.main, tcli_pre.main)):
        extra = ["--device", "cpu"] if pkg == "t" else []
        gen_main(["6", "8", str(tmp_path / pkg), "--seed", "1", "--chunk", "4", *extra])
        with pytest.raises(SystemExit, match="exists"):
            gen_main(["6", "8", str(tmp_path / pkg), *extra])
        pre_main([str(tmp_path / pkg), "--n_train", "3", "--n_test", "2", "--n_val", "1",
                  "--seed", "0"])
        with pytest.raises(SystemExit, match="scalers.json already exists"):
            pre_main([str(tmp_path / pkg)])
    got = tgen.load_dataset(tmp_path / "t" / "instances.npz")
    want = jgen.load_dataset(tmp_path / "j" / "instances.npz")
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    for name in ("train.txt", "val.txt", "test.txt", "scalers.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert not (tmp_path / "t" / "shards").exists()
    assert json.loads((tmp_path / "t" / "scalers.json").read_text()).keys() == {
        "features", "regret"}
