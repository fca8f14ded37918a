"""The GAT's hooks and declarations on the runners give what the harness
computed inline before they were hooks: the reference's guide matrices bit
for bit, the model FLOPs of the mfu readers, and the check's names."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import manifest, roofline
from portbench import traffic as gen
from portbench.reference import regret_gat as ref_model
from portbench.tests import harness_root

REPO = harness_root.REPO
SEED = 3000000019


def runner(root, name, device="cpu"):
    cell = manifest.load(name, root)
    return manifest.load_file(root, "runners", cell.traffic["runner"]).Runner(
        root, cell, SEED, device)


def test_reference_guides_are_the_inline_construction_bit_for_bit(tmp_path):
    root, name = harness_root.make(tmp_path, "fixed")
    drv = runner(root, name)
    drv.reseed(SEED)
    mod = manifest.load_file(root, "runners", "evaluate")
    chosen = [mod.Request(index=r, start=0.0, end=0.0, instances=drv.src.size,
                          kept={"lanes": gen.lanes(SEED, r, drv.src.size, 1)})
              for r in (0, 5)]
    got = drv.reference_guides(chosen, "f32")
    # the construction as `check` wrote it inline
    coords = np.concatenate([drv.src.coords_of(q.index)[q.kept["lanes"]] for q in chosen])
    cfg = drv.cfg
    scalers = json.loads((root / cfg["scalers"]).read_text())
    m = cfg["model"]
    pred = ref_model.predict(ref_model.load_weights(root / cfg["checkpoint"], "cpu"), coords,
                             scalers, n_heads=m["n_heads"], depth=m["n_heads"], prec="f32",
                             device="cpu", batch=int(drv.check_spec["reference_batch"]))
    D = ref_model.distances(coords)
    us, vs = ref_model.edge_pairs(drv.src.n)
    want = np.zeros_like(D)
    want[:, us, vs] = want[:, vs, us] = pred
    assert got.dtype == want.dtype and got.shape == (2, 100, 100)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name, flops", [("tsp100.fixed100", 1.170e10),
                                         ("tsp500.fixed40", 2.948e11),
                                         ("tsp100.deadline10s", 1.170e10),
                                         ("tsp100.train32", 1.170e10)])
def test_model_flops_are_the_mfu_readers_count(name, flops):
    drv = runner(REPO, name)
    cfg = drv.cfg
    m = cfg["model"]
    # the count as the mfu reader computed it from the configuration
    want = roofline.model_flops_per_instance(cfg["instances"]["n"], m["embed_dim"],
                                             m["hidden_dim"], m["n_heads"], m["in_dim"])
    assert drv.model_flops_per_instance() == want
    assert want == pytest.approx(flops, rel=1e-3)


def test_limits_are_the_names_each_runner_checks():
    assert set(manifest.load_file(REPO, "runners", "evaluate").LIMITS) == {
        "pred_err", "own_guide_differ", "init_tours_differ", "search_differ"}
    assert set(manifest.load_file(REPO, "runners", "train").LIMITS) == {
        "loss_gap", "grad_gap", "change_gap"}
