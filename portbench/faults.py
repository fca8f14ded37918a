"""Faults planted under the timed path, to show that the check catches them,
and the control put in the program's place.  Each is a list of (module,
attribute, replacement) for the caller to set and undo (pytest's
monkeypatch in the CPU tests; `planted` in portbench.readings on the card).

A cell's faults are its runner's: each module under portbench/runners/
declares `faults(config, root, batch)`, a table from fault name to triples
made with the shared helpers below, so that a runner added for another
model brings its own table, and its own control, in its own file.

  half_batch       half of the batch left out, the mean taken over the rest
                   (inference: the first half predicted and repeated; a train
                   step on the first half of the batch)
  unchanged_state  a step that returns its state unchanged (the search's
                   outer iterations, the train step's update)
  altered_answer   an answer altered where it is produced (two cities of
                   every best tour swapped)
  control_tf32     the runner's plain reference with TF32 products predicting
                   in the program's place
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import time

import numpy as np

from portbench import manifest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def half_predict(real):
    def predict(model, dataset, **kw):
        h = (len(dataset) + 1) // 2
        sub = dataclasses.replace(dataset, coords=dataset.coords[:h],
                                  features=dataset.features[:h], regret=dataset.regret[:h],
                                  in_solution=dataset.in_solution[:h],
                                  opt_cost=dataset.opt_cost[:h])
        p = real(model, sub, **kw)
        return np.concatenate([p, p])[:len(dataset)]
    return predict


def half_step(real):
    def step(model, opt, x, y, **kw):
        h = (len(x) + 1) // 2
        return real(model, opt, x[:h], y[:h], **kw)
    return step


def no_step(model, opt, x, y, **kw):
    import torch

    from gnngls_tpu_torch.train.step import loss_fn

    with torch.no_grad():
        return loss_fn(model(x, gat_impl=kw.get("gat_impl", "fast")), y)


def search_unchanged(real):
    def gls(Ds, guides, init, *, n_iters, **kw):
        return real(Ds, guides, init, n_iters=0, **kw)
    return gls


def iteration_unchanged(state, D, G, **kw):
    time.sleep(0.05)  # an iteration's time, so that a deadline runs few
    return state._replace(iter_i=state.iter_i + 1)


def altered(real):
    def gls(*a, **kw):
        out = real(*a, **kw)
        out.best_tours[:, [1, 2]] = out.best_tours[:, [2, 1]]
        return out
    return gls


def patches(fault: str, runner: str, config: dict, root: pathlib.Path = ROOT,
            batch: int = 1):
    """(module, attribute, replacement) triples that plant `fault` for a cell
    of `runner`, from the table of portbench/runners/<runner>.py under
    `root`; `batch` is the instances the control predicts at a time."""
    table = manifest.load_file(root, "runners", runner).faults(config, root, batch)
    if fault not in table:
        raise ValueError(f"no fault {fault!r} for a {runner} cell; have {sorted(table)}")
    return table[fault]


@contextlib.contextmanager
def planted(fault: str, runner: str, config: dict, root: pathlib.Path = ROOT,
            batch: int = 1):
    """The fault planted for the block, undone after it."""
    triples = patches(fault, runner, config, root, batch)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in triples]
    for mod, name, new in triples:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)
