"""The train runner: one request is one `gnngls_tpu_torch.train.step.train_step`
on a batch of train-split instances, in a closed loop, resumed from the
configuration's checkpoint with its Adam state (the program's
`restore_checkpoint`).  The batch's features and scaled targets come from the
program's `TSPDataset` built from the coordinates and regret labels the
harness hands over.

Set-up warms up on a model and optimizer of their own, built alike and then
thrown away, and builds the one model and optimizer that the window drives
from the checkpoint.  The window's steps are what the check compares, in two
stages, after the window, on the plain reference's own model, features,
targets and Adam, from the coordinates:
  start   the window's first `compared_steps` steps, which the reference
          follows from the checkpoint:
    loss_gap     the largest relative gap of a step's loss;
    grad_gap     the first step's gradient as the optimizer got it, worked
                 out from its first moment before and after the step: per
                 leaf the gap between the program's norm and the
                 reference's, over the larger of the reference's leaf norm
                 and the median leaf's norm, the median leaf's gap;
    change_gap   the same for each leaf's change over the stage;
  last    the window's last two steps, which the reference follows from the
          program's state before them (its weights, Adam moments and count,
          copied before every step), so that a path that sets in later in
          the window is held too: their losses, the second of which shows
          the first one's update, go into loss_gap.
Leaves whose reference gradient is below a thousandth of the median leaf's
(zero but for rounding, as a bias ahead of a BatchNorm) are left out of
grad_gap and change_gap.
The worst leaf's gaps go into `sample` beside them (grad_worst_leaf,
change_worst_leaf) and are not compared: a first-layer leaf's gradient is a
float32 sum over every edge of the batch that cancels far, so on some seeds
either side's norm of it lies 1e-3 from a float64 witness's, as far as the
TF32 control's worst leaf lies from the reference, while the median leaf
stays where rounding puts it.

LIMITS, PUBLISHED and `faults` declare, as in the evaluate runner, the names
`check` returns, the GAT's widths that a configuration trained here keeps,
and the cell's faults (portbench/faults.py); the train runner's control is
`control`, the reference in TF32 in the program's place.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from portbench import faults as F
from portbench import roofline
from portbench import traffic as gen
from portbench.reference import regret_gat as ref_model

VANISH = 1e-3  # of the median leaf's gradient norm
LIMITS = ("loss_gap", "grad_gap", "change_gap")
PUBLISHED = {"embed_dim": 128, "hidden_dim": 512, "n_heads": 8}


def faults(config: dict, root, batch: int) -> dict:
    """The faults of a train cell of the GAT."""
    from gnngls_tpu_torch.train import step

    return {"half_batch": [(step, "train_step", F.half_step(step.train_step))],
            "unchanged_state": [(step, "train_step", F.no_step)]}


@dataclasses.dataclass
class Request:
    index: int
    start: float
    end: float
    instances: int
    dataset_s: float = 0.0
    loss: float = 0.0
    peak_bytes: int = 0


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref), median
    norm(ref)), for the leaves in `keep`."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med) for k in keep}


class Runner:
    def __init__(self, root, cell, seed: int, device):
        self.root, self.cell, self.seed, self.dev = root, cell, int(seed), device
        self.cfg, self.tr = cell.config, cell.traffic
        self.steps = int(self.tr["compared_steps"])
        self.min_requests = self.steps + 2  # the last two steps lie past the start
        self.model, self.sample_info = None, {}

    def build(self):
        """A model and Adam resumed from the checkpoint."""
        from gnngls_tpu_torch.models.convert import load_model
        from gnngls_tpu_torch.models.regret_gat import RegretGNNConfig
        from gnngls_tpu_torch.train.checkpoint import restore_checkpoint
        from gnngls_tpu_torch.train.step import make_optimizer

        ckpt = self.root / self.cfg["checkpoint"]
        model = load_model(ckpt, RegretGNNConfig(**self.cfg["model"]), device=self.dev)
        opt = make_optimizer(model)
        restore_checkpoint(ckpt, model, opt)
        return model, opt

    def model_flops_per_instance(self) -> float:
        """A forward's FLOPs an instance (the mfu.train metric counts a step
        as three)."""
        return roofline.regret_gat_flops(self.cfg)

    def setup(self) -> None:
        from gnngls_tpu_torch.core.scaler import load_scalers
        from gnngls_tpu_torch.data.dataset import TSPDataset
        from gnngls_tpu_torch.models.convert import jax_key
        from gnngls_tpu_torch.train.step import train_step

        self.TSPDataset, self.train_step = TSPDataset, train_step
        self.scalers = load_scalers(self.root / self.cfg["scalers"])
        self.src = gen.Requests(self.root, self.cfg, self.tr, self.seed)
        model, opt = self.build()
        for w in range(int(self.tr.get("warmup_steps", 1))):
            self.step(model, opt, 10 ** 6 + w)
        del model, opt
        self.model, self.opt = self.build()
        named = list(self.model.named_parameters())
        self.keys = [jax_key(k).split("::", 1)[1] for k, _ in named]
        self.params = [p for _, p in named]
        self.m = [self.opt.state[p]["exp_avg"] for p in self.params]
        self.v = [self.opt.state[p]["exp_avg_sq"] for p in self.params]
        self.b1 = self.opt.param_groups[0]["betas"][0]
        with torch.no_grad():
            self.start = ([p.clone() for p in self.params], [m.clone() for m in self.m])
            # the state before each of the last two steps: slot r % 2 before step r
            self.pre = [tuple([torch.empty_like(t) for t in ts]
                              for ts in (self.params, self.m, self.v)) for _ in range(2)]
        self.pre_count, self.losses, self.grad0, self.change = [None, None], [], None, None
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()

    def gradient(self, m_before, m_after):
        """The gradient Adam took, from its first moment: m1 = b1 m0 + (1 - b1) g."""
        return [(a - self.b1 * b) / (1 - self.b1) for b, a in zip(m_before, m_after)]

    def step(self, model, opt, r: int):
        coords, regret = self.src.coords_of(r), self.src.regret_of(r)
        N, E = regret.shape
        t0 = time.time()
        with record_function("portbench.dataset"):
            ds = self.TSPDataset.from_arrays(
                {"coords": coords, "regret": regret, "in_solution": np.zeros((N, E), bool),
                 "opt_cost": np.ones(N)}, scalers=self.scalers)
            batch = ds.get_scaled_batch(np.arange(N))
            x = torch.as_tensor(batch["features"], device=self.dev)
            y = torch.as_tensor(batch["regret"], device=self.dev)
        t1 = time.time()
        if model is self.model:  # the state before this step, for the last stage
            with torch.no_grad():
                for dst, src in zip(self.pre[r % 2], (self.params, self.m, self.v)):
                    torch._foreach_copy_(dst, src)
            self.pre_count[r % 2] = float(self.opt.state[self.params[0]]["step"])
        with record_function("portbench.train_step"):
            loss = float(self.train_step(model, opt, x, y, gat_impl=self.tr["gat_impl"]))
        return t0, t1, time.time(), N, loss

    def request(self, r: int) -> Request:
        t0, t1, t2, N, loss = self.step(self.model, self.opt, r)
        if r < self.steps:
            self.losses.append(loss)
            with torch.no_grad():
                if r == 0:
                    self.grad0 = self.gradient(self.start[1], self.m)
                if r == self.steps - 1:
                    self.change = [p - s for p, s in zip(self.params, self.start[0])]
        peak = int(torch.cuda.max_memory_allocated()) if torch.cuda.is_available() else 0
        return Request(index=r, start=t0, end=t2, instances=N, dataset_s=t1 - t0, loss=loss,
                       peak_bytes=peak)

    def iteration_hook(self, step):
        raise ValueError("a train step is one request: trace it by request")

    def memory_peak(self, requests: List[Request]) -> int:
        cur = int(torch.cuda.max_memory_allocated()) if torch.cuda.is_available() else 0
        return max([cur] + [q.peak_bytes for q in requests])

    def release(self) -> None:
        """Free the program's model and optimizer."""
        self.model = self.opt = self.params = self.m = self.v = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def gaps(self, requests):
        return None

    def malformed(self, q: Request) -> Optional[str]:
        return None if np.isfinite(q.loss) else f"step {q.index}: loss {q.loss}"

    def reference(self, prec: str, rows, start: Optional[dict] = None) -> dict:
        """The reference's losses, first gradient and change over the steps on
        `rows` (request indices), in precision `prec`, from the checkpoint or
        from `start` ({"params", "mu", "nu": {leaf: tensor}, "count"})."""
        ckpt = self.root / self.cfg["checkpoint"]
        scalers = json.loads((self.root / self.cfg["scalers"]).read_text())
        m = self.cfg["model"]
        weights = ref_model.load_weights(ckpt, self.dev)
        adam = ref_model.load_adam(ckpt, self.dev)
        if start is not None:
            weights.update({"params::" + k: v.clone() for k, v in start["params"].items()})
            adam.update(mu={k: v.clone() for k, v in start["mu"].items()},
                        nu={k: v.clone() for k, v in start["nu"].items()}, count=start["count"])
        model = ref_model.Model(weights, m["n_heads"],
                                m["n_heads"] if m.get("depth_from_heads", True)
                                else m["n_layers"], prec)
        params = {k[len("params::"):]: v.requires_grad_() for k, v in model.params.items()}
        p0 = {k: v.detach().clone() for k, v in params.items()}
        b1, b2, eps, lr = adam["b1"], adam["b2"], adam["eps"], adam["learning_rate"]
        mu, nu, count = adam["mu"], adam["nu"], adam["count"]
        losses, grad0 = [], None
        with ref_model.precision(prec, self.dev):
            for r in rows:
                x = torch.as_tensor(ref_model.scaled_features(self.src.coords_of(r), scalers),
                                    device=self.dev)
                y = torch.as_tensor(ref_model.scale_regret(self.src.regret_of(r), scalers),
                                    device=self.dev)
                loss = torch.mean((model.forward(x, train=True) - y) ** 2)
                grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
                losses.append(float(loss.detach()))
                if grad0 is None:
                    grad0 = {k: g.detach() for k, g in grads.items()}
                count += 1
                with torch.no_grad():
                    for k, p in params.items():
                        mu[k] = b1 * mu[k] + (1 - b1) * grads[k]
                        nu[k] = b2 * nu[k] + (1 - b2) * grads[k] ** 2
                        step = lr / (1 - b1 ** count)
                        denom = (nu[k].sqrt() / (1 - b2 ** count) ** 0.5) + eps
                        p -= step * mu[k] / denom
        return {"losses": losses, "grad0": grad0,
                "change": {k: p.detach() - p0[k] for k, p in params.items()}}

    def compare(self, got: dict, ref: dict) -> dict:
        norms = {k: float(g.double().norm()) for k, g in ref["grad0"].items()}
        med = float(np.median(list(norms.values())))
        keep = [k for k, v in norms.items() if v >= VANISH * med]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        grad = leaf_gaps(got["grad0"], ref["grad0"], keep)
        change = leaf_gaps(got["change"], ref["change"], keep)
        return {"loss_gap": loss_gap, "grad_gap": float(np.median(list(grad.values()))),
                "change_gap": float(np.median(list(change.values()))),
                "grad_worst_leaf": max(grad.values()), "change_worst_leaf": max(change.values())}

    def named(self, ts) -> Dict[str, torch.Tensor]:
        """The program's per-leaf tensors under the reference's leaf names."""
        return dict(zip(self.keys, ts))

    def check(self, requests) -> dict:
        """Both stages against the reference (module docstring)."""
        start = self.compare({"losses": self.losses, "grad0": self.named(self.grad0),
                              "change": self.named(self.change)},
                             self.reference("f32", range(self.steps)))
        k = requests[-2].index
        pre_p, pre_m, pre_v = (self.named(ts) for ts in self.pre[k % 2])
        ref = self.reference("f32", [k, k + 1], {"params": pre_p, "mu": pre_m, "nu": pre_v,
                                                 "count": int(self.pre_count[k % 2])})
        last = max(abs(q.loss - b) / abs(b) for q, b in zip(requests[-2:], ref["losses"]))
        self.sample_info = {"start_steps": self.steps, "last_steps": [k, k + 1],
                            "start": start, "last": {"loss_gap": last}}
        return {"loss_gap": max(start["loss_gap"], last), "grad_gap": start["grad_gap"],
                "change_gap": start["change_gap"]}

    def readings(self, seed: int) -> dict:
        """The check's numbers for the steps drawn from `seed`, in a window of
        the check's `window_requests` steps."""
        self.seed = int(seed)
        self.setup()
        requests = [self.request(r) for r in range(int(self.cell.check["window_requests"]))]
        self.release()
        return self.check(requests)

    def control(self, seed: int, prec: str) -> dict:
        """The reference in precision `prec` put in the program's place, on
        the start's steps drawn from `seed`."""
        self.seed, self.sample_info = int(seed), {}
        self.src = gen.Requests(self.root, self.cfg, self.tr, self.seed)
        rows = range(self.steps)
        return self.compare(self.reference(prec, rows), self.reference("f32", rows))
