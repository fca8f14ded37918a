"""The runner of DIFUSCO's denoising GNN (Sun & Yang, arXiv:2302.08224)
through the program's `evaluate`: the evaluate runner with the model hooks
of this architecture.  The program's `Difusco` gets the weights that the
reference draws from the configuration's `weights_seed`, through its npz
loader; request r draws with seed = the run's seed + r.  Its guides,
1 - (h_ij + h_ji) / 2 from the last step's heatmap, take the "regret_pred"
slot, so the check after inference (nearest neighbour, K1, the reference's
GLS) is the evaluate runner's.

A draw within a few ulps of pi may fall either way, after which two
trajectories part for good; so the reference follows the program's own.  A
forward hook on the program's model keeps, for the request's kept lanes,
each step's t, state x_t and output p^: two device copies a step of the kept
lanes' (n K) edges (bool and float32: 250 KB a step at n = 500, K = 50 and
two lanes), fetched to the host after the request's end stamp.  For each
sampled lane the reference takes the program's x_t and t at every step,
recomputes p^ and pi, and replays the draws from the seed:
  step_err      the largest |p^_program - p^_reference| over every step and
                edge: both compute float32 products without TF32 in other
                orders (sums over 256 features, the per-layer norms), a few
                ulps a layer that twelve layers carry on (2e-7 to 5e-7 on
                the CPU tests at two layers); TF32 products move p^ by 5e-4
                and more (the CPU tests' control; the card's in PERF.md), so
                the limit 1e-4 lies between them;
  draws_differ  draws where x_s != [u < pi_reference] while |u - pi_reference|
                > 1e-4, and x_T != [u < 1/2]: a sound program's pi lies
                within a few ulps of the reference's, so only a draw that
                close may fall the other way; exact (0);
  pred_err      the final guides, as the evaluate runner compares them
                (1e-4, its reason there).
A trajectory of another length, other time steps or another batch (a loop
cut short, half a batch) cannot be followed: its lanes count 1.0 in
step_err, the largest gap two probabilities can have, and every draw in
draws_differ, and the reference's own trajectory makes the guides.

The reference is portbench/reference/difusco.py under the same root; the
FLOP and byte counts are portbench/roofline_difusco.py."""

from __future__ import annotations

import dataclasses
import io

import numpy as np

from portbench import manifest, roofline_difusco
from portbench import traffic as gen
from portbench.runners import evaluate, gated_gcn

LIMITS = evaluate.LIMITS + ("step_err", "draws_differ")
PUBLISHED = {"hidden_dim": 256, "num_layers": 12, "sparse_factor": 50,
             "diffusion_steps": 1000, "inference_steps": 50}
DRAW_SLACK = 1e-4  # |u - pi| within which a draw may fall either way


def reference(root):
    return manifest.load_file(root, "reference", "difusco")


def one_step(real):
    """`predict_diffusion_guide` with a loop of one denoising step."""
    def predict(model, *a, **kw):
        cfg = model.cfg
        model.cfg = dataclasses.replace(cfg, inference_steps=1)
        try:
            return real(model, *a, **kw)
        finally:
            model.cfg = cfg
    return predict


def tf32_forward(config: dict, root):
    """A `Difusco.forward` that runs the reference with TF32 products, one
    instance at a time, on the program's states."""
    import torch

    ref, m = reference(root), config["model"]
    cache = {}

    def forward(module, coords, x, t, nbr):
        dev = coords.device
        if dev not in cache:
            cache[dev] = {k: torch.as_tensor(v, device=dev)
                          for k, v in ref.make_weights(m, config["weights_seed"]).items()}
        pts = coords.cpu().numpy()
        return torch.stack([ref.forward(cache[dev], m, pts[b], x[b].reshape(-1), t, "tf32",
                                        nbr[b].cpu().numpy())[:, 1].view(x.shape[1:])
                            for b in range(len(x))])
    return forward


def faults(config: dict, root, batch: int) -> dict:
    """The evaluate runner's search faults, half a batch and a loop of one
    step in DIFUSCO's predictions, and this model's control: its reference
    with TF32 products in the place of the program's network, inside the
    program's own loop."""
    from gnngls_tpu_torch import evaluate as program
    from gnngls_tpu_torch.models import difusco

    shared = evaluate.faults(config, root, batch)
    return {"half_batch": [(program, "predict_diffusion_guide",
                            gated_gcn.half_guide(program.predict_diffusion_guide))],
            "one_step": [(program, "predict_diffusion_guide",
                          one_step(program.predict_diffusion_guide))],
            "unchanged_state": shared["unchanged_state"],
            "altered_answer": shared["altered_answer"],
            "control_tf32": [(difusco.Difusco, "forward", tf32_forward(config, root))]}


class Runner(evaluate.Runner):
    def setup(self) -> None:
        if int(self.tr["batch_size"]) < int(self.tr["request_instances"]):
            raise ValueError("the difusco runner follows one batch a request")
        self._keep, self._steps = None, []
        super().setup()

    def _weights(self) -> dict:
        if self.weights is None:
            self.weights = reference(self.root).make_weights(self.cfg["model"],
                                                             self.cfg["weights_seed"])
        return self.weights

    def load_model(self):
        """The program's model with the reference's weights, through its
        npz loader, with the hook that keeps the kept lanes' steps."""
        from gnngls_tpu_torch.models import difusco

        buf = io.BytesIO()
        np.savez(buf, **self._weights())
        buf.seek(0)
        model = difusco.load_model(buf, difusco.DifuscoConfig(**self.cfg["model"]),
                                   device=self.dev)
        model.register_forward_hook(self._record)
        return model

    def _record(self, module, args, out) -> None:
        if self._keep is None:
            return
        lanes, index = self._keep
        x, t = args[1], args[2]
        if len(x) <= int(lanes.max()):  # a batch cut short: keep the lanes it has
            lanes = lanes[lanes < len(x)]
            index = self.torch.as_tensor(lanes, device=x.device)
        self._steps.append((int(t), len(x), lanes, x.index_select(0, index),
                            out.index_select(0, index)))

    def kwargs(self, warmup: bool) -> dict:
        return dict(super().kwargs(warmup), seed=self._seed)

    def request(self, r: int, warmup: bool = False):
        self._seed = self.seed + (abs(r) + 10 ** 6 if warmup else r)
        if not warmup:
            lanes = gen.lanes(self.seed, r, self.src.size, int(self.check_spec["lanes"]))
            self._keep = (lanes, self.torch.as_tensor(lanes, device=self.dev))
        self._steps = []
        try:
            q = super().request(r, warmup)
        finally:
            self._keep = None
        if not warmup:
            q.kept["steps"] = [(t, B, lanes, x.cpu().numpy(), p.cpu().numpy())
                               for t, B, lanes, x, p in self._steps]
        self._steps = []
        return q

    def reference_guides(self, chosen, prec: str) -> np.ndarray:
        """Each chosen request's kept lanes through the reference, on the
        program's trajectory where it can be followed (module docstring);
        sets step_err and draws_differ."""
        ref, m = reference(self.root), self.cfg["model"]
        steps = ref.schedule(m["diffusion_steps"], m["inference_steps"])
        bs = int(self.tr["batch_size"])
        guides, self.follow = [], {"step_err": 0.0, "draws_differ": 0}
        for q in chosen:
            lanes, rec = q.kept["lanes"], q.kept["steps"]
            sound = ([(t, B, list(kept)) for t, B, kept, _, _ in rec]
                     == [(t, min(bs, q.instances), list(lanes)) for t, _ in steps])
            states = np.stack([x for *_, x, _ in rec], axis=1) if sound else None
            out = ref.predict(self._weights(), m, self.src.coords_of(q.index),
                              seed=self.seed + q.index, batch=bs, lanes=lanes, states=states,
                              prec=prec, device=self.dev)
            guides.append(out["guides"])
            if not sound:
                self.follow["step_err"] = 1.0
                self.follow["draws_differ"] += out["u"].size
                continue
            E = out["p"].shape[-1]
            xs = states.reshape(len(lanes), len(steps), E)
            p_prog = np.stack([p for *_, p in rec], axis=1).reshape(xs.shape)
            self.follow["step_err"] = max(self.follow["step_err"],
                                          float(np.abs(p_prog - out["p"]).max()))
            pi = np.clip(out["pi"][:, :-1], 0, 1)
            u = out["u"]
            drawn = u[:, 1:] < pi
            differ = (xs[:, 1:] != drawn) & (np.abs(u[:, 1:] - pi) > DRAW_SLACK)
            self.follow["draws_differ"] += int(differ.sum()) + int(
                (xs[:, 0] != (u[:, 0] < 0.5)).sum())
        return np.concatenate(guides)

    def check(self, requests, n_done=None) -> dict:
        return dict(super().check(requests, n_done), **self.follow)

    def model_flops_per_instance(self) -> float:
        return roofline_difusco.difusco_flops(self.cfg)
