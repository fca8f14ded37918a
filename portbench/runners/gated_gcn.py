"""The runner of the residual gated GCN (Joshi, Laurent & Bresson,
arXiv:1906.01227) through the program's `evaluate`: the evaluate runner with
the model hooks of this architecture.  The program's `GatedGCN` gets the
weights that the reference draws from the configuration's `weights_seed`,
through its npz loader; its guides, 1 - (p + p^T) / 2 from the edge
probabilities, take the "regret_pred" slot, so the check after inference
(nearest neighbour, K1, the reference's GLS) is the evaluate runner's.

BatchNorm normalises with each batch's own statistics, so the reference
recomputes each sampled request whole, in the traffic's batches, and keeps
the request's sampled lanes.  Its reference is portbench/reference/
gated_gcn.py under the same root; its FLOP and byte counts are
portbench/roofline_gated_gcn.py."""

from __future__ import annotations

import dataclasses
import io

import numpy as np

from portbench import manifest, roofline_gated_gcn
from portbench.runners import evaluate

LIMITS = evaluate.LIMITS
PUBLISHED = {"hidden_dim": 300, "num_layers": 30, "mlp_layers": 3, "num_neighbors": 20}


def reference(root):
    return manifest.load_file(root, "reference", "gated_gcn")


def half_guide(real):
    """`predict_edge_guide` on the first half of the batch, repeated."""
    def predict(model, dataset, Ds, **kw):
        h = (len(dataset) + 1) // 2
        sub = dataclasses.replace(dataset, coords=dataset.coords[:h],
                                  features=dataset.features[:h], regret=dataset.regret[:h],
                                  in_solution=dataset.in_solution[:h],
                                  opt_cost=dataset.opt_cost[:h])
        g = real(model, sub, Ds[:h], **kw)
        return np.concatenate([g, g])[:len(dataset)]
    return predict


def faults(config: dict, root, batch: int) -> dict:
    """The evaluate runner's search faults, half a batch in the GCN's
    predictions, and this model's control: its reference with TF32 products
    in `predict_edge_guide`'s place, on the program's batches."""
    from gnngls_tpu_torch import evaluate as program

    def tf32(model, dataset, Ds, *, batch_size=64, device=None):
        ref = reference(root)
        weights = ref.make_weights(config["model"], config["weights_seed"])
        return ref.predict(weights, config["model"], dataset.coords, prec="tf32",
                           device=device or "cuda", batch=batch_size)

    shared = evaluate.faults(config, root, batch)
    return {"half_batch": [(program, "predict_edge_guide",
                            half_guide(program.predict_edge_guide))],
            "unchanged_state": shared["unchanged_state"],
            "altered_answer": shared["altered_answer"],
            "control_tf32": [(program, "predict_edge_guide", tf32)]}


class Runner(evaluate.Runner):
    def _weights(self) -> dict:
        if self.weights is None:
            self.weights = reference(self.root).make_weights(self.cfg["model"],
                                                             self.cfg["weights_seed"])
        return self.weights

    def load_model(self):
        """The program's model with the reference's weights, through its
        npz loader."""
        from gnngls_tpu_torch.models import gated_gcn

        buf = io.BytesIO()
        np.savez(buf, **self._weights())
        buf.seek(0)
        return gated_gcn.load_model(buf, gated_gcn.GatedGCNConfig(**self.cfg["model"]),
                                    device=self.dev)

    def reference_guides(self, chosen, prec: str) -> np.ndarray:
        """Each chosen request's instances through the reference in the
        traffic's batches, then its kept lanes, in order."""
        ref, bs = reference(self.root), int(self.tr["batch_size"])
        return np.concatenate([
            ref.predict(self._weights(), self.cfg["model"], self.src.coords_of(q.index),
                        prec=prec, device=self.dev, batch=bs)[q.kept["lanes"]]
            for q in chosen])

    def model_flops_per_instance(self) -> float:
        return roofline_gated_gcn.gated_gcn_flops(self.cfg)
