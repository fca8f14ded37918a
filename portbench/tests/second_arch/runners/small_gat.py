"""The runner of the harness tests' stand-in second model (the program's
`RegretGNN` at embed 32, FFN 64 and 4 heads, with weights drawn from the
configuration's seed): what a configuration of another architecture brings
to the evaluate runner.  It subclasses `Runner` and overrides the three
model hooks; the check after inference is the evaluate runner's.  Its
reference is portbench/reference/small_gat.py under the same root."""

from __future__ import annotations

import json

import numpy as np

from portbench import manifest, roofline
from portbench.runners import evaluate

LIMITS = evaluate.LIMITS
PUBLISHED = {"embed_dim": 32, "hidden_dim": 64, "n_heads": 4}


def reference(root):
    return manifest.load_file(root, "reference", "small_gat")


def faults(config: dict, root, batch: int) -> dict:
    """The evaluate runner's faults, with this model's control: its own
    reference with TF32 products in `predict_regret`'s place."""
    from gnngls_tpu_torch import evaluate as program

    def predict(model, dataset, *, device=None, **kw):
        ref, dev = reference(root), device or "cuda"
        weights = ref.make_weights(config["model"], config["weights_seed"], dev)
        scalers = json.loads((root / config["scalers"]).read_text())
        return ref.predict(weights, dataset.coords, scalers, config["model"], prec="tf32",
                           device=dev, batch=batch)

    return {**evaluate.faults(config, root, batch),
            "control_tf32": [(program, "predict_regret", predict)]}


class Runner(evaluate.Runner):
    def load_model(self):
        """The program's model with the weights drawn by the reference."""
        from gnngls_tpu_torch.models.convert import state_from_jax_numpy
        from gnngls_tpu_torch.models.regret_gat import RegretGNN, RegretGNNConfig

        weights = reference(self.root).make_weights(self.cfg["model"], self.cfg["weights_seed"],
                                                    self.dev)
        model = RegretGNN(RegretGNNConfig(**self.cfg["model"]))
        model.load_state_dict(state_from_jax_numpy(
            {k: v.cpu().numpy() for k, v in weights.items()}), strict=True)
        return model.to(self.dev)

    def reference_guides(self, chosen, prec: str) -> np.ndarray:
        ref = reference(self.root)
        coords = np.concatenate([self.src.coords_of(q.index)[q.kept["lanes"]] for q in chosen])
        weights = ref.make_weights(self.cfg["model"], self.cfg["weights_seed"], self.dev)
        scalers = json.loads((self.root / self.cfg["scalers"]).read_text())
        pred = ref.predict(weights, coords, scalers, self.cfg["model"], prec=prec,
                           device=self.dev, batch=int(self.check_spec["reference_batch"]))
        return evaluate.guide_matrices(pred, self.src.n)

    def model_flops_per_instance(self) -> float:
        m = self.cfg["model"]
        return roofline.model_flops_per_instance(self.cfg["instances"]["n"], m["embed_dim"],
                                                 m["hidden_dim"], reference(self.root).depth(m),
                                                 m["in_dim"])
