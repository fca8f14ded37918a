"""The model FLOPs of the window's instances (roofline.model_flops_per_instance,
times `factor`: 3 for a training step) over the window's length times the
chip's f32 peak, in %."""

from portbench import roofline


def read(run, factor=1):
    cfg = run.cell.config
    m = cfg["model"]
    depth = m["n_heads"] if m.get("depth_from_heads", True) else m["n_layers"]
    flops = roofline.model_flops_per_instance(cfg["instances"]["n"], m["embed_dim"],
                                              m["hidden_dim"], depth, m["in_dim"])
    return 100.0 * factor * flops * run.instances / (run.window_s * run.peaks["f32_flops"])
