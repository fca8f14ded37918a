"""The model FLOPs of the window's instances (the runner's
`model_flops_per_instance`, which the Run carries as `model_flops`, times
`factor`: 3 for a training step) over the window's length times the chip's
f32 peak, in %."""


def read(run, factor=1):
    flops = run.model_flops
    return 100.0 * factor * flops * run.instances / (run.window_s * run.peaks["f32_flops"])
