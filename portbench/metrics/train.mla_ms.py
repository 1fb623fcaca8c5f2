"""train.mla_ms: device milliseconds a training step inside the latent
attention blocks (the program's ``model.mla`` spans, between their CUDA
events, summed over a step's blocks, the backward's recompute included),
the median over the traced steps."""
from portbench import spans


def read(ctx):
    return spans.median(spans.device_ms_per_unit(
        spans.timeline(), "train.step", ("model.mla",)))
