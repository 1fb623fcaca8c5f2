"""union.partition_ms: device milliseconds a union reduce of its
``union.partition`` spans (every layer's), between each span's CUDA events,
the median over the traced reduces (the program's ``repro_torch.obs``
timeline)."""
from portbench import spans


def read(ctx):
    return spans.median(spans.device_ms_per_unit(
        spans.timeline(), "union.reduce", ("union.partition",)))
