"""train.sparse_sync_ms: device milliseconds a training step of the
embedding's sparse row sync (the program's ``train.sync.sparse`` span,
between its CUDA events), the median over the traced steps."""
from portbench import spans


def read(ctx):
    return spans.median(spans.device_ms_per_unit(
        spans.timeline(), "train.step", ("train.sync.sparse",)))
