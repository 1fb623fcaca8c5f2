"""union.kernels_ms: device milliseconds a reduce of the port's
hand-written merge and scatter kernels (``csrc/rank_merge*.cu``,
``csrc/*onehot_scatter.cu``), by their function names."""
from portbench.tracing import device_us

KERNELS = ("partition_kernel", "merge_kernel", "tree_in_smem_kernel",
           "narrow_edges_kernel", "rank_counts_banded_kernel", "tile_hist",
           "scan_counts", "tile_place", "run_sum", "banded_window_table",
           "banded_scatter_kernel")


def read(ctx):
    tr = ctx.get("trace") or {}
    n = ctx["units"] * ctx["work"].get("reduces", 0)
    us, count = device_us(tr, KERNELS)
    if not n or not count:
        return None
    return us / 1e3 / n
