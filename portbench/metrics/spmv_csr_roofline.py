"""spmv_csr_roofline: the CSR product's least bytes (columns, weights,
row starts, x read and y written once, from the drawn graph) over 3.35
TB/s, as a share of the mean device time of ``spmv_csr_kernel`` (%)."""
from portbench import roofline
from portbench.tracing import device_us


def read(ctx):
    tr = ctx.get("trace") or {}
    us, n = device_us(tr, ("spmv_csr_kernel",))
    if not n:
        return None
    return 100.0 * roofline.hbm_ms(ctx["facts"]["spmv_bytes"]) / (us / 1e3 / n)
