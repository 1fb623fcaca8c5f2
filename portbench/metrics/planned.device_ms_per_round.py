"""planned.device_ms_per_round: device milliseconds a round of every
traced operation other than the CSR product (the planned reduce, the
update and the job's copies)."""
from portbench.tracing import device_us


def read(ctx):
    tr = ctx.get("trace") or {}
    rounds = ctx["units"] * ctx["work"].get("rounds", 0)
    if not rounds or not tr.get("device"):
        return None
    us, _ = device_us(tr, ("spmv_csr_kernel",), exclude=True)
    return us / 1e3 / rounds
