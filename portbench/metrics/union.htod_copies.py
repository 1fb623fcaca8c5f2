"""union.htod_copies: the host-to-device copies a union reduce issues
(the program's ``union.htod_copies`` increments under ``union.reduce``:
the stages' edges, replication weights, host arrays made into tensors,
and a plan-cache miss's transport tables; none on the CPU), the median
over the traced reduces."""
from portbench import spans


def read(ctx):
    return spans.median(spans.count_per_unit(
        spans.timeline(), "union.reduce", "union.htod_copies"))
