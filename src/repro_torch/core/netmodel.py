"""alpha-beta-floor(-gamma) network cost model (reference: ``repro.core.netmodel``).

Messages below an *effective packet floor* are latency-bound (the paper's
Fig 3), so per-node time grows with cluster size in a round-robin
exchange.  The model is the classic alpha-beta model with an explicit
floor plus a per-fanout congestion term:

    t(msg bytes s, fanout f) = alpha + gamma * (f - 1) + max(s, floor) / beta

Only the paper's own fabric (EC2, 2013) ships here.  The port carries no
accelerator-fabric preset: a GPU fabric is calibrated from the port's own
transport timings by the autotuner slice, not guessed.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Fabric:
    """One interconnect's fitted (or nominal) cost-model parameters.

    ``beta_bytes_per_s`` is the *achieved* point-to-point bandwidth per node
    (bytes/s), ``alpha_s`` the per-message setup latency (s),
    ``floor_bytes`` the effective packet floor applied once inside
    :meth:`msg_time` to on-wire bytes, ``gamma_s`` the congestion seconds
    per message per extra concurrent peer in one stage.
    """
    name: str
    beta_bytes_per_s: float
    alpha_s: float
    floor_bytes: float = 0.0
    gamma_s: float = 0.0

    def msg_time(self, nbytes: float, fanout: int = 1) -> float:
        """Seconds to send one ``nbytes`` message while exchanging with
        ``fanout`` peers in total (the fanout-1 others add congestion)."""
        payload = max(float(nbytes), self.floor_bytes)
        congest = self.gamma_s * max(fanout - 1, 0)
        return self.alpha_s + congest + payload / self.beta_bytes_per_s

    def stage_time(self, nbytes_per_dest: float, fanout: int,
                   serial: bool = True) -> float:
        """Time for one node to exchange with ``fanout`` peers: serialized
        on one NIC (``serial=True``) or overlapped per link."""
        if fanout <= 0:
            return 0.0
        t_one = self.msg_time(nbytes_per_dest, fanout)
        if serial:
            return fanout * t_one
        return t_one + (fanout - 1) * self.alpha_s

    def stage_split(self, nbytes_per_dest: float, fanout: int,
                    serial: bool = True) -> tuple:
        """:meth:`stage_time` decomposed into ``(serial_s, bandwidth_s)``;
        the two sum to :meth:`stage_time` exactly."""
        if fanout <= 0:
            return 0.0, 0.0
        payload = max(float(nbytes_per_dest), self.floor_bytes)
        per_msg_bw = payload / self.beta_bytes_per_s
        congest = self.gamma_s * max(fanout - 1, 0)
        if serial:
            return fanout * (self.alpha_s + congest), fanout * per_msg_bw
        return (self.alpha_s + congest + (fanout - 1) * self.alpha_s,
                per_msg_bw)

    def as_meta(self) -> dict:
        """JSON-able parameter dict."""
        return {"name": self.name,
                "beta_bytes_per_s": self.beta_bytes_per_s,
                "alpha_s": self.alpha_s,
                "floor_bytes": self.floor_bytes,
                "gamma_s": self.gamma_s}


def rate_optimal_allreduce_s(nbytes: float, num_nodes: int,
                             fabric: Fabric) -> float:
    """Rate-optimal allreduce lower bound (s): ``2 ceil(log2 M)`` message
    latencies plus ``2 (M-1)/M * N / beta`` of bandwidth."""
    m = max(int(num_nodes), 1)
    if m == 1:
        return 0.0
    bw = 2.0 * (m - 1) / m * float(nbytes) / fabric.beta_bytes_per_s
    lat = 2.0 * math.ceil(math.log2(m)) * fabric.alpha_s
    return lat + bw


def rate_fraction(achieved_s: float, nbytes: float, num_nodes: int,
                  fabric: Fabric) -> float:
    """``rate_optimal_allreduce_s / achieved_s`` (0.0 when ``achieved_s``
    is non-positive)."""
    if achieved_s <= 0.0:
        return 0.0
    return rate_optimal_allreduce_s(nbytes, num_nodes, fabric) / achieved_s


# Paper testbed: cc1.4xlarge, 10 Gb/s Ethernet, Java sockets achieve ~2 Gb/s
# (paper SVI-E); alpha puts the effective floor at ~2 MB.
EC2_2013 = Fabric(name="ec2-2013", beta_bytes_per_s=2e9 / 8, alpha_s=8e-3,
                  floor_bytes=0.0)

FABRICS = {f.name: f for f in (EC2_2013,)}
