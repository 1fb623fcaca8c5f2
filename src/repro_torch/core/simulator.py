"""Message-level simulator of the nested heterogeneous-degree butterfly (reference: ``repro.core.simulator``).

This is the *paper-faithful reference implementation* of Sparse Allreduce
(Zhao & Canny 2013): per-node mailboxes, hash-permuted sorted indices,
contiguous range partitioning per layer, tree-merge summation, a nested
up-phase through the same nodes, and r-way replication with failures.  It
is the ``backend="sim"`` oracle of the port and the host planner under the
device backend's ``config``.  Pure numpy, copied whole from the reference.

API mirrors the paper's two-call interface (§III-B):

    sim = SimSparseAllreduce(plan, num_logical, replication=r, dead=set())
    sim.config(out_indices, in_indices)      # once per index pattern
    in_values = sim.reduce(out_values)       # per iteration

Timing uses synchronized stages: T = sum over stages of the slowest node's
stage time (config/reduce measured separately, as in Table II).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .netmodel import EC2_2013, Fabric
from .replication import DeadLogicalNode
from .sparse_vec import HashPerm, IDENTITY_PERM, sort_coalesce_np, tree_sum_np
from .topology import ButterflyPlan

BYTES_IDX = 4
BYTES_VAL = 4


@dataclasses.dataclass
class StageStats:
    """Modeled per-layer message accounting for one reduce phase."""
    layer: int
    phase: str                 # "down" | "up"
    max_msg_bytes: float = 0.0
    total_bytes: float = 0.0
    num_messages: int = 0
    time_s: float = 0.0


@dataclasses.dataclass
class ReduceStats:
    """Aggregated modeled cost of one config or reduce (all stages)."""
    config_time_s: float = 0.0
    reduce_time_s: float = 0.0
    stages: List[StageStats] = dataclasses.field(default_factory=list)
    overflow: int = 0

    @property
    def total_bytes(self):
        """Sum of modeled bytes moved across every stage."""
        return sum(s.total_bytes for s in self.stages)


class SimSparseAllreduce:
    """Reference Sparse Allreduce over ``num_logical`` logical nodes.

    replication=r mirrors logical node i onto physical nodes i, i+M, ...,
    i+(r-1)M (paper §V-A).  ``dead`` is a set of *physical* node ids; a
    logical node participates iff at least one replica is alive.  Messages
    are replicated r-fold (bytes/time accounting) and the first-alive
    replica's copy is used (deterministic stand-in for packet racing).
    """

    def __init__(self, plan: ButterflyPlan, *, replication: int = 1,
                 dead: Optional[Set[int]] = None,
                 perm: Optional[HashPerm] = None,
                 fabric: Fabric = EC2_2013,
                 merge_ns_per_entry: float = 4.0,
                 value_width: int = 1):
        self.plan = plan
        self.m = plan.num_nodes
        self.r = replication
        self.dead = set(dead or ())
        self.perm = perm if perm is not None else HashPerm.make(0)
        self.fabric = fabric
        self.merge_ns = merge_ns_per_entry
        self.w = value_width
        self._configured = False
        bad = self.dead - set(range(self.m * self.r))
        if bad:
            raise ValueError(
                f"dead ids {sorted(bad)} outside [0, {self.m * self.r}) — "
                f"failure injection would silently be a no-op")
        for n in range(self.m):
            if not self._alive(n):
                raise DeadLogicalNode(f"logical node {n}: all {self.r} replicas dead")

    # -- replication ---------------------------------------------------------
    def _alive(self, logical: int) -> bool:
        return any((logical + j * self.m) not in self.dead for j in range(self.r))

    def replica_ids(self, logical: int) -> List[int]:
        """Physical node ids hosting ``logical`` (paper §V layout)."""
        return [logical + j * self.m for j in range(self.r)]

    # -- config (paper §IV-A: index routing, computed once) -------------------
    def config(self, out_indices: Sequence[np.ndarray],
               in_indices: Sequence[np.ndarray]) -> ReduceStats:
        """The paper's ``config``: freeze all message routing (host numpy)
        for one index pattern and return its modeled :class:`ReduceStats`."""
        assert len(out_indices) == len(in_indices) == self.m
        plan, m = self.plan, self.m
        stats = ReduceStats()

        # Hash-permute and sort; remember maps back to user order.
        self.out_sorted: List[np.ndarray] = []
        self.out_user_to_sorted: List[np.ndarray] = []   # coalesce map
        self.in_sorted: List[np.ndarray] = []
        self.in_sorted_to_user: List[np.ndarray] = []
        for n in range(m):
            h = self.perm.fwd_np(np.asarray(out_indices[n], dtype=np.uint32))
            order = np.argsort(h, kind="stable")
            hs = h[order]
            uniq, inv = np.unique(hs, return_inverse=True)
            # user entry j contributes to sorted-unique slot:
            u2s = np.empty(len(h), dtype=np.int64)
            u2s[order] = inv
            self.out_sorted.append(uniq)
            self.out_user_to_sorted.append(u2s)

            hi = self.perm.fwd_np(np.asarray(in_indices[n], dtype=np.uint32))
            iuniq, iinv = np.unique(hi, return_inverse=True)
            self.in_sorted.append(iuniq)
            self.in_sorted_to_user.append(iinv)  # user j reads slot iinv[j]

        # Down-phase index routing. State per node per layer.
        #   down_idx[l][n]   : node n's sorted unique out-idx entering layer l
        #   down_maps[l][n]  : (src_slices, merge_inv) to rebuild sums at l+1
        #   req_idx[l][n][t] : in-idx piece node n requests from group member t
        #   req_pos[l][n][t] : positions of that piece in member's layer-(l+1)
        #                      in-idx array (filled as members learn them)
        self.down_maps: List[List[Tuple[List[np.ndarray], np.ndarray, np.ndarray]]] = []
        self.req_piece: List[List[List[np.ndarray]]] = []
        self.in_at: List[List[np.ndarray]] = [list(self.in_sorted)]
        cur_out = list(self.out_sorted)

        for l in range(plan.depth):
            k = plan.degrees[l]
            layer_maps: List = [None] * m
            layer_req: List = [None] * m
            nxt_out: List = [None] * m
            nxt_in: List = [None] * m
            st_down = StageStats(layer=l, phase="down")
            for n in range(m):
                members = plan.group_members(n, l)
                edges = plan.edges_at(n, l).astype(np.uint64)
                # split own out-idx and in-idx into k pieces by range
                cuts_o = np.searchsorted(cur_out[n].astype(np.uint64), edges)
                cuts_i = np.searchsorted(self.in_at[l][n].astype(np.uint64), edges)
                layer_req[n] = [self.in_at[l][n][cuts_i[t]:cuts_i[t + 1]]
                                for t in range(k)]
                # stats: k-1 outgoing messages (idx+val bytes modelled later)
                for t in range(k):
                    if members[t] == n:
                        continue
                    nbytes = (cuts_o[t + 1] - cuts_o[t]) * BYTES_IDX \
                        + (cuts_i[t + 1] - cuts_i[t]) * BYTES_IDX
                    nbytes *= self.r  # replicated messages
                    st_down.num_messages += self.r
                    st_down.total_bytes += nbytes
                    st_down.max_msg_bytes = max(st_down.max_msg_bytes, nbytes)
            # deliver: node n at digit t receives piece t from every member
            for n in range(m):
                members = plan.group_members(n, l)
                t_self = members.index(n)
                pieces_out, pieces_in = [], []
                for mem in members:
                    mcuts = np.searchsorted(
                        cur_out[mem].astype(np.uint64),
                        plan.edges_at(mem, l).astype(np.uint64))
                    pieces_out.append(
                        cur_out[mem][mcuts[t_self]:mcuts[t_self + 1]])
                    pieces_in.append(None)  # filled via layer_req below
                cat = np.concatenate(pieces_out) if pieces_out else \
                    np.zeros(0, np.uint32)
                uniq, inv = np.unique(cat, return_inverse=True)
                src_slices = np.cumsum([0] + [len(p) for p in pieces_out])
                layer_maps[n] = (src_slices, inv, uniq)
                nxt_out[n] = uniq
                # inbound requests targeted at n
                req_cat = np.concatenate(
                    [SimSparseAllreduce._req_of(layer_req, mem, plan, l, n)
                     for mem in members])
                nxt_in[n] = np.unique(
                    np.concatenate([req_cat]) if req_cat.size else req_cat)
            self.down_maps.append(layer_maps)
            self.req_piece.append(layer_req)
            self.in_at.append(nxt_in)
            cur_out = nxt_out
            # stage time: comms + merge
            tmax = 0.0
            for n in range(m):
                send_b = st_down.max_msg_bytes  # upper bound per message
                t_comm = self.fabric.stage_time(send_b, (k - 1) * self.r)
                n_merge = len(self.down_maps[-1][n][1])
                t_merge = n_merge * max(np.log2(max(k, 2)), 1.0) * self.merge_ns * 1e-9
                tmax = max(tmax, t_comm + t_merge)
            st_down.time_s = tmax
            stats.stages.append(st_down)

        self.bottom_idx = cur_out  # final summed unique idx per node
        # positions of each request piece in the *holder's* arrays, per layer
        self.ret_pos: List[List[List[np.ndarray]]] = []
        for l in range(plan.depth):
            k = plan.degrees[l]
            layer_pos: List = [None] * m
            for n in range(m):
                members = plan.group_members(n, l)
                per_member = []
                for t, mem in enumerate(members):
                    piece = self.req_piece[l][n][t]
                    holder_idx = self.in_at[l + 1][mem]
                    pos = np.searchsorted(holder_idx.astype(np.uint64),
                                          piece.astype(np.uint64))
                    per_member.append(pos)
                layer_pos[n] = per_member
            self.ret_pos.append(layer_pos)
        # bottom lookup: positions of in_at[D][n] in bottom_idx[n] (+hit mask)
        self.bottom_pos, self.bottom_hit = [], []
        for n in range(m):
            want = self.in_at[plan.depth][n].astype(np.uint64)
            have = self.bottom_idx[n].astype(np.uint64)
            pos = np.searchsorted(have, want)
            pos_c = np.clip(pos, 0, max(len(have) - 1, 0))
            hit = (len(have) > 0) and None
            hitmask = (have[pos_c] == want) if len(have) else \
                np.zeros(len(want), bool)
            self.bottom_pos.append(pos_c)
            self.bottom_hit.append(hitmask)

        stats.config_time_s = sum(s.time_s for s in stats.stages)
        self._configured = True
        self.config_stats = stats
        return stats

    @staticmethod
    def _req_of(layer_req, mem, plan, l, target):
        members = plan.group_members(mem, l)
        t = members.index(target)
        return layer_req[mem][t]

    # -- reduce (values only; indices hard-coded in maps, paper §IV-A) --------
    def reduce(self, out_values: Sequence[np.ndarray]) -> List[np.ndarray]:
        """The paper's ``reduce``: run the frozen schedule on new values,
        returning each node's requested rows (message-level reference)."""
        assert self._configured, "call config() first"
        plan, m, w = self.plan, self.m, self.w
        stats = ReduceStats()

        def vshape(n):
            return (n, w) if w > 1 else (n,)

        # coalesce user values onto sorted-unique slots
        cur: List[np.ndarray] = []
        for n in range(m):
            v = np.zeros(vshape(len(self.out_sorted[n])), np.float64)
            np.add.at(v, self.out_user_to_sorted[n],
                      np.asarray(out_values[n], np.float64))
            cur.append(v)

        # down: scatter-reduce through the layers
        for l in range(plan.depth):
            k = plan.degrees[l]
            st = StageStats(layer=l, phase="down")
            nxt: List = [None] * m
            for n in range(m):
                members = plan.group_members(n, l)
                t_self = members.index(n)
                src_slices, inv, uniq = self.down_maps[l][n]
                pieces = []
                for mem in members:
                    mcuts = np.searchsorted(
                        np.asarray(self._down_idx_cache[l][mem], np.uint64),
                        plan.edges_at(mem, l).astype(np.uint64))
                    pieces.append(cur[mem][mcuts[t_self]:mcuts[t_self + 1]])
                    if mem != n:
                        nb = (mcuts[t_self + 1] - mcuts[t_self]) * BYTES_VAL * w * self.r
                        st.num_messages += self.r
                        st.total_bytes += nb
                        st.max_msg_bytes = max(st.max_msg_bytes, nb)
                cat = np.concatenate(pieces, axis=0) if pieces else \
                    np.zeros(vshape(0), np.float64)
                summed = np.zeros(vshape(len(uniq)), np.float64)
                np.add.at(summed, inv, cat)
                nxt[n] = summed
            cur = nxt
            tmax = 0.0
            for n in range(m):
                t_comm = self.fabric.stage_time(st.max_msg_bytes, (k - 1) * self.r)
                t_merge = cur[n].shape[0] * max(np.log2(max(k, 2)), 1.0) \
                    * self.merge_ns * 1e-9
                tmax = max(tmax, t_comm + t_merge)
            st.time_s = tmax
            stats.stages.append(st)

        # bottom lookup: values for requested indices (0 where absent)
        up: List[np.ndarray] = []
        for n in range(m):
            want = self.in_at[plan.depth][n]
            v = np.zeros(vshape(len(want)), np.float64)
            if len(self.bottom_idx[n]):
                got = cur[n][self.bottom_pos[n]]
                mask = self.bottom_hit[n]
                v[mask] = got[mask]
            up.append(v)

        # up: allgather back through the same nodes (nested, paper §IV-A)
        for l in reversed(range(plan.depth)):
            k = plan.degrees[l]
            st = StageStats(layer=l, phase="up")
            nxt: List = [None] * m
            for n in range(m):
                members = plan.group_members(n, l)
                own_idx = self.in_at[l][n]
                v = np.zeros(vshape(len(own_idx)), np.float64)
                edges = plan.edges_at(n, l).astype(np.uint64)
                cuts = np.searchsorted(own_idx.astype(np.uint64), edges)
                for t, mem in enumerate(members):
                    pos = self.ret_pos[l][n][t]
                    piece_vals = up[mem][pos]
                    v[cuts[t]:cuts[t + 1]] = piece_vals
                    if mem != n:
                        nb = len(pos) * BYTES_VAL * w * self.r
                        st.num_messages += self.r
                        st.total_bytes += nb
                        st.max_msg_bytes = max(st.max_msg_bytes, nb)
                nxt[n] = v
            up = nxt
            st.time_s = self.fabric.stage_time(st.max_msg_bytes, (k - 1) * self.r)
            stats.stages.append(st)

        # back to user order
        out = []
        for n in range(m):
            out.append(np.asarray(up[n][self.in_sorted_to_user[n]]))
        stats.reduce_time_s = sum(s.time_s for s in stats.stages)
        self.reduce_stats = stats
        return out

    # cache of per-layer sorted out-idx (needed to re-slice values on reduce)
    @property
    def _down_idx_cache(self):
        if not hasattr(self, "_didx"):
            cache = [list(self.out_sorted)]
            for l in range(self.plan.depth):
                cache.append([self.down_maps[l][n][2] for n in range(self.m)])
            self._didx = cache
        return self._didx


def dense_oracle(out_indices, out_values, in_indices, perm: HashPerm,
                 space_total=None, width: int = 1):
    """Ground truth: dense sum over the hashed space, then gather."""
    all_h = [perm.fwd_np(np.asarray(i, np.uint32)) for i in out_indices]
    acc: Dict[int, np.ndarray] = {}
    for h, v in zip(all_h, out_values):
        v = np.asarray(v, np.float64)
        for j in range(len(h)):
            key = int(h[j])
            acc[key] = acc.get(key, 0) + v[j]
    outs = []
    for idx in in_indices:
        h = perm.fwd_np(np.asarray(idx, np.uint32))
        if width > 1:
            o = np.stack([np.asarray(acc.get(int(x), np.zeros(width)), np.float64)
                          for x in h]) if len(h) else np.zeros((0, width))
        else:
            o = np.array([acc.get(int(x), 0.0) for x in h], np.float64)
        outs.append(o)
    return outs
