"""Adapter placement plane: which servers host which adapters.

The paper's rank-aware scheduler (sec 5, Algorithm 1) filters candidate
servers by "hosts the adapter" — a filter that is vacuous when every server
registers every adapter (the seed cluster's setting). This module makes the
fleet actually sharded: a ``PlacementPolicy`` assigns each registered adapter
to a *subset* of servers, and the ``Placement`` runtime map is the routing
source of truth that the ``Cluster`` consults, mutates on register-on-miss,
and rebalances from the admission plane's popularity EWMA over simulated
time (S-LoRA-style multi-replica serving, arXiv 2311.03285; replication of
hot adapters per the heterogeneous-LoRA placement line of work).

Policies:

* ``full``        — every adapter on every server (the seed behaviour; the
                    memory-unconstrained oracle baseline).
* ``hash``        — stable uid hash -> ``replication`` consecutive servers.
                    Popularity-blind: a hot adapter's single replica
                    concentrates its traffic on one server.
* ``rank_balanced`` — greedy bin packing by adapter rank: each replica goes
                    to the server with the least accumulated rank mass, so
                    the per-server device-pool/link burden is even even when
                    ranks are heterogeneous.
* ``popularity``  — popularity-aware k-way replication: every adapter gets a
                    base replica (rank-balanced), and hot adapters get extra
                    replicas proportional to their share of traffic, so the
                    scheduler can spread a hot adapter's load across servers.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set

from repro_torch.core.lora import AdapterSpec


def _stable_hash(uid: str) -> int:
    """Deterministic across processes (unlike builtin hash of str)."""
    return zlib.crc32(uid.encode("utf-8"))


def replica_target(share: float, n_servers: int, spread: float,
                   cap: Optional[int] = None) -> int:
    """Replica count for an adapter carrying `share` of the traffic:
    ``ceil(share * n_servers * spread)``, at least 1, capped. The single
    replica-target law — PopularityPlacement's initial assignment and the
    cluster's runtime rebalance both use it, so they target the same
    counts."""
    cap = min(cap or n_servers, n_servers)
    return max(1, min(cap, math.ceil(share * n_servers * spread)))


class Placement:
    """Runtime adapter->servers map. Mutable: the cluster adds replicas on
    register-on-miss and the rebalance pass adds/drops replicas over time."""

    def __init__(self, assignment: Mapping[str, Iterable[int]],
                 n_servers: int):
        self.n_servers = n_servers
        self._hosts: Dict[str, Set[int]] = {
            uid: set(srvs) for uid, srvs in assignment.items()}
        for uid, srvs in self._hosts.items():
            if not all(0 <= i < n_servers for i in srvs):
                raise ValueError(
                    f"placement of {uid!r} names out-of-range servers "
                    f"{srvs} (n_servers={n_servers})")

    def hosts(self, uid: str) -> List[int]:
        return sorted(self._hosts.get(uid, ()))

    def n_replicas(self, uid: str) -> int:
        return len(self._hosts.get(uid, ()))

    def add_replica(self, uid: str, server: int) -> bool:
        s = self._hosts.setdefault(uid, set())
        if server in s:
            return False
        s.add(server)
        return True

    def drop_replica(self, uid: str, server: int) -> bool:
        """Remove a replica from the routing map (never below one). The host
        store keeps the weights — dropping only stops new routes."""
        s = self._hosts.get(uid)
        if s is None or server not in s or len(s) <= 1:
            return False
        s.discard(server)
        return True

    def server_adapters(self, server: int) -> List[str]:
        return sorted(u for u, s in self._hosts.items() if server in s)

    def total_replicas(self) -> int:
        return sum(len(s) for s in self._hosts.values())


# ------------------------------------------------------------ policies ----

class PlacementPolicy:
    name = "base"

    def assign(self, specs: Sequence[AdapterSpec], n_servers: int,
               popularity: Optional[Mapping[str, float]] = None,
               ) -> Placement:
        raise NotImplementedError


class FullReplication(PlacementPolicy):
    name = "full"

    def assign(self, specs, n_servers, popularity=None) -> Placement:
        return Placement({sp.uid: range(n_servers) for sp in specs},
                         n_servers)


class HashPlacement(PlacementPolicy):
    name = "hash"

    def __init__(self, replication: int = 1):
        if replication < 1:
            raise ValueError(f"replication must be >= 1, got {replication}")
        self.replication = replication

    def assign(self, specs, n_servers, popularity=None) -> Placement:
        r = min(self.replication, n_servers)
        out = {}
        for sp in specs:
            start = _stable_hash(sp.uid) % n_servers
            out[sp.uid] = {(start + k) % n_servers for k in range(r)}
        return Placement(out, n_servers)


class RankBalancedPlacement(PlacementPolicy):
    """Greedy bin packing: heaviest (highest-rank) adapters first, each
    replica onto the server with the least accumulated rank mass."""
    name = "rank_balanced"

    def __init__(self, replication: int = 1):
        if replication < 1:
            raise ValueError(f"replication must be >= 1, got {replication}")
        self.replication = replication

    def assign(self, specs, n_servers, popularity=None) -> Placement:
        r = min(self.replication, n_servers)
        load = [0.0] * n_servers
        out: Dict[str, Set[int]] = {}
        # sort by rank desc, uid-hash tiebreak for determinism
        for sp in sorted(specs, key=lambda s: (-s.rank, _stable_hash(s.uid))):
            chosen: Set[int] = set()
            for _ in range(r):
                i = min((j for j in range(n_servers) if j not in chosen),
                        key=lambda j: load[j])
                chosen.add(i)
                load[i] += sp.rank
            out[sp.uid] = chosen
        return Placement(out, n_servers)


class PopularityPlacement(PlacementPolicy):
    """Popularity-aware k-way replication. Every adapter gets one replica
    (rank-balanced); an adapter carrying share ``p`` of the traffic gets
    ``ceil(p * n_servers * spread)`` replicas, capped at ``max_replicas``
    (default: the whole fleet) — so the handful of MAF-hot adapters are
    spread while the long tail stays single-replica."""
    name = "popularity"

    def __init__(self, spread: float = 1.0,
                 max_replicas: Optional[int] = None):
        self.spread = spread
        self.max_replicas = max_replicas

    def assign(self, specs, n_servers, popularity=None) -> Placement:
        popularity = popularity or {}
        total = sum(popularity.values()) or 1.0
        cap = min(self.max_replicas or n_servers, n_servers)
        # expected load a replica of this adapter puts on its server:
        # traffic share (split across replicas) weighted by rank, floored
        # by the uniform share so adapters absent from the prior still
        # spread rank-balanced instead of piling onto one server
        floor = 1.0 / max(len(specs), 1)
        load = [0.0] * n_servers
        out: Dict[str, Set[int]] = {}
        order = sorted(specs, key=lambda s: (-popularity.get(s.uid, 0.0),
                                             -s.rank, _stable_hash(s.uid)))
        for sp in order:
            share = popularity.get(sp.uid, 0.0) / total
            k = replica_target(share, n_servers, self.spread, cap)
            chosen: Set[int] = set()
            per_replica = (share / k + floor) * max(sp.rank, 1)
            for _ in range(k):
                i = min((j for j in range(n_servers) if j not in chosen),
                        key=lambda j: load[j])
                chosen.add(i)
                load[i] += per_replica
            out[sp.uid] = chosen
        return Placement(out, n_servers)


def make_placement_policy(name: str, **kw) -> PlacementPolicy:
    if name == "full":
        return FullReplication()
    if name == "hash":
        return HashPlacement(**kw)
    if name == "rank_balanced":
        return RankBalancedPlacement(**kw)
    if name == "popularity":
        return PopularityPlacement(**kw)
    raise ValueError(name)
