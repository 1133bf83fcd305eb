"""Switched network topology on one device (port of
``repro.core.topology``).

The paper's transport is not a dense crossbar: EXTOLL/Tourmalet routes
pulse packets hop by hop through a switched network (a 3-D torus with
dimension-ordered routing), and the follow-up scheme stacks chips behind
FPGAs behind one Tourmalet switch.  This module holds

* :class:`Topology`, the graph: ``direct`` (one crossbar), ``ring`` /
  ``torus2d`` / ``torus3d`` (wrap-around grids, one +/- port pair per
  dimension), ``switch_tree`` (chips -> FPGA -> switch) and ``pod``
  (chips on a pod-local crossbar behind an inter-pod graph), each with a
  latency per hop, a bandwidth and a credit budget per link;
* :func:`compile_routes`, the static forwarding state (numpy): next
  chip, egress port, hops and path latency per (source, destination),
  recompiled around dead chips and cut links when given a health mask;
* :func:`reference_link_words`, a numpy walk of those tables: the
  oracle of the per-port link counters;
* :class:`RoutedTransport`, the exchange of a block ``[n_chips(src),
  n_chips(dst), ...]`` through the topology, all chips at once.

The reference moves the slabs with one ``ppermute`` per relay round.  On
one device those rounds move nothing a single pass cannot: what arrives
is the dense exchange with each word's 8-bit timestamp shifted by the
path latency ``latency[src, dst]`` (and, on a degraded torus, the
sentinel for every pair the plan cannot reach), and every round moves
whole ``(src, dst)`` blocks, so each counter is a sum over blocks of
their valid-word counts.  So the exchange here is one transpose, one
elementwise shift, one reduction of the block to per-pair counts and an
``index_add_`` of those counts into the per-port counters.  Which pairs
feed which counter comes from running the reference's own round schedule
once per transport, in numpy, on block identities (:func:`_schedule`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core import transport as tp

I32 = torch.int32

# Port indices of the switch_tree (per chip; up ports count the words
# this chip injects toward its FPGA/switch, down ports the words
# delivered to it from them).
TREE_UP_CHIP = 0      # chip -> FPGA uplink
TREE_DOWN_CHIP = 1    # FPGA -> chip downlink
TREE_UP_TRUNK = 2     # this chip's share of the FPGA -> switch trunk
TREE_DOWN_TRUNK = 3   # this chip's share of the switch -> FPGA trunk

_KINDS = ("direct", "torus", "switch_tree", "pod")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A switched pulse-communication network over ``n_chips`` endpoints.

    ``link_latency``   -- steps per physical hop (a torus link, or the
                          chip <-> FPGA leaf link of the tree);
    ``trunk_latency``  -- steps per FPGA <-> switch hop (tree only);
    ``link_bandwidth`` -- words a link carries per step (0 = unbounded);
    ``link_credits``   -- words that may be in flight on a link within a
                          step (0 = unbounded).  The effective capacity is
                          the tighter of the two; words past it are
                          reported as ``link_backlog``, never dropped.

    Build one with the constructors below.
    """

    kind: str
    n_chips: int
    dims: tuple[int, ...] = ()        # torus grid (row-major, dim 0 outer)
    chips_per_group: int = 0          # switch_tree/pod: chips per FPGA/pod
    link_latency: int = 1
    trunk_latency: int = 1
    link_bandwidth: int = 0
    link_credits: int = 0
    pod_graph: "Topology | None" = None   # pod: the inter-pod network

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown topology kind {self.kind!r}")
        if self.n_chips < 1:
            raise ValueError("n_chips must be >= 1")
        if self.kind == "torus":
            if not self.dims or any(k < 1 for k in self.dims):
                raise ValueError("torus needs positive dims")
            if int(np.prod(self.dims)) != self.n_chips:
                raise ValueError(
                    f"dims {self.dims} do not tile n_chips={self.n_chips}")
        if self.kind == "switch_tree":
            m = self.chips_per_group
            if m < 1 or self.n_chips % m:
                raise ValueError(
                    f"chips_per_group {m} does not divide "
                    f"n_chips={self.n_chips}")
        if self.kind == "pod":
            pg = self.pod_graph
            if pg is None or pg.kind == "pod":
                raise ValueError("pod topology needs a non-pod pod_graph")
            m = self.chips_per_group
            if m < 1 or pg.n_chips * m != self.n_chips:
                raise ValueError(
                    f"{pg.n_chips} pods x {m} chips do not tile "
                    f"n_chips={self.n_chips}")
        if self.link_latency < 0 or self.trunk_latency < 0:
            raise ValueError("latencies must be >= 0")

    @property
    def n_groups(self) -> int:
        if self.kind != "switch_tree":
            raise ValueError(
                f"n_groups is only defined for switch_tree topologies, "
                f"not {self.kind!r}")
        return self.n_chips // self.chips_per_group

    @property
    def n_pods(self) -> int:
        if self.kind != "pod":
            raise ValueError(
                f"n_pods is only defined for pod topologies, "
                f"not {self.kind!r}")
        return self.pod_graph.n_chips

    @property
    def n_ports(self) -> int:
        """Ports per chip: the last axis of the per-chip link stats."""
        if self.kind == "direct":
            return 1
        if self.kind == "torus":
            return 2 * len(self.dims)
        if self.kind == "pod":
            return 1 + self.pod_graph.n_ports
        return 4

    @property
    def port_names(self) -> tuple[str, ...]:
        if self.kind == "direct":
            return ("net",)
        if self.kind == "torus":
            return tuple(
                f"dim{i}{s}" for i in range(len(self.dims)) for s in "+-")
        if self.kind == "pod":
            return ("pod_local",) + tuple(
                f"pod_{p}" for p in self.pod_graph.port_names)
        return ("up_chip", "down_chip", "up_trunk", "down_trunk")

    @property
    def link_capacity(self) -> int:
        """Effective words/step/link cap (0 = unbounded): the tighter of
        bandwidth and credits."""
        caps = [c for c in (self.link_bandwidth, self.link_credits) if c > 0]
        return min(caps) if caps else 0

    def transport(self, axis: "str | tuple[str, str]", *,
                  mesh) -> "RoutedTransport":
        """A :class:`RoutedTransport` across the ranks of ``mesh`` along
        ``axis`` (the shard forms; the fabric binds the local exchange
        itself when handed a Topology).  ``kind="pod"`` also takes a
        2-tuple ``(pod_axis, chip_axis)``, whose exchange is then
        hierarchical."""
        if isinstance(axis, tuple):
            if self.kind != "pod" or len(axis) != 2:
                raise TypeError(
                    "non-pod topologies take a single axis name; a 2-tuple "
                    "(pod_axis, chip_axis) is only valid for kind='pod'")
        elif not isinstance(axis, str):
            raise TypeError("Topology.transport takes a single axis name; "
                            "the topology models the hierarchy")
        return RoutedTransport(topology=self, base=tp.DistributedTransport(
            mesh=mesh, axis=axis, n_chips=self.n_chips))


def direct(n_chips: int, *, link_latency: int = 1, link_bandwidth: int = 0,
           link_credits: int = 0) -> Topology:
    """One crossbar: every chip one hop from every other."""
    return Topology(kind="direct", n_chips=n_chips, link_latency=link_latency,
                    link_bandwidth=link_bandwidth, link_credits=link_credits)


def ring(n_chips: int, **link) -> Topology:
    """Bidirectional ring (a 1-D torus)."""
    return Topology(kind="torus", n_chips=n_chips, dims=(n_chips,), **link)


def torus2d(nx: int, ny: int, **link) -> Topology:
    return Topology(kind="torus", n_chips=nx * ny, dims=(nx, ny), **link)


def torus3d(nx: int, ny: int, nz: int, **link) -> Topology:
    """The EXTOLL Tourmalet's own fabric: a 3-D wrap-around grid."""
    return Topology(kind="torus", n_chips=nx * ny * nz, dims=(nx, ny, nz),
                    **link)


def switch_tree(n_groups: int, chips_per_group: int, *, link_latency: int = 1,
                trunk_latency: int = 1, link_bandwidth: int = 0,
                link_credits: int = 0) -> Topology:
    """The paper's stack: ``chips_per_group`` chips behind one FPGA,
    ``n_groups`` FPGAs behind one Tourmalet switch.  Same group: chip ->
    FPGA -> chip (2 leaf hops); across groups: chip -> FPGA -> switch ->
    FPGA -> chip (2 leaf + 2 trunk hops)."""
    return Topology(kind="switch_tree", n_chips=n_groups * chips_per_group,
                    chips_per_group=chips_per_group,
                    link_latency=link_latency, trunk_latency=trunk_latency,
                    link_bandwidth=link_bandwidth, link_credits=link_credits)


def pod(pod_graph: Topology, chips_per_pod: int, *, link_latency: int = 1,
        link_bandwidth: int = 0, link_credits: int = 0) -> Topology:
    """``chips_per_pod`` chips on a dense pod-local crossbar, the pods
    joined by ``pod_graph``.  Chip c lives in pod ``c // chips_per_pod``
    at member lane ``c % chips_per_pod``; cross-pod slabs move member
    lanes in lockstep, so pod-link words are billed to the member lane
    that carries them."""
    return Topology(kind="pod", n_chips=pod_graph.n_chips * chips_per_pod,
                    chips_per_group=chips_per_pod, pod_graph=pod_graph,
                    link_latency=link_latency, link_bandwidth=link_bandwidth,
                    link_credits=link_credits)


# ---------------------------------------------------------------------------
# Route compiler (numpy)
# ---------------------------------------------------------------------------

class RoutePlan(NamedTuple):
    """Static routing state of a :class:`Topology`, all ``[n, n]`` int32
    but ``coords``.

    port    : egress port at chip c toward d (-1 when c == d or d is
              unreachable)
    next    : next chip on the c -> d route (d itself on the tree and the
              pod, whose FPGA/switch/pod hops are not endpoints)
    hops    : links traversed c -> d (-1 when unreachable)
    latency : modeled steps c -> d
    coords  : int32[n, k] torus grid coordinates (a zero column otherwise;
              group and member for the tree and the pod)
    """

    port: np.ndarray
    next: np.ndarray
    hops: np.ndarray
    latency: np.ndarray
    coords: np.ndarray


def normalize_healthy(n_chips: int, healthy) -> tuple[int, ...] | None:
    """An alive-chip set as a sorted tuple of chip indices (None: all
    alive).  Takes None, chip indices or a bool mask of length
    ``n_chips``."""
    if healthy is None:
        return None
    arr = np.asarray(healthy)
    if arr.dtype == bool:
        if arr.shape != (n_chips,):
            raise ValueError(
                f"healthy mask shape {arr.shape} != ({n_chips},)")
        idx = np.nonzero(arr)[0]
    else:
        idx = np.unique(arr.astype(np.int64))
    if idx.size and (idx[0] < 0 or idx[-1] >= n_chips):
        raise ValueError(f"healthy chip index out of range 0..{n_chips - 1}")
    if idx.size == n_chips:
        return None
    return tuple(int(c) for c in idx)


def normalize_dead_links(dead_links) -> tuple[tuple[int, int], ...]:
    """A cut-link set as sorted (chip, port) pairs."""
    return tuple(sorted((int(c), int(p)) for c, p in dead_links))


def compile_routes(topo: Topology, healthy=None,
                   dead_links=()) -> RoutePlan:
    """Dimension-ordered routing for tori (dim 0 first, the shorter ring
    direction, ties forward), up/down routing for the tree.  With
    ``healthy`` or ``dead_links`` ((chip, port) pairs, cut both ways) the
    tables are recompiled around the failures (:func:`_degraded_routes`);
    with nothing dead the baseline plan is returned."""
    healthy = normalize_healthy(topo.n_chips, healthy)
    dead_links = normalize_dead_links(dead_links)
    if dead_links and not all(
            0 <= c < topo.n_chips and 0 <= p < topo.n_ports
            for c, p in dead_links):
        raise ValueError(f"dead link out of range: {dead_links}")
    if healthy is None and not dead_links:
        return _baseline_routes(topo)
    return _degraded_routes(topo, healthy, dead_links)


@functools.lru_cache(maxsize=None)
def _baseline_routes(topo: Topology) -> RoutePlan:
    n = topo.n_chips
    i32 = np.int32
    port = np.full((n, n), -1, i32)
    nxt = np.tile(np.arange(n, dtype=i32), (n, 1))
    hops = np.zeros((n, n), i32)
    lat = np.zeros((n, n), i32)

    if topo.kind == "direct":
        off = ~np.eye(n, dtype=bool)
        port[off] = 0
        hops[off] = 1
        lat[off] = topo.link_latency
        coords = np.zeros((n, 1), i32)
    elif topo.kind == "switch_tree":
        m = topo.chips_per_group
        grp = np.arange(n) // m
        off = ~np.eye(n, dtype=bool)
        cross = grp[:, None] != grp[None, :]
        port[off] = TREE_UP_CHIP          # the first hop is chip -> FPGA
        hops[off] = 2
        hops[cross] = 4
        lat[off] = 2 * topo.link_latency
        lat[cross] = 2 * topo.link_latency + 2 * topo.trunk_latency
        coords = np.stack([grp, np.arange(n) % m], axis=1).astype(i32)
    elif topo.kind == "pod":
        # Same pod: one crossbar hop.  Across pods: crossbar out, the pod
        # graph's path, crossbar in; the pod-graph port is offset past
        # "pod_local".
        m = topo.chips_per_group
        pp = compile_routes(topo.pod_graph)
        grp = np.arange(n) // m
        off = ~np.eye(n, dtype=bool)
        gs, gd = grp[:, None], grp[None, :]
        cross = gs != gd
        intra = off & ~cross
        port[intra] = 0
        port[cross] = 1 + pp.port[gs, gd][cross]
        hops[intra] = 1
        hops[cross] = (2 + pp.hops[gs, gd])[cross]
        lat[intra] = topo.link_latency
        lat[cross] = (2 * topo.link_latency + pp.latency[gs, gd])[cross]
        coords = np.stack([grp, np.arange(n) % m], axis=1).astype(i32)
    else:   # torus: every pairwise table over [n, n, ndims]
        dims = np.asarray(topo.dims)
        coords = np.stack(
            np.unravel_index(np.arange(n), topo.dims), axis=1).astype(i32)
        delta = (coords[None, :, :] - coords[:, None, :]) % dims
        hops = np.minimum(delta, dims - delta).sum(axis=2).astype(i32)
        lat = (hops * topo.link_latency).astype(i32)
        first = np.argmax(delta != 0, axis=2)
        d1 = np.take_along_axis(delta, first[:, :, None], axis=2)[:, :, 0]
        k1 = dims[first]
        fwd = d1 <= k1 // 2
        stepped = np.broadcast_to(coords[:, None, :], delta.shape).copy()
        newc = (np.take_along_axis(stepped, first[:, :, None], axis=2)
                [:, :, 0] + np.where(fwd, 1, -1)) % k1
        np.put_along_axis(stepped, first[:, :, None], newc[:, :, None],
                          axis=2)
        off = hops > 0
        port = np.where(off, 2 * first + np.where(fwd, 0, 1), -1).astype(i32)
        nxt = np.where(
            off,
            np.ravel_multi_index(tuple(np.moveaxis(stepped, 2, 0)),
                                 topo.dims),
            np.arange(n)[:, None]).astype(i32)
    return RoutePlan(port=port, next=nxt, hops=hops, latency=lat,
                     coords=coords)


def _torus_neighbors(topo: Topology) -> np.ndarray:
    """int64[n, 2*ndims]: the chip behind each torus port (2i = dim i
    forward, 2i+1 = backward)."""
    n, dims = topo.n_chips, topo.dims
    nbr = np.zeros((n, 2 * len(dims)), np.int64)
    for c in range(n):
        cc = np.array(np.unravel_index(c, dims))
        for i in range(len(dims)):
            for j, delta in ((0, +1), (1, -1)):
                s = cc.copy()
                s[i] = (s[i] + delta) % dims[i]
                nbr[c, 2 * i + j] = np.ravel_multi_index(tuple(s), dims)
    return nbr


def alive_mask(n: int, healthy) -> np.ndarray:
    """bool[n]: the chips of a normalized alive set (all for None)."""
    alive = np.ones(n, bool)
    if healthy is not None:
        alive[:] = False
        alive[list(healthy)] = True
    return alive


@functools.lru_cache(maxsize=None)
def tree_carriers(topo: Topology, healthy=None,
                  dead_links=()) -> tuple[np.ndarray, np.ndarray]:
    """The switch tree's trunk-share carriers under failure, ``(up,
    down)`` int64[n]: the group sibling whose FPGA <-> switch share
    carries chip c's cross-group words (c itself when its own share is
    live, else the lowest-indexed healthy sibling with a live share, -1
    when the whole group lost its trunk).  The trunk counters and
    :func:`reference_link_words` bill cross-group words to the
    carrier."""
    if topo.kind != "switch_tree":
        raise ValueError("tree_carriers needs a switch_tree topology")
    n, m = topo.n_chips, topo.chips_per_group
    alive = alive_mask(n, healthy)
    tu, td = alive.copy(), alive.copy()
    for c, p in dead_links:
        if p == TREE_UP_TRUNK:
            tu[c] = False
        elif p == TREE_DOWN_TRUNK:
            td[c] = False
    out = []
    for ok in (tu, td):
        carrier = np.full(n, -1, np.int64)
        for g in range(n // m):
            members = np.arange(g * m, (g + 1) * m)
            live = members[ok[members]]
            for c in members:
                if ok[c]:
                    carrier[c] = c
                elif live.size:
                    carrier[c] = live[0]
        out.append(carrier)
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _degraded_routes(topo: Topology, healthy, dead_links) -> RoutePlan:
    """Forwarding state on the surviving graph.  torus: BFS shortest
    paths around dead chips and cut links (ties: lowest port).
    switch_tree: a lost leaf link isolates the chip in that direction, a
    lost trunk share is re-homed through a sibling.  direct: endpoint
    masking (a cut of its one port isolates the chip).  pod: endpoint
    masking only (the pod fabric outlives chip deaths), link cuts
    refused."""
    n = topo.n_chips
    i32 = np.int32
    alive = alive_mask(n, healthy)
    base = _baseline_routes(topo)
    coords = base.coords
    port = np.full((n, n), -1, i32)
    nxt = np.tile(np.arange(n, dtype=i32), (n, 1))
    hops = np.full((n, n), -1, i32)
    np.fill_diagonal(hops, 0)
    lat = np.zeros((n, n), i32)

    if topo.kind == "direct":
        cut = np.zeros(n, bool)
        for c, _ in dead_links:
            cut[c] = True
        ok = alive & ~cut
        reach = ok[:, None] & ok[None, :] & ~np.eye(n, dtype=bool)
        port[reach] = 0
        hops[reach] = 1
        lat[reach] = topo.link_latency
    elif topo.kind == "torus":
        nbr = _torus_neighbors(topo)
        n_ports = nbr.shape[1]
        link_ok = np.ones((n, n_ports), bool)
        for c, p in dead_links:
            link_ok[c, p] = False
            link_ok[nbr[c, p], p ^ 1] = False     # cut both directions
        edge = link_ok & alive[:, None] & alive[nbr]
        for d in np.nonzero(alive)[0]:
            dist = np.full(n, -1, np.int64)
            dist[d] = 0
            frontier = [d]
            while frontier:
                nxt_frontier = []
                for u in frontier:
                    for p in range(n_ports):
                        v = nbr[u, p]
                        if edge[u, p] and dist[v] < 0:
                            dist[v] = dist[u] + 1
                            nxt_frontier.append(v)
                frontier = nxt_frontier
            for c in np.nonzero(alive & (dist > 0))[0]:
                for p in range(n_ports):
                    if edge[c, p] and dist[nbr[c, p]] == dist[c] - 1:
                        port[c, d] = p
                        nxt[c, d] = nbr[c, p]
                        hops[c, d] = dist[c]
                        lat[c, d] = dist[c] * topo.link_latency
                        break
    elif topo.kind == "switch_tree":
        m = topo.chips_per_group
        grp = np.arange(n) // m
        up, down = alive.copy(), alive.copy()
        for c, p in dead_links:
            if p == TREE_UP_CHIP:
                up[c] = False
            elif p == TREE_DOWN_CHIP:
                down[c] = False
        cu, cd = tree_carriers(topo, healthy, dead_links)
        same = grp[:, None] == grp[None, :]
        reach = ((alive & up)[:, None] & (alive & down)[None, :]
                 & ~np.eye(n, dtype=bool))
        reach &= same | ((cu >= 0)[:, None] & (cd >= 0)[None, :])
        cross = reach & ~same
        port[reach] = TREE_UP_CHIP
        hops[reach] = 2
        hops[cross] = 4
        lat[reach] = 2 * topo.link_latency
        lat[cross] = 2 * topo.link_latency + 2 * topo.trunk_latency
    else:   # pod
        if dead_links:
            raise ValueError(
                "per-chip link cuts are not modeled for pod topologies "
                "(the pod fabric is shared); kill chips instead")
        reach = alive[:, None] & alive[None, :] & ~np.eye(n, dtype=bool)
        port = np.where(reach, base.port, -1).astype(i32)
        hops = np.where(reach | np.eye(n, dtype=bool), base.hops,
                        -1).astype(i32)
        lat = np.where(reach, base.latency, 0).astype(i32)
    return RoutePlan(port=port, next=nxt, hops=hops, latency=lat,
                     coords=coords)


def reference_link_words(topo: Topology, traffic: np.ndarray, healthy=None,
                         dead_links=()) -> np.ndarray:
    """Per-chip, per-port word counts for ``traffic[s, d]`` (words chip s
    offers to chip d), int64[n_chips, n_ports]: every link a word
    crosses, billed at the chip that drives it (down ports: the chip it
    reaches).  Degraded: words walk the detour tables, tree trunk words
    go to the re-homed carrier, unreachable pairs count nothing.  Pods:
    ``pod_local`` counts words leaving their source member lane, the
    pod-graph ports recurse onto the pod graph per destination lane."""
    healthy = normalize_healthy(topo.n_chips, healthy)
    dead_links = normalize_dead_links(dead_links)
    plan = compile_routes(topo, healthy, dead_links)
    n = topo.n_chips
    out = np.zeros((n, topo.n_ports), np.int64)
    if topo.kind == "switch_tree":
        cu, cd = tree_carriers(topo, healthy, dead_links)
    if topo.kind == "pod":
        m, npods = topo.chips_per_group, topo.n_pods
        lanes = [np.zeros((npods, npods), np.int64) for _ in range(m)]
    for s in range(n):
        for d in range(n):
            w = int(traffic[s, d])
            if s == d or w == 0 or plan.hops[s, d] <= 0:
                continue
            if topo.kind == "switch_tree":
                out[s, TREE_UP_CHIP] += w
                out[d, TREE_DOWN_CHIP] += w
                if s // topo.chips_per_group != d // topo.chips_per_group:
                    out[cu[s], TREE_UP_TRUNK] += w
                    out[cd[d], TREE_DOWN_TRUNK] += w
            elif topo.kind == "pod":
                if s % m != d % m:
                    out[s, 0] += w
                if s // m != d // m:
                    lanes[d % m][s // m, d // m] += w
            else:
                c = s
                while c != d:
                    out[c, plan.port[c, d]] += w
                    c = int(plan.next[c, d])
    if topo.kind == "pod":
        for mm in range(m):
            sub = reference_link_words(topo.pod_graph, lanes[mm])
            out[np.arange(npods) * m + mm, 1:] += sub
    return out


# ---------------------------------------------------------------------------
# The reference's round schedule, run once on block identities (numpy)
# ---------------------------------------------------------------------------

class _Tally:
    """The counter terms of one exchange: ``words`` entries (counter,
    pair) add a pair's valid-word count to counter ``chip * n_ports +
    port``; each backlog group adds ``max(sum over its pairs - cap *
    flush_rounds, 0)`` to its counter, ``cap`` the link capacity of the
    level that bills it (a pod's crossbar or its pod graph; a group of
    an unbounded level is left out).  Pairs are ``src * n + dst``."""

    def __init__(self, n_ports: int):
        self.n_ports = n_ports
        self.w_target, self.w_pair = [], []
        self.g_target, self.g_member, self.g_pair, self.g_cap = [], [], [], []
        self.n_groups = 0

    @staticmethod
    def _entries(ids):
        """The (device, pair) entries of ``ids [n_dev, ...]`` (pair ids,
        -1 empty), and the devices."""
        flat = ids.reshape(ids.shape[0], -1)
        dev, pos = np.nonzero(flat >= 0)
        return dev, flat[dev, pos], np.arange(flat.shape[0])

    def words(self, port: int, ids: np.ndarray):
        dev, pair, _ = self._entries(ids)
        self.w_target.append(dev * self.n_ports + port)
        self.w_pair.append(pair)

    def group(self, port: int, ids: np.ndarray, cap: int):
        """One backlog group per device, over that device's pairs."""
        if not cap:
            return
        dev, pair, devs = self._entries(ids)
        self.g_member.append(self.n_groups + dev)
        self.g_pair.append(pair)
        self.g_target.append(devs * self.n_ports + port)
        self.g_cap.append(np.full(len(devs), cap))
        self.n_groups += len(devs)

    def count(self, port: int, ids: np.ndarray, cap: int):
        """One billing of the reference (a relay round, or a per-exchange
        total): the words of ``ids`` per device, and one backlog group per
        device judged on their sum."""
        self.words(port, ids)
        self.group(port, ids, cap)

    def arrays(self):
        cat = lambda xs: (np.concatenate(xs) if xs  # noqa: E731
                          else np.zeros(0, np.int64)).astype(np.int64)
        return (cat(self.w_target), cat(self.w_pair), cat(self.g_target),
                cat(self.g_member), cat(self.g_pair), cat(self.g_cap))


def _permute(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """``ppermute`` over the device axis: device ``perm[i]`` receives
    device i's slab (every perm here is a bijection)."""
    out = np.empty_like(x)
    out[perm] = x
    return out


def _expand(perm: np.ndarray, bs: int) -> np.ndarray:
    """An endpoint permutation on a device axis of ``bs`` lanes per
    endpoint (member lanes move in lockstep)."""
    if bs == 1:
        return perm
    return (perm[:, None] * bs + np.arange(bs)).reshape(-1)


def _ring_stage(buf, k, perm_f, perm_b, pos, tally, port_f, port_b, cap):
    """The reference's hop-by-hop ring exchange over axis 1 of ``buf
    [n_dev, k, ...]`` (``pos`` each device's ring position): each block
    goes the shorter way (ties forward), one neighbour permute a round,
    and each round's stream is billed to its port."""
    n_dev = buf.shape[0]
    dev = np.arange(n_dev)
    idx = np.arange(k)
    sel = lambda m: m.reshape(m.shape + (1,) * (buf.ndim - 2))  # noqa: E731
    out = np.full_like(buf, -1)
    out[dev, pos] = buf[dev, pos]
    for direction, span, perm, port in ((+1, k // 2, perm_f, port_f),
                                        (-1, (k - 1) // 2, perm_b, port_b)):
        dist = (direction * (idx[None, :] - pos[:, None])) % k
        stream = np.where(sel((dist >= 1) & (dist <= span)), buf, -1)
        for r in range(1, span + 1):
            tally.count(port, stream, cap)
            stream = _permute(stream, perm)
            out[dev, (pos - direction * r) % k] = stream[dev, pos]
            stream[dev, pos] = -1
    return out


def _dim_perm(topo: Topology, coords, dim: int, delta: int) -> np.ndarray:
    stepped = coords.copy()
    stepped[:, dim] = (stepped[:, dim] + delta) % topo.dims[dim]
    return np.ravel_multi_index(tuple(stepped.T), topo.dims)


def _run_schedule(topo, healthy, dead_links, x, tally, port0=0, bs=1):
    """Bill one exchange of ``x [n_dev, n_endpoints, ...]`` (pair ids) to
    ``tally``, on ports offset by ``port0``; ``bs`` devices share each
    endpoint (a pod's member lanes on its pod graph).  Mirrors
    ``RoutedTransport.exchange_words_start`` of the reference, counters
    only: the delivered contents are the dense exchange but on a degraded
    torus (see :meth:`RoutedTransport.exchange_words_start`)."""
    n = topo.n_chips
    n_dev = x.shape[0]
    cap = topo.link_capacity
    me = np.arange(n_dev) // bs
    plan = compile_routes(topo, healthy, dead_links)
    degraded = healthy is not None or bool(dead_links)
    own = np.arange(n)[None, :] == me[:, None]           # [n_dev, n]
    sel = lambda m: m.reshape(m.shape + (1,) * (x.ndim - 2))  # noqa: E731

    def dense(v):
        """The endpoint-level exchange, lanes in lockstep: device (q, i)
        receives endpoint q's slab from device (e, i) for every e."""
        dev = np.arange(n_dev)
        return v[np.arange(n)[None, :] * bs + (dev % bs)[:, None],
                 me[:, None]]

    if topo.kind == "direct":
        tally.count(port0, np.where(sel(~own), x, -1), cap)
    elif topo.kind == "torus" and not degraded:
        coords = plan.coords
        buf = x.reshape((n_dev,) + topo.dims + x.shape[2:])
        for i, k in enumerate(topo.dims):
            b = np.moveaxis(buf, 1 + i, 1)
            b = _ring_stage(
                b, k, _expand(_dim_perm(topo, coords, i, +1), bs),
                _expand(_dim_perm(topo, coords, i, -1), bs),
                coords[me, i], tally, port0 + 2 * i, port0 + 2 * i + 1, cap)
            buf = np.moveaxis(b, 1, 1 + i)
    elif topo.kind == "torus":
        # The reference's store-and-forward relay over the detour plan:
        # each device holds a cube [src, dst, ...] of blocks in flight;
        # every round, every port sends the blocks whose next hop from
        # here leaves on it.
        assert bs == 1
        nbr = _torus_neighbors(topo)
        cube = np.full((n_dev, n) + x.shape[1:], -1, x.dtype)
        cube[np.arange(n), np.arange(n)] = x
        for _ in range(int(max(plan.hops.max(), 0))):
            for p in range(nbr.shape[1]):
                e = (plan.port == p).reshape(
                    (n_dev, 1, n) + (1,) * (x.ndim - 2))
                send = np.where(e, cube, -1)
                tally.count(port0 + p, send, cap)
                cube = np.where(e, -1, cube)
                recv = _permute(send, nbr[:, p])
                cube = np.where(recv >= 0, recv, cube)
    elif topo.kind == "switch_tree":
        m = topo.chips_per_group
        cross = (np.arange(n)[None, :] // m) != (me // m)[:, None]
        y = dense(x)
        tally.count(port0 + TREE_UP_CHIP, np.where(sel(~own), x, -1), cap)
        tally.count(port0 + TREE_DOWN_CHIP, np.where(sel(~own), y, -1), cap)
        up, down = np.where(sel(cross), x, -1), np.where(sel(cross), y, -1)
        if degraded:
            # Trunk re-homing: a chip's cross-group words are billed to
            # its carrier.
            assert bs == 1
            cu, cd = tree_carriers(topo, healthy, dead_links)
            up = _rehome(up, cu)
            down = _rehome(down, cd)
        tally.count(port0 + TREE_UP_TRUNK, up, cap)
        tally.count(port0 + TREE_DOWN_TRUNK, down, cap)
    else:   # pod
        m, npods = topo.chips_per_group, topo.n_pods
        mymem = me % m
        tally.count(port0, np.where(
            sel((np.arange(n)[None, :] % m) != mymem[:, None]), x, -1), cap)
        # Stage 1, the pod-local crossbar: device (P, mm) ends up with
        # z[Q, i], the words of chip (P, i) for chip (Q, mm).
        dev = np.arange(n_dev)
        src = (dev // m)[:, None, None] * m + np.arange(m)[None, None, :]
        dst = np.arange(npods)[None, :, None] * m + mymem[:, None, None]
        z = x[src, dst]                                   # [n_dev, P, m, ..]
        _run_schedule(topo.pod_graph, None, (), z, tally, port0 + 1, bs=m)


def _rehome(ids: np.ndarray, carrier: np.ndarray) -> np.ndarray:
    """Each chip's slabs billed to ``carrier[chip]`` (-1: to nobody):
    device c gets the blocks of every chip it carries, concatenated."""
    n = ids.shape[0]
    flat = ids.reshape(n, -1)
    out = np.full((n, n * flat.shape[1]), -1, ids.dtype)
    for c in range(n):
        if carrier[c] >= 0:
            out[carrier[c], c * flat.shape[1]:(c + 1) * flat.shape[1]] = (
                flat[c])
    return out


@functools.lru_cache(maxsize=None)
def _schedule(topo: Topology, healthy, dead_links):
    """The counter terms of one exchange through ``topo`` (see
    :class:`_Tally`), as int64 numpy arrays."""
    n = topo.n_chips
    tally = _Tally(topo.n_ports)
    pairs = np.arange(n * n, dtype=np.int64).reshape(n, n)
    _run_schedule(topo, healthy, dead_links, pairs, tally)
    return tally.arrays() + (tally.n_groups,)


def _shift_word_time(words: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """Add ``dt`` steps to the 8-bit timestamp of every valid word
    (wrapping inside the time field; sentinels pass through)."""
    mask = ev.WORD_TIME_MASK
    t = (words + dt).bitwise_and_(mask)
    return torch.where(words >= 0, words.bitwise_and(~mask).bitwise_or_(t),
                       words)


class _DeviceTables(NamedTuple):
    """A transport's static tensors on one device."""

    w_target: torch.Tensor
    w_pair: torch.Tensor
    g_target: torch.Tensor
    g_member: torch.Tensor
    g_pair: torch.Tensor
    g_cap: "int | torch.Tensor"   # one capacity, or one per group
    n_groups: int
    dt: torch.Tensor | None       # int32[n(dst), n(src), 1]: lat[src, dst]
    reach: torch.Tensor | None    # bool[n(dst), n(src), 1], degraded torus


@dataclasses.dataclass(frozen=True)
class RoutedTransport:
    """The exchange through a :class:`Topology`, every chip at once.

    ``exchange_words(x)`` takes ``x [n_chips(src), n_chips(dst), ...]``
    (sentinel -1 = empty lane) and returns ``(y, link_words,
    link_backlog)``: ``y [n_chips(dst), n_chips(src), ...]`` the dense
    exchange with each valid word's timestamp shifted by the path latency,
    ``link_words`` and ``link_backlog`` int32
    ``[n_chips, n_ports]``, bitwise the reference's counters.  The
    trailing axes are free: a superstep's flush slab moves as B
    exchanges would.

    ``healthy`` / ``dead_links`` bind a degraded plan: on a torus the
    words follow the detours (and a pair the plan cannot reach arrives
    as the sentinel), on the tree trunk words are billed to the re-homed
    carrier.  Traffic of unreachable pairs is the caller's to cull (the
    fabric does, into ``lost_to_failure``).

    ``base`` (a :class:`repro_torch.core.transport.DistributedTransport`,
    from :meth:`Topology.transport`) spreads the chips over ranks: ``x``
    is then this rank's ``[n_local(src), n_chips(dst), ...]``, moved by
    the base's ``all_to_all``; each rank's per-pair counts are gathered
    into the full ``[n_chips, n_chips]`` by one ``all_gather``, the same
    tables give every chip's counters, and the rank keeps its own rows
    (so they are bitwise the single-device transport's rows).  The
    reach and the latency shift are sliced to the local destinations.
    """

    topology: Topology
    # Rounds of link capacity one exchange may use: a superstep flush of B
    # steps has B steps to drain (see with_flush_rounds).
    flush_rounds: int = 1
    healthy: "tuple[int, ...] | None" = None
    dead_links: tuple = ()
    base: "tp.DistributedTransport | None" = None

    def __post_init__(self):
        object.__setattr__(self, "healthy", normalize_healthy(
            self.topology.n_chips, self.healthy))
        object.__setattr__(self, "dead_links",
                           normalize_dead_links(self.dead_links))

    @property
    def n_chips(self) -> int:
        return self.topology.n_chips

    @property
    def n_local(self) -> int:
        return self.n_chips if self.base is None else self.base.n_local

    @property
    def rows(self) -> slice:
        """The global chips of the leading axis."""
        return slice(0, self.n_chips) if self.base is None else self.base.rows

    @property
    def degraded(self) -> bool:
        return self.healthy is not None or bool(self.dead_links)

    def with_health(self, healthy=None, dead_links=()) -> "RoutedTransport":
        """The same transport on the plan recompiled around the given
        failures (full health: the baseline plan)."""
        return dataclasses.replace(self, healthy=healthy,
                                   dead_links=dead_links)

    def with_flush_rounds(self, rounds: int) -> "RoutedTransport":
        """The same transport judging backlog against ``rounds`` rounds of
        capacity (a superstep flush of B steps); word counts are
        unaffected."""
        return dataclasses.replace(self, flush_rounds=rounds)

    @property
    def plan(self) -> RoutePlan:
        return compile_routes(self.topology, self.healthy, self.dead_links)

    @property
    def max_path_latency(self) -> int:
        """The longest modeled path latency, bounded by the fabric against
        the 8-bit wrap window."""
        return int(self.plan.latency.max())

    def _tables(self, device) -> _DeviceTables:
        return _device_tables(self.topology, self.healthy, self.dead_links,
                              torch.device(device))

    def exchange_words(self, x: torch.Tensor):
        """The serial composition of :meth:`exchange_words_start` and
        :meth:`exchange_words_finish`."""
        y, link_words, link_backlog = self.exchange_words_start(x)
        return self.exchange_words_finish(y), link_words, link_backlog

    def exchange_words_start(self, x: torch.Tensor):
        """Issue half: move the block (its timestamps still unshifted) and
        count the link words and backlog."""
        n, m, rows = self.n_chips, self.n_local, self.rows
        if x.shape[:2] != (m, n):
            raise ValueError(f"leading dims {tuple(x.shape[:2])} != "
                             f"(n_local, n_chips) = ({m}, {n})")
        tab = self._tables(x.device)
        if self.base is None:
            y = x.transpose(0, 1)
        else:
            y = self.base.all_to_all(x)
        if tab.reach is not None:
            y = torch.where(tab.reach[rows].view(
                (m, n) + (1,) * (x.dim() - 2)), y, ev.WORD_SENTINEL)
        p = self.topology.n_ports
        cnt = (x >= 0).flatten(2).sum(-1, dtype=I32)
        if self.base is not None:
            cnt = self.base.all_gather(cnt)
        cnt = cnt.flatten()
        words = torch.zeros(n * p, dtype=I32, device=x.device).index_add_(
            0, tab.w_target, cnt[tab.w_pair])
        backlog = torch.zeros_like(words)
        if tab.n_groups:
            sums = torch.zeros(tab.n_groups, dtype=I32,
                               device=x.device).index_add_(
                0, tab.g_member, cnt[tab.g_pair])
            backlog.index_add_(0, tab.g_target, sums.sub_(
                tab.g_cap * self.flush_rounds).clamp_(min=0))
        return y, words.view(n, p)[rows], backlog.view(n, p)[rows]

    def exchange_words_finish(self, y: torch.Tensor) -> torch.Tensor:
        """Complete half: shift each valid word's timestamp by its pair's
        path latency (clamped at 0, so an unreachable pair's words are not
        re-timed).  Uses this transport's plan."""
        dt = self._tables(y.device).dt
        if dt is None:
            return y
        n, m = self.n_chips, self.n_local
        return _shift_word_time(y, dt[self.rows].view(
            (m, n) + (1,) * (y.dim() - 2)))


@functools.lru_cache(maxsize=None)
def _device_tables(topo: Topology, healthy, dead_links,
                   device: torch.device) -> _DeviceTables:
    w_target, w_pair, g_target, g_member, g_pair, g_cap, n_groups = (
        _schedule(topo, healthy, dead_links))
    plan = compile_routes(topo, healthy, dead_links)
    on = lambda a, dt=torch.int64: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), dtype=dt, device=device)
    lat = np.maximum(plan.latency, 0)
    cube = (topo.kind == "torus" and (healthy is not None or bool(dead_links))
            and bool((plan.hops < 0).any()))
    return _DeviceTables(
        w_target=on(w_target), w_pair=on(w_pair), g_target=on(g_target),
        g_member=on(g_member), g_pair=on(g_pair),
        g_cap=(int(g_cap[0]) if len(set(g_cap.tolist())) == 1
               else on(g_cap, I32)), n_groups=n_groups,
        dt=on(lat.T, I32) if lat.max() else None,
        reach=on(plan.hops.T >= 0, torch.bool) if cube else None)
