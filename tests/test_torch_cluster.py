"""The port's cluster plane (core/{cluster,placement,faults}.py and the
`--cluster` CLI) against the reference's: timing-only fleets of four
servers (no numerics, no device) over the same traces, routed by each of
the four policies over each of the four placements, with rebalancing,
scripted chaos (crash and restart, flaky uploads, a brownout) and SLO
shedding. Every route, the summary, the fault log and the plane counters
must be equal: the simulators are plain Python on the same constants (the
port's servers and models are given the reference's V5E timeline
hardware), so there is no tolerance. Also the port's own invariants: the
event loop reproduces the lockstep oracle, chaos runs repeat and lose
nothing, and the CLI serves every request."""
import dataclasses
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from repro.configs.base import get_config as jget
from repro.core import cluster as jcluster
from repro.core import engine as jengine
from repro.core import faults as jfaults
from repro.core import perf_model as jperf
from repro.core import placement as jplace
from repro.core import scheduler as jsched
from repro.core.timing import V5E
from repro.launch import serve as jserve
from repro.traces import gen as jgen
from repro_torch.configs.base import get_config as tget
from repro_torch.core import cluster as tcluster
from repro_torch.core import engine as tengine
from repro_torch.core import faults as tfaults
from repro_torch.core import perf_model as tperf
from repro_torch.core import placement as tplace
from repro_torch.core import scheduler as tsched
from repro_torch.core.timing import Hardware
from repro_torch.launch import serve as tserve
from repro_torch.traces import gen as tgen

# the reference's timeline hardware, for the port's servers held to it
REF_HW = Hardware(**dataclasses.asdict(V5E))
POLICIES = ["rank_aware", "most_idle", "first_fit", "random"]
PLACEMENTS = ["full", "hash", "rank_balanced", "popularity"]

REF = SimpleNamespace(cfg=jget("llama2-7b"), cluster=jcluster,
                      engine=jengine, faults=jfaults, perf=jperf,
                      place=jplace, sched=jsched, gen=jgen, hw={})
PORT = SimpleNamespace(cfg=tget("llama2-7b"), cluster=tcluster,
                       engine=tengine, faults=tfaults, perf=tperf,
                       place=tplace, sched=tsched, gen=tgen,
                       hw={"hw": REF_HW})


def _servers(pkg, n, adapters=(), **kw):
    out = []
    for _ in range(n):
        s = pkg.engine.InferenceServer(
            pkg.cfg, **dict({"mode": "caraserve", "kernel": "bgmv",
                             "max_batch": 8, "numerics": False},
                            **pkg.hw, **kw))
        for ad in adapters:
            s.register_adapter(ad)
        out.append(s)
    return out


def _record_routes(cl):
    """Wrap the cluster's router: (rid, server) per routing decision, in
    call order (arrivals and crash failovers alike)."""
    routes, route = [], cl._route

    def rec(req, now_ms=None, allow_shed=True):
        idx = route(req, now_ms=now_ms, allow_shed=allow_shed)
        routes.append((req.rid, idx))
        return idx

    cl._route = rec
    return routes


def _fleet_run(pkg, policy, placement, trace, n=4):
    rng = np.random.default_rng(4)
    adapters = pkg.gen.make_adapters(12, pkg.cfg.name, rng)
    perf = pkg.perf.ServerPerfModel(pkg.cfg, kernel="bgmv", **pkg.hw)
    slo = 1.5 * perf.dec_perf([64] * 8)
    mk = pkg.gen.maf_trace if trace == "maf" else pkg.gen.drifting_maf_trace
    reqs = mk(adapters, rps=24, duration_s=3, vocab=100, seed=6,
              slo_tpt_ms=slo)
    pl = pkg.place.make_placement_policy(placement).assign(
        adapters, n, popularity=pkg.gen.trace_popularity(reqs))
    faults = pkg.faults.FaultPlane(
        pkg.faults.chaos_schedule(n, reqs[-1].arrival_ms, seed=5), seed=5)
    sched = pkg.sched.make_scheduler(policy, perf, slo_ms=slo) \
        if policy == "rank_aware" else pkg.sched.make_scheduler(policy)
    cl = pkg.cluster.Cluster(_servers(pkg, n, link_policy="priority"),
                             sched, placement=pl, specs=adapters,
                             rebalance_every_ms=250.0, faults=faults,
                             shed_policy="slo")
    routes = _record_routes(cl)
    out, states = cl.run(reqs)
    where = {st.req.rid: i for i, s in enumerate(cl.servers)
             for st in s.states}
    return {"n_requests": len(reqs), "routes": routes, "summary": out,
            "served_by": where, "fault_log": faults.log,
            "fault_stats": cl.fault_stats,
            "placement_stats": cl.placement_stats,
            "event_counts": cl.event_counts,
            "hosts": {a.uid: pl.hosts(a.uid) for a in adapters},
            "finish_ms": {st.req.rid: st.finish_ms for st in states}}


@pytest.mark.parametrize("trace", ["maf", "drifting"])
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_matches_reference(policy, placement, trace):
    """Same trace, policy, placement, rebalance and chaos script: the same
    route for every routing decision, the same summary (floats equal),
    the same fault log and the same placement at the end."""
    want = _fleet_run(REF, policy, placement, trace)
    got = _fleet_run(PORT, policy, placement, trace)
    assert got["routes"] == want["routes"]
    assert got == want
    s = got["summary"]
    assert s["n"] + s["shed"] == got["n_requests"]     # nothing lost
    assert got["fault_stats"]["crashes"] == 1
    assert got["event_counts"]["rebalance"] > 0
    assert len({i for _, i in got["routes"]}) > 1


def _lockstep_pair(engine, adapters, perf):
    return PORT.cluster.Cluster(
        _servers(PORT, 4, adapters),
        PORT.sched.make_scheduler("rank_aware", perf, slo_ms=None),
        engine=engine)


def test_event_cluster_matches_lockstep_oracle():
    """The event-driven loop reproduces the lockstep oracle's summary on a
    fixed trace (within 1%, as the reference holds its own), and each
    engine equals the reference's same engine exactly."""
    rng = np.random.default_rng(0)
    adapters = PORT.gen.make_adapters(16, PORT.cfg.name, rng)
    perf = PORT.perf.ServerPerfModel(PORT.cfg, kernel="bgmv", hw=REF_HW)
    reqs = PORT.gen.maf_trace(adapters, rps=30, duration_s=4, vocab=100,
                              seed=1)
    out_e, _ = _lockstep_pair("events", adapters, perf).run(reqs)
    out_l, _ = _lockstep_pair("lockstep", adapters, perf).run(reqs)
    assert out_e["n"] == out_l["n"] == len(reqs)
    assert out_e["cold_starts"] == out_l["cold_starts"]
    for k in ("ttft_mean", "tpt_mean", "latency_mean", "ttft_p99"):
        assert out_e[k] == pytest.approx(out_l[k], rel=0.01), k

    rng = np.random.default_rng(0)
    jad = REF.gen.make_adapters(16, REF.cfg.name, rng)
    jperf_ = REF.perf.ServerPerfModel(REF.cfg, kernel="bgmv")
    jreqs = REF.gen.maf_trace(jad, rps=30, duration_s=4, vocab=100, seed=1)
    for engine, out in (("events", out_e), ("lockstep", out_l)):
        ref, _ = REF.cluster.Cluster(
            _servers(REF, 4, jad),
            REF.sched.make_scheduler("rank_aware", jperf_, slo_ms=None),
            engine=engine).run(jreqs)
        assert out == ref, engine
    with pytest.raises(ValueError, match="lockstep"):
        PORT.cluster.Cluster(_servers(PORT, 1), PORT.sched.make_scheduler(
            "most_idle"), engine="lockstep",
            faults=PORT.faults.FaultPlane([]))


def _chaos_run(seed):
    rng = np.random.default_rng(seed)
    adapters = PORT.gen.make_adapters(12, PORT.cfg.name, rng)
    perf = PORT.perf.ServerPerfModel(PORT.cfg, kernel="bgmv")
    slo = 1.5 * perf.dec_perf([64] * 8)
    reqs = PORT.gen.maf_trace(adapters, rps=30, duration_s=3, vocab=100,
                              seed=2, slo_tpt_ms=slo)
    faults = PORT.faults.FaultPlane(
        PORT.faults.chaos_schedule(3, reqs[-1].arrival_ms, seed=seed),
        seed=seed)
    servers = [PORT.engine.InferenceServer(
        PORT.cfg, mode="caraserve", kernel="bgmv", max_batch=8,
        numerics=False, link_policy="priority") for _ in range(3)]
    for s in servers:
        for ad in adapters:
            s.register_adapter(ad)
    cl = PORT.cluster.Cluster(
        servers, PORT.sched.make_scheduler("rank_aware", perf, slo_ms=slo),
        faults=faults, shed_policy="slo")
    out, states = cl.run(reqs)
    tokens = {s.req.rid: tuple(s.generated) for s in states}
    return faults.log, out, tokens, cl.fault_stats, len(reqs)


def test_chaos_runs_are_deterministic_and_lose_nothing():
    """On the port's own H100 timeline: two same-seed chaos runs agree on
    every fault, token and summary number, and every request either
    finishes or is shed."""
    log1, out1, tok1, fs1, n = _chaos_run(11)
    log2, out2, tok2, fs2, _ = _chaos_run(11)
    assert log1 and log1 == log2
    assert out1 == out2 and tok1 == tok2 and fs1 == fs2
    assert fs1["crashes"] == 1 and fs1["restarts"] == 1
    assert out1["n"] + out1["shed"] == n
    kinds = {e[1] for e in log1}
    assert {"crash", "restart"} <= kinds


def test_chaos_schedule_matches_reference():
    for seed in range(6):
        want = REF.faults.chaos_schedule(4, 10_000.0, seed=seed,
                                         n_crashes=2)
        got = PORT.faults.chaos_schedule(4, 10_000.0, seed=seed,
                                         n_crashes=2)
        assert [dataclasses.astuple(e) for e in got] \
            == [dataclasses.astuple(e) for e in want]
        assert all(e.server != 0 for e in got if e.kind == "crash")
    with pytest.raises(ValueError, match="unknown fault kind"):
        PORT.faults.FaultEvent(0.0, "meteor", 0)


def _cli(monkeypatch, capsys, tmp_path, pkg, args):
    path = tmp_path / f"{pkg}.json"
    argv = args + ["--json", str(path)]
    if pkg == "ref":
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        jserve.main()
    else:
        tserve.main(argv)
    first = capsys.readouterr().out.splitlines()[0]
    out = json.loads(path.read_text())
    return first.split(",")[0], first.split("SLO=")[1], \
        out.get("simulated", out)


@pytest.mark.parametrize("policy", POLICIES)
def test_cli_cluster_matches_reference(monkeypatch, capsys, tmp_path,
                                       policy):
    """`--cluster 2 --policy P`: the port's CLI and the reference's give the
    same request count, the same SLO (from ServerPerfModel's DecPerf of a
    full rank-64 batch) and the same simulated summary at the same
    hardware constants; every request is served."""
    args = ["--cluster", "2", "--policy", policy, "--rps", "8",
            "--duration", "2", "--n-adapters", "8"]
    want = _cli(monkeypatch, capsys, tmp_path, "ref", args)
    monkeypatch.setattr(tserve, "ServerPerfModel", lambda cfg, kernel:
                        tperf.ServerPerfModel(cfg, kernel=kernel, hw=REF_HW))
    got = _cli(monkeypatch, capsys, tmp_path, "port", args)
    assert got == want
    n = int(got[0].split()[0])
    assert n > 0 and got[2]["n"] + got[2]["shed"] == n


def test_cli_single_server_slo_matches_reference(monkeypatch, capsys,
                                                 tmp_path):
    """The single-server path takes its SLO from the same performance
    model as the reference's CLI (and the cluster path): equal request
    count and SLO at the same hardware constants, while the port's tokens
    are computed on the CPU here (the reference's server runs timing-only
    without --smoke; neither number depends on it)."""
    args = ["--rps", "4", "--duration", "1", "--mode", "cached"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    want = capsys.readouterr().out.splitlines()[0]
    monkeypatch.setattr(tserve, "ServerPerfModel", lambda cfg, kernel:
                        tperf.ServerPerfModel(cfg, kernel=kernel, hw=REF_HW))
    tserve.main(args + ["--smoke", "--device", "cpu", "--json",
                        str(tmp_path / "one.json")])
    got = capsys.readouterr().out.splitlines()[0]
    assert got.split(",")[0] == want.split(",")[0]
    assert got.split("SLO=")[1] == want.split("SLO=")[1]
    out = json.loads((tmp_path / "one.json").read_text())["simulated"]
    assert out["n"] == int(got.split()[0])
