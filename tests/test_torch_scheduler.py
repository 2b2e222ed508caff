"""The port's rank-aware performance models and scheduler (paper sec 5,
Fig 9, Algorithm 1 and the sec 7.5 baselines) against the reference's, on
the same inputs. Both are plain Python and numpy, so every number must be
equal, not close. The port's models are given the reference's timeline
hardware (its V5E constants, passed in); its own default is the H100."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_config as jget
from repro.core import perf_model as jperf
from repro.core import scheduler as jsched
from repro.core.timing import V5E
from repro_torch.configs.base import get_config as tget
from repro_torch.core import perf_model as tperf
from repro_torch.core import scheduler as tsched
from repro_torch.core.timing import H100, Hardware

JCFG, TCFG = jget("llama2-7b"), tget("llama2-7b")
# the reference's timeline hardware, for the port's models held to it
REF_HW = Hardware(**dataclasses.asdict(V5E))
RANKS = (8, 16, 32, 64)


@pytest.fixture(scope="module", params=["bgmv", "mbgmv"])
def perfs(request):
    """(reference, port) ServerPerfModel pair for one kernel law."""
    return (jperf.ServerPerfModel(JCFG, kernel=request.param),
            tperf.ServerPerfModel(TCFG, kernel=request.param, hw=REF_HW))


@pytest.mark.parametrize("kernel", ["bgmv", "mbgmv"])
@pytest.mark.parametrize("noise,seed", [(0.02, 0), (0.0, 3)])
def test_profile_and_fit_matches_reference(kernel, noise, seed):
    """Fig 9's fit: the same profiled samples, alpha, beta and R^2."""
    jm, (jx, jy) = jperf.profile_and_fit(JCFG, kernel, noise=noise,
                                         seed=seed)
    tm, (tx, ty) = tperf.profile_and_fit(TCFG, kernel, hw=REF_HW,
                                         noise=noise, seed=seed)
    assert (tx, ty) == (jx, jy)
    assert (tm.alpha, tm.beta, tm.r2, tm.kernel) \
        == (jm.alpha, jm.beta, jm.r2, jm.kernel)
    assert tm.alpha > 0 and tm.r2 > 0.9


def test_perf_model_defaults_to_the_card():
    """The port's models describe the H100's simulated timeline unless told
    otherwise, and so differ from the reference's TPU numbers."""
    m = tperf.ServerPerfModel(TCFG)
    assert m.hw == H100
    assert m.dec_perf([64] * 8) != jperf.ServerPerfModel(JCFG).dec_perf(
        [64] * 8)


def test_server_perf_model_matches_reference(perfs):
    jp, tp = perfs
    for ranks in ([], [8], [64] * 8, [8, 16, 32, 64, 64], [16] * 30):
        assert tp.dec_perf(ranks) == jp.dec_perf(ranks)
        assert tp.pre_perf(ranks) == jp.pre_perf(ranks)
        assert tp.pre_perf(ranks, tokens_each=300) \
            == jp.pre_perf(ranks, tokens_each=300)
    for r in RANKS:
        assert tp.load_perf(r) == jp.load_perf(r)
    for tokens, cb in ((0, 0), (100, 0), (2000, 0), (2000, 512), (300, 512)):
        assert tp.prefill_spike_ms(tokens, cb) \
            == jp.prefill_spike_ms(tokens, cb)


@pytest.mark.parametrize("ranks,kernel,want", [
    ([8, 64], "bgmv", 128), ([8, 64], "mbgmv", 72), ([], "bgmv", 0.0),
    ([16, 16, 16], "bgmv", 48), ([32], "mbgmv", 32)])
def test_batch_feature_matches_reference(ranks, kernel, want):
    assert tperf.batch_feature(ranks, kernel) \
        == jperf.batch_feature(ranks, kernel) == want


def _random_stats(rng, ranks, n_servers):
    """The same random ServerStats fields for both packages: every term of
    calc_cost gets a value (link queue, brownout, install, page gate,
    preemption pressure, prefill interference)."""
    out = []
    for i in range(n_servers):
        run = [int(r) for r in rng.choice(RANKS, int(rng.integers(0, 9)))]
        if i == 0:
            run = list(ranks)
        queued = [int(r) for r in rng.choice(RANKS, int(rng.integers(0, 4)))]
        ready = bool(rng.integers(2))
        kw = dict(
            running_ranks=run, queued_ranks=queued,
            hosts_adapter=bool(rng.integers(4)) or i == 0,
            free_rows=int(rng.integers(0, 9)),
            n_requests=len(run) + len(queued),
            loading_ranks=[int(r) for r in
                           rng.choice(RANKS, int(rng.integers(0, 3)))],
            link_busy_ms=float(rng.uniform(0, 80)),
            adapter_ready=ready,
            adapter_loading=not ready and bool(rng.integers(2)),
            demand_link_ms=float(rng.uniform(0, 40)),
            prefetch_link_ms=float(rng.uniform(0, 40)),
            link_policy=str(rng.choice(["fifo", "priority", "preempt"])),
            miss_install_ms=float(rng.choice([0.0, 25.0])),
            free_pages=None if rng.integers(3) == 0
            else int(rng.integers(0, 64)),
            req_pages=int(rng.integers(0, 48)),
            preempt_pressure=float(rng.choice([0.0, rng.uniform(0, 2)])),
            decode_commit_tokens=int(rng.integers(0, 400)),
            chunk_budget=int(rng.choice([0, 256, 512])),
            link_slowdown=float(rng.choice([1.0, 3.0])))
        out.append((jsched.ServerStats(**kw), tsched.ServerStats(**kw)))
    return [j for j, _ in out], [t for _, t in out]


@settings(max_examples=40, deadline=None)
@given(ranks=st.lists(st.sampled_from(list(RANKS)), min_size=0,
                      max_size=12),
       req=st.sampled_from(list(RANKS)),
       seed=st.integers(0, 10_000))
def test_property_cost_route_saturated_match_reference(perfs, ranks, req,
                                                       seed):
    """Random server views: calc_cost per server, Algorithm 1's pick and
    the saturation test (the cluster's register-on-miss and shedding
    trigger) equal the reference's, with and without an SLO and a long
    prompt."""
    jp, tp = perfs
    rng = np.random.default_rng(seed)
    js, ts = _random_stats(rng, ranks, int(rng.integers(1, 6)))
    slo = [None, float(rng.uniform(0.8, 1.3)) * jp.dec_perf([64] * 8)][
        int(rng.integers(2))]
    prefill = int(rng.choice([0, 64, 2048]))
    for j, t in zip(js, ts):
        assert tsched.calc_cost(req, t, tp, slo, 64.0,
                                prefill_tokens=prefill) \
            == jsched.calc_cost(req, j, jp, slo, 64.0,
                                prefill_tokens=prefill)
    jr = jsched.RankAwareScheduler(jp, slo_ms=slo)
    tr = tsched.RankAwareScheduler(tp, slo_ms=slo)
    assert tr.route(req, ts, prefill_tokens=prefill) \
        == jr.route(req, js, prefill_tokens=prefill)
    assert tr.saturated(req, ts, prefill_tokens=prefill) \
        == jr.saturated(req, js, prefill_tokens=prefill)


def _stats_pair(running, hosts=True, free=4):
    kw = dict(running_ranks=list(running), queued_ranks=[],
              hosts_adapter=hosts, free_rows=free, n_requests=len(running))
    return jsched.ServerStats(**kw), tsched.ServerStats(**kw)


def test_algorithm1_slo_penalty_matches_reference():
    """Paper Fig 5 under BGMV: a rank-64 request goes to the instance
    already running high ranks; both packages pick it, with the SLO and
    without."""
    jp = jperf.ServerPerfModel(JCFG, kernel="bgmv")
    tp = tperf.ServerPerfModel(TCFG, kernel="bgmv", hw=REF_HW)
    slo = jp.dec_perf([32] * 25) * 1.02
    (j1, t1), (j2, t2) = _stats_pair([32] * 24), _stats_pair([64] * 16)
    for s in (slo, None):
        jr = jsched.RankAwareScheduler(jp, slo_ms=s).route(64, [j1, j2])
        tr = tsched.RankAwareScheduler(tp, slo_ms=s).route(64, [t1, t2])
        assert tr == jr == 1
    with pytest.raises(LookupError):
        tsched.RankAwareScheduler(tp).route(8, [_stats_pair([], False)[1]])


@pytest.mark.parametrize("policy", ["rank_aware", "most_idle", "first_fit",
                                    "random"])
def test_make_scheduler_policies_pick_reference_server(policy):
    """Each policy, built by make_scheduler, routes a stream of requests
    over random fleets (some servers not hosting the adapter) to the
    reference's server, call by call (RANDOM draws from one seeded stream
    in both)."""
    jp = jperf.ServerPerfModel(JCFG, kernel="bgmv")
    tp = tperf.ServerPerfModel(TCFG, kernel="bgmv", hw=REF_HW)
    kw = {"slo_ms": 1.5 * jp.dec_perf([64] * 8)} \
        if policy == "rank_aware" else {}
    js = jsched.make_scheduler(policy, jp, **kw)
    ts = tsched.make_scheduler(policy, tp, **kw)
    assert ts.name == js.name == policy
    rng = np.random.default_rng(7)
    for _ in range(60):
        jst, tst = zip(*[_stats_pair(
            rng.choice(RANKS, int(rng.integers(0, 9))).tolist(),
            hosts=bool(rng.integers(3)), free=int(rng.integers(0, 3)))
            for _ in range(5)])
        if not any(s.hosts_adapter for s in jst):
            jst[0].hosts_adapter = tst[0].hosts_adapter = True
        req = int(rng.choice(RANKS))
        got = ts.route(req, list(tst), prefill_tokens=32)
        assert got == js.route(req, list(jst), prefill_tokens=32)
        assert tst[got].hosts_adapter
    with pytest.raises(ValueError):
        tsched.make_scheduler("round_robin")
