"""The slice as a whole with numerics: two llama2-7b-smoke servers behind
the router, in f32 on the CPU, in the reference and in the port. The
port's two servers share one weight set (the reference's, carried across
with `params_from_jax`) and keep their own KV and adapter pools. Both
clusters serve the same requests under MOSTIDLE and the rank-aware router,
without faults and with a crash of server 1 (drain, recompute failover on
server 0) and its restart. Routes and every request's tokens must equal
the reference's, and the failed run's tokens must equal the unfailed
run's. The port's servers are given the reference's timeline hardware, so
both clusters batch on identical simulated clocks."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-sized ops: one intra-op thread avoids oversubscribing the cores the
# reference (XLA) and the other test workers share
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.cluster import Cluster as JCluster  # noqa: E402
from repro.core.engine import InferenceServer as JServer  # noqa: E402
from repro.core.faults import FaultEvent as JFault  # noqa: E402
from repro.core.faults import FaultPlane as JPlane  # noqa: E402
from repro.core.perf_model import ServerPerfModel as JPerf  # noqa: E402
from repro.core.scheduler import make_scheduler as jmake  # noqa: E402
from repro.core.timing import V5E  # noqa: E402
from repro.serving.request import Request as JReq  # noqa: E402
from repro.traces import gen as jgen  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core.cluster import Cluster as TCluster  # noqa: E402
from repro_torch.core.engine import InferenceServer as TServer  # noqa: E402
from repro_torch.core.faults import FaultEvent as TFault  # noqa: E402
from repro_torch.core.faults import FaultPlane as TPlane  # noqa: E402
from repro_torch.core.perf_model import ServerPerfModel as TPerf  # noqa: E402,E501
from repro_torch.core.scheduler import make_scheduler as tmake  # noqa: E402
from repro_torch.core.timing import Hardware  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving.request import Request as TReq  # noqa: E402
from repro_torch.traces import gen as tgen  # noqa: E402

REF_HW = Hardware(**dataclasses.asdict(V5E))
# (router, mode): MOSTIDLE over preloaded adapters, as the reference's own
# crash test; Algorithm 1 over cold starts with CPU-assisted prefill
ARMS = [("most_idle", "cached"), ("rank_aware", "caraserve")]
CRASH = [(15.0, "crash", 1), (40.0, "restart", 1)]


def _requests(Req, vocab, uids):
    rng = np.random.default_rng(5)
    return [Req(rid=i, adapter_uid=uids[i % len(uids)],
                prompt=rng.integers(0, vocab, 10 + 3 * i).astype(np.int32),
                max_new_tokens=10, arrival_ms=4.0 * i) for i in range(6)]


def _ref_cluster(policy, mode, faults):
    cfg = jget("llama2-7b").smoke()
    adapters = jgen.make_adapters(3, cfg.name, np.random.default_rng(5),
                                  uniform_rank=8)
    servers = []
    for _ in range(2):
        s = JServer(cfg, mode=mode, max_batch=4, numerics=True, seed=0,
                    pipeline="fused")
        for ad in adapters:
            s.register_adapter(ad)
        servers.append(s)
    perf = JPerf(jget("llama2-7b"), kernel="bgmv")
    sched = jmake(policy, perf, slo_ms=1.5 * perf.dec_perf([64] * 4)) \
        if policy == "rank_aware" else jmake(policy)
    plane = JPlane([JFault(*f) for f in faults], seed=1) if faults else None
    return JCluster(servers, sched, faults=plane), cfg, adapters


def _port_cluster(policy, mode, faults, params):
    cfg = tget("llama2-7b").smoke()
    adapters = tgen.make_adapters(3, cfg.name, np.random.default_rng(5),
                                  uniform_rank=8)
    servers = []
    for _ in range(2):
        s = TServer(cfg, mode=mode, max_batch=4, numerics=True, seed=0,
                    pipeline="fused", params=params, hw=REF_HW,
                    device="cpu")
        for ad in adapters:
            s.register_adapter(ad)
        servers.append(s)
    perf = TPerf(tget("llama2-7b"), kernel="bgmv", hw=REF_HW)
    sched = tmake(policy, perf, slo_ms=1.5 * perf.dec_perf([64] * 4)) \
        if policy == "rank_aware" else tmake(policy)
    plane = TPlane([TFault(*f) for f in faults], seed=1) if faults else None
    return TCluster(servers, sched, faults=plane), cfg, adapters


def _serve(cl, cfg, adapters, Req):
    routes, route = [], cl._route

    def rec(req, now_ms=None, allow_shed=True):
        idx = route(req, now_ms=now_ms, allow_shed=allow_shed)
        routes.append((req.rid, idx))
        return idx

    cl._route = rec
    reqs = _requests(Req, cfg.vocab, [a.uid for a in adapters])
    out, states = cl.run(reqs)
    assert out["n"] == len(reqs) and out["shed"] == 0
    tokens = {s.req.rid: list(map(int, s.generated)) for s in states}
    assert all(len(t) == 10 for t in tokens.values())
    return routes, tokens, out, cl


@pytest.fixture(scope="module")
def shared_params():
    """The reference's seed-0 smoke weights, once, as the port's one
    shared weight set."""
    cfg = jget("llama2-7b").smoke()
    js = JServer(cfg, max_batch=4, numerics=True, seed=0)
    return params_from_jax(tget("llama2-7b").smoke(),
                           jax.tree.map(np.asarray, js.params),
                           device="cpu")


@pytest.mark.parametrize("faults", [[], CRASH], ids=["no_fault", "crash"])
@pytest.mark.parametrize("policy,mode", ARMS)
def test_cluster_tokens_match_reference(shared_params, policy, mode, faults):
    """Same routes and tokens as the reference's cluster, the two port
    servers on one weight set with separate KV pools; with the crash, live
    requests are recovered on the survivor and still finish with the
    unfailed run's tokens."""
    jr, jt, jout, _ = _serve(*_ref_cluster(policy, mode, faults), JReq)
    tr, tt, tout, tcl = _serve(*_port_cluster(policy, mode, faults,
                                              shared_params), TReq)
    assert tr == jr
    assert tt == jt
    assert {i for _, i in tr} == {0, 1}
    for k in ("n", "recovered", "failovers", "cold_starts", "ttft_mean",
              "tpt_mean"):
        assert tout[k] == jout[k], k
    a, b = (s.backend for s in tcl.servers)
    assert a.params is b.params is shared_params
    assert a.cache["k"].data_ptr() != b.cache["k"].data_ptr()
    if faults:
        assert tout["recovered"] > 0, "the crash drained no live requests"
        assert tcl.fault_stats["crashes"] == tcl.fault_stats["restarts"] == 1
        _, want, _, _ = _serve(*_port_cluster(policy, mode, [],
                                              shared_params), TReq)
        assert tt == want
