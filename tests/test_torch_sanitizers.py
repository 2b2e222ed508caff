"""The port's runtime sanitizers (REPRO_SANITIZE=1): every PageSan and
LinkSan case of tests/test_sanitizers.py through the port's classes, one
event script through both packages' LoadTracker giving the same verdicts,
and a smoke server that preempts (swap and recompute) under the sanitizers
serving the tokens it serves without them, and the reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.analysis import sanitizers as jsan  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import cold_start as jcold  # noqa: E402
from repro.core.engine import InferenceServer as JServer  # noqa: E402
from repro.core.lora import AdapterSpec as JSpec  # noqa: E402
from repro.core.timing import V5E, TimingModel as JTiming  # noqa: E402
from repro.serving.request import Request as JReq  # noqa: E402
from repro_torch.analysis import sanitizers  # noqa: E402
from repro_torch.analysis.sanitizers import (LinkSanError,  # noqa: E402
                                             PageSanError)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.cold_start import (ColdStartManager,  # noqa: E402
                                         LoadTracker)
from repro_torch.core.engine import InferenceServer  # noqa: E402
from repro_torch.core.lora import (AdapterSpec, DevicePool,  # noqa: E402
                                   HostLoRAStore)
from repro_torch.core.timing import Hardware, TimingModel  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving.cache import PageAllocator  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

REF_HW = Hardware(**dataclasses.asdict(V5E))


# ------------------------------------------------------------- PageSan ----

def _double_free():
    """Caught even when the allocator's own book-keeping was corrupted
    back to 'owned' — the shadow map is the authority."""
    al = PageAllocator(8)
    ids = al.claim(2, "kv:1")
    al.free(ids)
    al._owner.update({i: "kv:1" for i in ids})   # inject corruption
    with pytest.raises(PageSanError, match="double-free"):
        al.free(ids)


def _double_claim():
    al = PageAllocator(4)
    a = al.claim(2, "kv:1")
    al._free.append(a[0])              # inject: live page re-listed free
    with pytest.raises(PageSanError, match="double-claim"):
        al.claim(3, "kv:2")


def _use_after_free():
    """Freed pages are quarantined, so a stale block-table entry touches a
    dead page and is reported, with the previous owner named."""
    al = PageAllocator(8)
    ids = al.claim(2, "kv:1")
    al.san.check_access(ids, "kv:", "decode block table")   # live: fine
    al.free(ids)
    with pytest.raises(PageSanError, match="use-after-free.*kv:1"):
        al.san.check_access(ids, "kv:", "decode block table")


def _aliasing():
    al = PageAllocator(8)
    kv = al.claim(2, "kv:1")
    ad = al.claim(2, "adapter:u")
    al.san.check_access(kv, "kv:", "decode block table")
    al.san.check_access(ad, "adapter:", "lora slot")
    with pytest.raises(PageSanError, match="aliasing"):
        al.san.check_access(kv + ad, "kv:", "decode block table")


def _capacity_neutral():
    """free_pages counts quarantined pages and claim recycles them under
    pressure: the accounting is the same with and without the sanitizer."""
    al = PageAllocator(4)
    a = al.claim(3, "kv:1")
    al.free(a)
    assert al.free_pages == 4 and al.used_pages == 0
    b = al.claim(4, "kv:2")            # needs the quarantined pages
    assert b is not None and al.free_pages == 0
    al.san.check_access(b, "kv:", "decode")    # recycled = live again
    assert al.claim(1, "kv:3") is None         # genuinely exhausted


def _negative_ids_skipped():
    """-1 block-table entries (unclaimed logical pages) are not accesses."""
    al = PageAllocator(4)
    ids = al.claim(2, "kv:1")
    al.san.check_access(list(ids) + [-1, -1], "kv:", "decode")


def _backend_checks_stale_block_table():
    """The backend's access check on a host-built page list (decode's
    block table) reports a page freed under a row."""
    cfg = get_config("llama2-7b").smoke()
    srv = InferenceServer(cfg, max_batch=2, cache_slots=64, device="cpu",
                          memory="paged", page_size=32, total_pages=8)
    pages = srv.allocator.claim(2, "kv:7")
    srv.backend._san_check(pages, "kv:", "decode block table")
    srv.allocator.free(pages)
    with pytest.raises(PageSanError, match="use-after-free.*decode block"):
        srv.backend._san_check(pages, "kv:", "decode block table")


@pytest.mark.parametrize("case", [
    _double_free, _double_claim, _use_after_free, _aliasing,
    _capacity_neutral, _negative_ids_skipped,
    _backend_checks_stale_block_table], ids=lambda f: f.__name__[1:])
def test_pagesan(case):
    with sanitizers.force(True):
        case()


def test_pagesan_off_by_default():
    with sanitizers.force(False):          # even under REPRO_SANITIZE=1
        al = PageAllocator(4)
        tr = LoadTracker(TimingModel(get_config("llama2-7b")))
    assert al.san is None and tr.san is None   # no shadow state


# ------------------------------------------------------------- LinkSan ----

def _mk_manager(policy, uids=("u0", "u1", "u2", "u3"), n_slots=8):
    cfg = get_config("llama2-7b")
    tm = TimingModel(cfg)
    store = HostLoRAStore(cfg)
    for u in uids:
        store.register(AdapterSpec(u, rank=64, base_model=cfg.name),
                       materialize=False)
    pool = DevicePool(cfg, n_slots=n_slots, materialize=False)
    return ColdStartManager(tm, store, pool, "caraserve",
                            link_policy=policy)


def _tracker():
    return LoadTracker(TimingModel(get_config("llama2-7b")), policy="fifo")


def _clean_preempt_flow():
    mgr = _mk_manager("preempt")
    mgr.load_async("u0", 0.0, demand=False)
    mgr.load_async("u1", 0.0, demand=False)   # queues behind u0
    assert mgr.load_async("u2", 1.0, demand=True) is not None
    mgr.poll(10_000.0)
    assert mgr.tracker.stats["demand_delayed_by_prefetch"] == 0


def _demand_behind_prefetch():
    """Queued speculative uploads survive a demand begin (the manager's
    preempt step broken): the hazard the preempt policy rules out."""
    mgr = _mk_manager("preempt")
    mgr._cancel_queued_prefetch = lambda: None    # inject the bug
    mgr.load_async("u0", 0.0, demand=False)       # takes the lane
    mgr.load_async("u1", 0.0, demand=False)       # queued prefetch
    with pytest.raises(LinkSanError, match="prefetch|delayed"):
        mgr.load_async("u2", 1.0, demand=True)


def _rescheduled_started_upload():
    """A started upload's (start, finish) is frozen; moving it afterwards
    is flagged at retirement."""
    tracker = _tracker()
    ev = tracker.begin("u", 0, 1 << 20, 0.0, demand=True)
    assert ev.started
    ev.finish_ms += 7.0                           # inject the bug
    with pytest.raises(LinkSanError, match="frozen"):
        tracker.complete_until(1e9)


def _kv_swap_rides_demand_class():
    mgr = _mk_manager("preempt")
    mgr.load_async("u0", 0.0, demand=False)
    mgr.load_async("u1", 0.0, demand=False)
    ev = mgr.upload_kv(7, 1 << 22, 1.0)           # preempts the queue
    assert ev.demand and ev.uid == "kvswap:7"
    mgr.poll(10_000.0)


def _killed_upload_never_retires():
    """A crash-canceled upload put back on the running list."""
    tracker = _tracker()
    ev = tracker.begin("u", 0, 1 << 20, 0.0, demand=True)
    tracker.cancel_all()
    tracker._running.append(ev)                   # inject the bug
    with pytest.raises(LinkSanError, match="must never retire"):
        tracker.complete_until(1e9)


def _failed_attempt_never_retires():
    tracker = _tracker()
    ev = tracker.begin("u", 0, 1 << 20, 0.0, demand=True)
    tracker.fail_hook = lambda e: True            # every retirement fails
    tracker.complete_until(ev.finish_ms + 0.001)  # fails -> retry queued
    assert tracker.stats["upload_failures"] == 1
    tracker.fail_hook = None
    tracker._running.append(ev)                   # inject: zombie retire
    with pytest.raises(LinkSanError, match="must never retire"):
        tracker.complete_until(1e9)


def _retry_follows_failed_attempt():
    """A retry requested at (or before) the failed attempt's finish."""
    tracker = _tracker()
    tracker.begin("u", 0, 1 << 20, 0.0, demand=True)
    tracker.fail_hook = lambda e: True
    tracker._backoff_ms = lambda e: 0.0           # inject: no backoff
    with pytest.raises(LinkSanError, match="not after the failed"):
        tracker.complete_until(1e9)


def _retry_attempt_numbering():
    tracker = _tracker()
    failed = tracker.begin("u", 0, 1 << 20, 0.0, demand=True)
    retry = tracker.begin("u", 0, 1 << 20, failed.finish_ms + 5.0,
                          demand=True)
    retry.attempt = 3                             # inject: skipped a step
    with pytest.raises(LinkSanError, match="carries attempt"):
        tracker.san.on_retry(failed, retry)


def _clean_retry_flow():
    """fail -> backoff -> retry -> retire stays silent, and the retry
    retires strictly after the failed attempt."""
    tracker = _tracker()
    ev = tracker.begin("u", 0, 1 << 20, 0.0, demand=True)
    first_finish = ev.finish_ms
    tracker.fail_hook = lambda e: e.attempt == 0
    done = tracker.complete_until(1e9)
    assert [e.uid for e in done] == ["u"]
    assert done[0].attempt == 1 and done[0].finish_ms > first_finish
    assert tracker.stats["retries"] == 1


@pytest.mark.parametrize("case", [
    _clean_preempt_flow, _demand_behind_prefetch,
    _rescheduled_started_upload, _kv_swap_rides_demand_class,
    _killed_upload_never_retires, _failed_attempt_never_retires,
    _retry_follows_failed_attempt, _retry_attempt_numbering,
    _clean_retry_flow], ids=lambda f: f.__name__[1:])
def test_linksan(case):
    with sanitizers.force(True):
        case()


# ------------------------------------------ one script, both packages ----

def _script(tracker_cls, timing_cls, cfg):
    """A fixed event script over one LoadTracker: uploads of both classes,
    a failure and its retry, a crash, and two injected bugs; each step's
    verdict is None or (exception class, message)."""
    verdicts = []

    def step(fn):
        try:
            fn()
            verdicts.append(None)
        except Exception as e:   # noqa: BLE001 — the verdict is the point
            verdicts.append((type(e).__name__, str(e)))

    tr = tracker_cls(timing_cls(cfg), policy="preempt")
    step(lambda: tr.begin("a", 0, 3 << 20, 0.0, demand=False))
    step(lambda: tr.begin("b", 1, 1 << 20, 0.5, demand=False))
    step(lambda: tr.begin("c", 2, 2 << 20, 1.0, demand=True))
    tr.fail_hook = lambda e: e.uid == "b" and e.attempt == 0
    step(lambda: verdicts.append([e.uid for e in tr.complete_until(50.0)]))
    tr.fail_hook = None
    step(lambda: verdicts.append([e.uid for e in tr.complete_until(1e4)]))
    ev = tr.begin("d", 3, 1 << 20, 2e4, demand=True)
    ev.finish_ms += 3.0                           # a started upload moved
    step(lambda: tr.complete_until(1e9))
    tr2 = tracker_cls(timing_cls(cfg), policy="fifo")
    ev = tr2.begin("e", 0, 1 << 20, 0.0, demand=True)
    step(lambda: verdicts.append([e.uid for e in tr2.cancel_all()]))
    tr2._running.append(ev)                       # a killed upload revived
    step(lambda: tr2.complete_until(1e9))
    return verdicts


def test_one_event_script_gives_both_packages_the_same_verdicts():
    with jsan.force(True), sanitizers.force(True):
        want = _script(jcold.LoadTracker, JTiming, jget("llama2-7b"))
        got = _script(LoadTracker, TimingModel, get_config("llama2-7b"))
    assert got == want
    assert sum(v is not None and isinstance(v, tuple) for v in got) == 2


# --------------------------------------------- a preempting smoke server ----

def _trace(n=2, prompt_len=10, max_new=40, seed=7):
    rng = np.random.default_rng(seed)
    return [(i, "ad0", rng.integers(0, 512, prompt_len).astype(np.int32),
             max_new, 0.0) for i in range(n)]


@pytest.fixture(scope="module")
def reference_tokens():
    """The reference's uninterrupted run of the trace and its weights."""
    cj = jget("llama2-7b").smoke()
    js = JServer(cj, mode="caraserve", max_batch=4, cache_slots=64, seed=0,
                 memory="paged", page_size=32, total_pages=12)
    js.register_adapter(JSpec("ad0", 8, cj.name))
    js.run([JReq(*t) for t in _trace()])
    return ({s.req.rid: s.generated for s in js.states},
            jax.tree.map(np.asarray, js.params))


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_sanitized_server_preempts_and_serves_the_same_tokens(
        reference_tokens, policy):
    """A 4-page pool preempts mid-decode; under the sanitizers the tokens,
    the preemption counts and the allocator's counts are the unsanitized
    run's, and the tokens are the reference's; both sanitizers checked."""
    want, tree = reference_tokens
    ct = get_config("llama2-7b").smoke()
    runs = {}
    for on in (False, True):
        with sanitizers.force(on):
            ts = InferenceServer(
                ct, mode="caraserve", max_batch=4, cache_slots=64, seed=0,
                device="cpu", memory="paged", page_size=32, total_pages=4,
                preempt=policy, hw=REF_HW,
                params=params_from_jax(ct, tree, device="cpu"))
            ts.register_adapter(AdapterSpec("ad0", 8, ct.name))
            ts.run([Request(*t) for t in _trace()])
        al = ts.allocator
        runs[on] = ({s.req.rid: s.generated for s in ts.states},
                    dict(ts.preempt_stats), al.free_pages, al.used_pages,
                    len(al.owned_by("kv:")), len(al.owned_by("adapter:")))
        assert (al.san is not None) == on
        if on:
            assert al.san.access_checks > 0 and al.san.frees > 0
            assert ts.cold.tracker.san.checks > 0
    assert runs[True] == runs[False]
    assert runs[True][1][f"{policy}_preemptions"] > 0
    assert runs[True][0] == want
