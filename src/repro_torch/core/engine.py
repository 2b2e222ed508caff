"""Continuous-batching LoRA serving engine (one inference server, paper
Fig 6), decomposed into three planes:

  * admission — repro_torch.core.admission.AdmissionPlane: row assignment,
    admission policy (arrivals preempt decoding, Fig 2), popularity-EWMA
    prefetch.
  * numerics — repro_torch.core.backend.NumericsBackend: real PyTorch
    computation on the card (or, with device="cpu", the plain path),
    batched multi-request prefill + batched decode over the KV-cache pool
    and the heterogeneous LoRA slot pool (absent for timing-only
    simulations at cluster scale).
  * timeline — this module: the virtual clock advanced by the TimingModel,
    reproducing the paper's profiling-driven methodology (sec 7.5), with
    cold-start/CPU-assist overlap from the asynchronous ColdStartManager /
    LoadTracker (uploads occupy the shared host link over simulated time; a
    load-complete event flips a request from CPU-assist LoRA to the device
    pool mid-flight).

Iteration-level batching (Orca-style, paper sec 2.2): each `step()` admits
queued requests (prefill, possibly cold-starting their adapter per the
engine mode), then runs ONE decode iteration for every ready running
request. Completed requests leave the batch immediately.

Modes: cached | ondemand | slora | caraserve.  Kernels: bgmv | mbgmv.

A copy of the reference's `repro.core.engine` with the port's planes
wired in. The timeline stays the analytic simulator, modelling the H100
by default (`core.timing.H100`): every TTFT, TPT or tokens/s it reports
is simulated. `device=None` means the card; a server
with numerics refuses to start without one unless device="cpu" is given.
"""
from __future__ import annotations

import collections
from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.admission import AdmissionPlane
from repro_torch.core.backend import NumericsBackend, bucket as _bucket
from repro_torch.core.cold_start import ColdStartManager
from repro_torch.core.lora import AdapterSpec, DevicePool, HostLoRAStore
from repro_torch.core.scheduler import select_victim
from repro_torch.core.timing import H100, Hardware, TimingModel
from repro_torch.device import resolve_device
from repro_torch.models.model import supports_chunked_prefill, supports_paged
from repro_torch.serving.cache import (PageAllocator, boundary_steps,
                                       kv_page_nbytes, pages_for_tokens)
from repro_torch.serving.request import (Request, RequestState,
                                         itl_percentiles, summarize)

IDLE_TICK_MS = 0.1
# window for the preemption-pressure rate routing steers by (simulated ms)
PREEMPT_WINDOW_MS = 2000.0


class InferenceServer:
    def __init__(self, cfg: ModelConfig, *, mode: str = "caraserve",
                 kernel: str = "bgmv", max_batch: int = 8,
                 cache_slots: int = 256, hw: Hardware = H100,
                 numerics: bool = True, params=None, seed: int = 0,
                 avg_ctx: int = 512, pool_slots: Optional[int] = None,
                 prefetch: bool = False, link_policy: str = "fifo",
                 pipeline: str = "fused", megastep: int = 8,
                 temperature: float = 0.0, staging_slots: int = 16,
                 memory: str = "auto", page_size: int = 32,
                 total_pages: Optional[int] = None,
                 admit_footprint: str = "prompt",
                 preempt: str = "recompute", chunk_budget: int = 0,
                 shed_late_slo: float = 0.0, device=None,
                 graphs: bool = True):
        self.device = resolve_device(device) if numerics else None
        self.cfg = cfg
        self.mode = mode
        self.kernel = kernel
        self.max_batch = max_batch
        self.cache_slots = cache_slots
        self.numerics = numerics
        self.link_policy = link_policy
        self.tm = TimingModel(cfg, hw)
        self.store = HostLoRAStore(cfg)
        n_slots = pool_slots or max(cfg.lora.n_slots, max_batch)
        # memory plane: "paged" = block-table KV + unified KV/LoRA page
        # allocator (fused numerics on families with the uniform layered
        # cache); "dense" = the per-row slab. "auto" picks paged wherever
        # it is supported, dense elsewhere (recurrent/hybrid/enc-dec state,
        # int8 KV, the legacy per-step pipeline, timing-only servers).
        if memory not in ("auto", "paged", "dense"):
            raise ValueError(f"unknown memory plane {memory!r}")
        if memory == "auto":
            memory = "paged" if (numerics and pipeline == "fused"
                                 and supports_paged(cfg)
                                 and cache_slots % page_size == 0) \
                else "dense"
        self.memory = memory
        self.page_size = page_size
        if memory == "paged":
            self.page_bytes = kv_page_nbytes(cfg, page_size)
            # default budget: what the dense layout statically reserved —
            # every row at full depth plus every adapter slot at max rank —
            # so the paged plane admits a superset of the dense workloads;
            # benchmarks shrink `total_pages` to show demand-gated admission
            sizing = AdapterSpec("_sizing", cfg.lora.max_rank, cfg.name)
            ad_pages = max(1, -(-sizing.nbytes(cfg) // self.page_bytes))
            self.allocator = PageAllocator(
                total_pages or max_batch * (cache_slots // page_size)
                + n_slots * ad_pages)
        else:
            self.page_bytes = 0
            self.allocator = None
        self.pool = DevicePool(cfg, n_slots=n_slots, materialize=numerics,
                               allocator=self.allocator,
                               page_bytes=self.page_bytes,
                               device=self.device)
        self.cold = ColdStartManager(self.tm, self.store, self.pool, mode,
                                     link_policy=link_policy)
        # KV over-subscription: admission claims prompt pages only
        # (admit_footprint="prompt"; "full" = PR-5 up-front baseline) and
        # block tables grow lazily; `preempt` picks the victim resolution
        # when the allocator runs dry mid-decode — "swap" saves the KV
        # pages to host and re-uploads through the link scheduler,
        # "recompute" drops them and re-prefills on resume
        if preempt not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt policy {preempt!r}")
        self.preempt_policy = preempt
        # chunked prefill (prefill/decode interference control): prompts
        # longer than `chunk_budget` tokens are fed to the model at most
        # one chunk per decode iteration, piggybacking on the resident
        # batch's step instead of stalling it for a monolithic prefill.
        # 0 disables. The numerics path scatters each chunk's KV into the
        # row's claimed pages, so it needs the paged memory plane.
        if chunk_budget < 0:
            raise ValueError(f"chunk_budget must be >= 0, got {chunk_budget}")
        if chunk_budget and numerics:
            if self.memory != "paged":
                raise ValueError(
                    "chunked prefill needs the paged memory plane "
                    "(memory='paged'): chunks scatter KV into claimed "
                    "pages")
            if not supports_chunked_prefill(cfg):
                raise ValueError(
                    f"model family {cfg.name!r} does not support chunked "
                    "prefill (needs the uniform layered cache, no MoE)")
        self.chunk_budget = chunk_budget
        self.admission = AdmissionPlane(self.cold, self.store, self.pool,
                                        max_batch, prefetch=prefetch,
                                        allocator=self.allocator,
                                        page_size=page_size,
                                        cache_slots=cache_slots,
                                        admit_footprint=admit_footprint,
                                        kv_page_bytes=self.page_bytes,
                                        chunk_budget=chunk_budget,
                                        shed_late_slo=shed_late_slo)
        self.backend = NumericsBackend(
            cfg, kernel=kernel, max_batch=max_batch, cache_slots=cache_slots,
            store=self.store, pool=self.pool, params=params, seed=seed,
            pipeline=pipeline, megastep=megastep, temperature=temperature,
            staging_slots=staging_slots, memory=memory, page_size=page_size,
            allocator=self.allocator, device=self.device,
            graphs=graphs) if numerics else None
        self.clock = 0.0
        self.states: List[RequestState] = []
        self.avg_ctx = avg_ctx
        self.prefetch = prefetch
        # preemption / over-subscription telemetry (ServerStats + benches)
        self.preempt_stats = {"preemptions": 0, "swap_preemptions": 0,
                              "recompute_preemptions": 0, "swapped_pages": 0,
                              "recompute_tokens": 0, "grown_pages": 0}
        self._preempt_times: collections.deque = collections.deque()
        self.peak_oversub = 0.0
        # failure-plane telemetry (core/faults.py): crash/drain/adoption
        # counts plus the CPU-assist fault shield's engagement (rows that
        # decoded on the host path while their adapter upload was retrying)
        self.fault_stats = {"crashes": 0, "restarts": 0,
                            "drained_requests": 0, "adopted_requests": 0,
                            "assist_shield_rows": 0,
                            "assist_shield_tokens": 0}

    # ----------------------------------------------------------- views ----
    @property
    def queue(self):
        return self.admission.queue

    @property
    def rows(self):
        return self.admission.rows

    @property
    def params(self):
        return self.backend.params if self.backend else None

    # ----------------------------------------------------------- public ----
    def register_adapter(self, spec: AdapterSpec):
        self.store.register(spec, materialize=self.numerics,
                            now_ms=self.clock)

    def install_adapter(self, spec: AdapterSpec,
                        now_ms: Optional[float] = None):
        """Late registration on a live server (the cluster's
        register-on-miss / rebalance paths): the adapter joins the host
        store mid-run, stamped with the event time (`store.registered_ms`;
        the server's own clock can lag the cluster event that triggered
        the install). Its device upload happens on first admission through
        the normal cold-start machinery. Idempotent."""
        if spec.uid not in self.store:
            self.store.register(spec, materialize=self.numerics,
                                now_ms=max(self.clock, now_ms or 0.0))

    def submit(self, req: Request) -> RequestState:
        if self.memory == "paged":
            # page-gated admission: reject demands the pool can never meet
            # (temporary exhaustion merely defers the admission instead)
            width = self.cache_slots // self.page_size
            need_prompt = -(-req.prompt_len // self.page_size)
            if need_prompt > width:
                raise ValueError(
                    f"request {req.rid}: prompt needs {need_prompt} KV "
                    f"pages but a row's block table holds {width} pages "
                    f"({self.cache_slots} slots at page_size "
                    f"{self.page_size}); raise cache_slots or truncate "
                    "the prompt before submitting")
            # decoding needs the KV pages AND the adapter's pages resident
            # simultaneously — a demand above the whole pool can never be
            # admitted (it would spin in the queue forever, not defer)
            need = self.kv_page_demand(req)
            spec = self.store.specs.get(req.adapter_uid)
            ad_need = self.pool.pages_for(spec.nbytes(self.cfg)) \
                if spec is not None else 0
            if need + ad_need > self.allocator.n_pages:
                raise ValueError(
                    f"request {req.rid}: needs {need} KV pages plus "
                    f"{ad_need} adapter pages but the unified page pool "
                    f"holds {self.allocator.n_pages} in total; raise "
                    "total_pages or shrink the request")
        elif self.backend is not None and req.prompt_len > self.cache_slots:
            raise ValueError(
                f"request {req.rid}: prompt is {req.prompt_len} tokens but "
                f"each KV-cache row holds {self.cache_slots} slots; raise "
                "cache_slots or truncate the prompt before submitting")
        st = RequestState(req)
        self.states.append(st)
        self.admission.enqueue(st)
        return st

    def kv_page_demand(self, req: Request) -> int:
        """Pages this request would claim at admission (0 on dense)."""
        return self.admission.kv_pages_needed(req)

    def free_pages(self) -> Optional[int]:
        """Free pages in the unified KV/LoRA pool (None on dense) — the
        scheduler's memory-demand steering signal."""
        return self.allocator.free_pages if self.allocator else None

    def oversub_ratio(self) -> float:
        """Admitted lifetime KV demand over the capacity left for KV in
        the unified pool (total minus resident adapter pages): > 1.0 means
        the running batch's full footprints no longer fit simultaneously
        and mid-decode preemption is possible (0.0 on dense)."""
        if self.allocator is None:
            return 0.0
        demand = sum(self.admission.kv_pages_needed(r.req)
                     for r in self.rows if r is not None)
        cap = self.allocator.n_pages \
            - len(self.allocator.owned_by("adapter:"))
        return demand / max(cap, 1)

    def preempt_pressure(self, now_ms: Optional[float] = None) -> float:
        """Recent preemptions per simulated second (window
        PREEMPT_WINDOW_MS) — the routing signal that steers arrivals away
        from a thrashing pool without penalizing old history forever."""
        now = self.clock if now_ms is None else max(now_ms, self.clock)
        while self._preempt_times and \
                self._preempt_times[0] < now - PREEMPT_WINDOW_MS:
            self._preempt_times.popleft()
        return len(self._preempt_times) / (PREEMPT_WINDOW_MS / 1e3)

    def busy(self) -> bool:
        return self.admission.busy()

    def running_ranks(self) -> List[int]:
        return [self.store.specs[r.req.adapter_uid].rank
                for r in self.rows if r is not None]

    def decode_commit_tokens(self) -> int:
        """Output tokens the resident batch is still committed to produce
        — the depth of decode work a newly routed prefill would interfere
        with. The cluster's cost model uses it to steer long prompts away
        from servers with deep resident decode batches."""
        return sum(max(r.req.max_new_tokens - r.issued, 0)
                   for r in self.rows if r is not None)

    def itl_samples(self) -> List[float]:
        """Every inter-token gap observed so far, across all requests."""
        return [g for s in self.states for g in s.itl_ms()]

    def itl_stats(self) -> dict:
        return itl_percentiles(self.itl_samples())

    def loading_ranks(self) -> List[int]:
        """Ranks of adapters whose *demand-class* upload is still on the
        host link — the scheduler's view of in-flight cold starts. This
        includes prefetches promoted by a demand admission (a request now
        rides them). Pure speculative prefetch uploads occupy the link
        (link_busy_ms) but have no request attached, so they never join the
        decode batch on their own and are excluded here."""
        return [self.store.specs[e.uid].rank
                for e in self.cold.tracker.inflight
                if e.demand and e.uid in self.store.specs]

    def link_busy_ms(self) -> float:
        """Queueing delay a new demand upload would face past `clock`:
        earliest-free-lane time after the uploads the link policy schedules
        ahead of it (fifo: everything inflight; priority/preempt: demand
        class only — queued prefetch is jumped)."""
        return max(0.0, self.cold.tracker.link_busy_until_ms() - self.clock)

    def next_event_ms(self) -> Optional[float]:
        """Earliest future time at which this server can make progress
        (queued arrival, decode-ready request, or load completion)."""
        cands = []
        if self.queue:
            cands.append(self.queue[0].req.arrival_ms)
        for r in self.rows:
            if r is not None and not r.done:
                cands.append(r.ready_ms)
        nf = self.cold.tracker.next_finish_ms()
        if nf is not None:
            cands.append(nf)
        future = [t for t in cands if t > self.clock]
        return min(future) if future else None

    # ------------------------------------------------------ one iteration ----
    def step(self, horizon_ms: Optional[float] = None):
        """One continuous-batching iteration; advances the virtual clock.
        When the iteration is empty (everything waits on a future event) the
        clock jumps to the next actionable time, clamped to `horizon_ms`
        (the caller's next arrival) so admissions are never skipped over."""
        # 0. uploads finished by now land (queued for the flip below)
        self.cold.poll(self.clock)

        # 1. admission: new arrivals preempt decoding (paper Fig 2);
        # preempted requests at the queue front resume (swap-in/recompute)
        admitted, iter_ms = self._admit_pass()
        # every completion retired above or inside admit(), exactly once
        self._flip(self.cold.drain_completions())

        # 1b. re-derive decode gates from the live link schedule: queued
        # finish times move on every insertion/promotion/cancellation, so a
        # ready/finish stamp captured at admit() time can go stale in either
        # direction (a promoted prefetch may land earlier; a later demand
        # may jump a queued promoted upload and push it back). Every row
        # with a pending upload is re-gated — not just phase "loading":
        # a rider admitted when the provisional finish fell inside its
        # prefill window starts in phase "decode" yet can still be jumped.
        # Exact no-op under fifo (finish times never move after begin()).
        rows = self.admission.rows
        for st in rows:
            if st is None or st.done:
                continue
            if st.first_token_ms is None and st.phase != "prefill":
                continue
            # a resumed row's KV swap-in is link traffic too: its queued
            # finish is as provisional as an adapter upload's
            kev = self.cold.tracker.pending_for(f"kvswap:{st.req.rid}") \
                if st.kv_resume_ms > 0.0 else None
            if kev is not None:
                st.kv_resume_ms = kev.finish_ms
                st.ready_ms = max(st.ready_ms, kev.finish_ms)
            ev = self.cold.tracker.pending_for(st.req.adapter_uid)
            if ev is not None:
                st.load_finish_ms = ev.finish_ms
                if st.phase != "prefill":
                    if ev.attempt > 0 and self.mode == "caraserve":
                        # degraded-mode fault shield (core/faults.py): the
                        # adapter upload failed and is mid-retry. Instead
                        # of stalling until a retry lands, decode rides
                        # the CPU-assist path — the host computes the
                        # per-token x·A·B exactly as during an assisted
                        # prefill — and _flip returns the row to the
                        # device path when an attempt succeeds.
                        if not st.assist_decode:
                            st.assist_decode = True
                            st.assist_used = True
                            self.fault_stats["assist_shield_rows"] += 1
                        st.ready_ms = max(st.first_token_ms,
                                          st.kv_resume_ms)
                    else:
                        # a chunking row's ready_ms gates its *chunks*, not
                        # decode — the final chunk re-derives the decode
                        # gate
                        st.ready_ms = max(st.first_token_ms, ev.finish_ms,
                                          st.kv_resume_ms)
            elif st.assist_decode:
                st.assist_decode = False   # upload landed or was canceled

        # 2. decode over ready rows: a megastep of K fused iterations when
        # the event horizon allows, else one iteration. First, lazy
        # block-table growth: any ready row whose next write crosses a page
        # boundary claims its page now — and if the allocator is dry, the
        # victim policy preempts rows to make room (possibly shrinking the
        # ready set).
        # 2a. chunked prefill interleave: the oldest ready chunking row is
        # fed at most `chunk_budget` prompt tokens this iteration, riding
        # the decode step (piggyback batching) — its chunk pages are
        # claimed here, chunk-by-chunk, with the same victim fallback as
        # lazy decode growth. Rows in phase "prefill" never decode.
        chunk_st, chunk_n = self._plan_chunk(iter_ms)
        ready = [r for r in rows
                 if r is not None and r.phase != "prefill"
                 and r.ready_ms <= self.clock + iter_ms
                 and not r.done]
        for r in ready:
            if r.phase == "loading":
                r.phase = "decode"
        ready = self._ensure_pages(ready)
        if chunk_st is not None and chunk_st.row < 0:
            chunk_st, chunk_n = None, 0   # preempted by decode growth above
        if ready:
            plan = self._plan_megastep(ready, horizon_ms) \
                if (self.backend and not admitted and iter_ms == 0.0
                    and chunk_st is None) \
                else None
            if plan is not None:
                K, nsteps, per_iter = plan
                self.backend.megastep(ready, nsteps, K,
                                      self.admission.row_slot,
                                      self.admission.row_pages)
                # bill exactly like K single steps: the batch shrinks as
                # rows hit their stop target, each surviving row gets its
                # token timestamp at that iteration's end
                t = self.clock
                for k in range(K):
                    t += per_iter[k]
                    for r, n in zip(ready, nsteps):
                        if n > k:
                            r.token_times_ms.append(t)
                            self.admission.row_pos[r.row] += 1
                iter_ms += sum(per_iter)
            else:
                # rows on the CPU-assist fault shield take their LoRA
                # delta from the host (their adapter upload is retrying):
                # the device kernel only serves the healthy rows, the host
                # GEMV runs concurrently, and the iteration pays the
                # slower of the two paths
                ranks = [self.store.specs[r.req.adapter_uid].rank
                         for r in ready if not r.assist_decode]
                cpu_ranks = [self.store.specs[r.req.adapter_uid].rank
                             for r in ready if r.assist_decode]
                if chunk_st is not None:
                    # mixed iteration: one device call carries the decode
                    # batch AND the prefill chunk — one step overhead, the
                    # chunk's compute hides under the memory-bound decode
                    dev_ms = self.tm.mixed_step_ms(
                        len(ready), self.avg_ctx, chunk_n,
                        chunk_st.prefill_pos) \
                        + self.tm.lora_decode_ms(ranks, self.kernel) \
                        + self._chunk_lora_ms(chunk_st, chunk_n)
                else:
                    dev_ms = self.tm.base_decode_ms(len(ready),
                                                    self.avg_ctx) \
                        + self.tm.lora_decode_ms(ranks, self.kernel)
                dec_ms = max(dev_ms, self.tm.cpu_lora_decode_ms(cpu_ranks))
                if cpu_ranks:
                    self.fault_stats["assist_shield_tokens"] += \
                        len(cpu_ranks)
                iter_ms += dec_ms
                if self.backend:
                    self.backend.decode(ready, self.admission.row_slot,
                                        self.admission.row_pos,
                                        self.admission.row_pages)
                else:
                    for r in ready:
                        r.generated.append(0)
                for r in ready:
                    r.token_times_ms.append(self.clock + iter_ms)
                    self.admission.row_pos[r.row] += 1
        elif chunk_st is not None:
            # no decode batch to ride: the chunk runs alone this iteration
            iter_ms += self.tm.chunk_prefill_ms(chunk_n,
                                                chunk_st.prefill_pos) \
                + self._chunk_lora_ms(chunk_st, chunk_n)
        if chunk_st is not None:
            self._run_chunk(chunk_st, chunk_n, self.clock + iter_ms)

        # 2b. prefetch rides the otherwise-idle host link asynchronously
        self.admission.prefetch_tick(self.clock + iter_ms)

        # 3. advance the virtual clock
        if iter_ms > 0:
            self.clock += iter_ms
        else:
            nxt = self.next_event_ms()
            if horizon_ms is not None:
                nxt = min(nxt, horizon_ms) if nxt is not None else horizon_ms
            self.clock = nxt if nxt is not None and nxt > self.clock \
                else self.clock + IDLE_TICK_MS

        # 4. retire finished requests
        for row, st in enumerate(rows):
            if st is not None and st.done:
                st.finish_ms = st.token_times_ms[-1] if st.token_times_ms \
                    else self.clock
                st.phase = "done"
                self.admission.release(row)

        # 4b. pages freed this step (retires, preemptions, adapter sheds —
        # the allocator's on_free hook sets the flag) un-defer queued work
        # immediately instead of waiting for the next step's admit attempt
        if self.allocator is not None and self.admission.pages_freed \
                and self.queue:
            admitted2, extra_ms = self._admit_pass()
            self._flip(self.cold.drain_completions())
            if extra_ms > 0:
                self.clock += extra_ms
            for st, _ in admitted2:      # prefill-only requests can finish
                if st.done and st.row >= 0:
                    st.finish_ms = st.token_times_ms[-1] \
                        if st.token_times_ms else self.clock
                    st.phase = "done"
                    self.admission.release(st.row)

    def _admit_pass(self):
        """Run the admission plane and dispatch its outcomes to the
        numerics backend: batched prefill for fresh admissions and
        recompute resumes (one padded call rebuilds a preempted row's KV
        bitwise), page re-upload for swap resumes."""
        admitted, iter_ms = self.admission.admit(self.clock)
        if admitted and self.allocator is not None:
            self.peak_oversub = max(self.peak_oversub, self.oversub_ratio())
        if admitted:
            resumes = [st for st, _ in admitted if st.preempted]
            fresh = [st for st, _ in admitted if not st.preempted]
            # chunking admissions (phase "prefill") run no prefill here:
            # the interleaver feeds their chunks per-iteration. Fresh ones
            # just need their claimed pages scrubbed; swap resumes restore
            # the written chunk prefix byte-for-byte (pages only — there
            # is no sampled token to re-seed the decode pipeline with).
            chunking = [st for st, _ in admitted if st.phase == "prefill"]
            if self.backend:
                swaps = [st for st in resumes if st.resume_kind == "swap"
                         and st.phase != "prefill"]
                recs = [st for st in resumes if st.resume_kind != "swap"
                        and st.phase != "prefill"]
                mono = [st for st in fresh if st.phase != "prefill"]
                if swaps:
                    self.backend.swap_in(swaps, self.admission.row_pages)
                for st in chunking:
                    if st.swap_payload is not None:
                        self.backend.restore_pages(st)
                    elif st.kv_pages:
                        self.backend.clear_pages(st.kv_pages)
                if mono or recs:
                    self.backend.prefill_admitted(mono + recs)
            else:
                for st in fresh:
                    if st.phase == "prefill":
                        continue    # first token arrives with the final chunk
                    st.generated.append(0)
                    st.token_times_ms.append(st.first_token_ms)
            for st in resumes:
                st.preempted = False
                st.resume_kind = ""
                st.swap_payload = None
        return admitted, iter_ms

    def _ensure_pages(self, ready):
        """Lazy block-table growth for this iteration's decode writes.
        Each ready row whose ring position has crossed into an unclaimed
        logical page claims one page (scrubbed before use — it may carry a
        previous tenant's slots). When the allocator is dry even after
        shedding cold adapter pages, `select_victim` preempts running rows
        (LRU-by-last-token, SLO-aware tiebreak) until the claim succeeds;
        a row that still cannot grow stalls this iteration. Returns the
        rows that can actually decode (growers minus preempted victims)."""
        if self.allocator is None:
            return ready
        adm = self.admission
        width = self.cache_slots // self.page_size
        preempted: set = set()
        stalled: set = set()
        for st in ready:
            if id(st) in preempted:
                continue
            while True:
                steps = boundary_steps(int(adm.row_pos[st.row]),
                                       len(adm.row_pages[st.row]),
                                       self.page_size, width)
                if steps is None or steps > 0:
                    break
                ids = adm.grow_row(st.row)
                if ids is not None:
                    self.preempt_stats["grown_pages"] += len(ids)
                    if self.backend:
                        self.backend.clear_pages(ids)
                    continue
                # allocator dry: preempt a victim (never the grower, never
                # a row mid-restore) and retry the claim
                cands = [r for r in adm.rows
                         if r is not None and r.phase != "loading"
                         and adm.row_pages[r.row]]
                victim = select_victim(cands, exclude=(st,))
                if victim is None:
                    stalled.add(id(st))
                    break
                preempted.add(id(victim))
                self._preempt(victim)
        return [r for r in ready
                if id(r) not in preempted and id(r) not in stalled]

    def _plan_chunk(self, iter_ms: float):
        """Pick this iteration's prefill chunk: the oldest row in phase
        "prefill" whose gate (swap-in link, blocking load) has passed gets
        min(chunk_budget, remaining prompt) tokens. Claims the chunk's KV
        pages first — chunk-by-chunk over-subscription with the same
        victim fallback as lazy decode growth. Returns (row, n_tokens) or
        (None, 0) when nothing is chunking (or the allocator stays dry:
        the chunk stalls this iteration and retries when pages free)."""
        if self.chunk_budget <= 0:
            return None, 0
        cands = [r for r in self.admission.rows
                 if r is not None and r.phase == "prefill" and not r.done
                 and r.ready_ms <= self.clock + iter_ms]
        if not cands:
            return None, 0
        st = min(cands, key=lambda r: r.req.rid)
        n = min(self.chunk_budget, st.req.prompt_len - st.prefill_pos)
        if not self._ensure_chunk_pages(st, st.prefill_pos + n):
            return None, 0
        return st, n

    def _ensure_chunk_pages(self, st: RequestState, upto_tokens: int) -> bool:
        """Grow the chunking row's block table to cover `upto_tokens`
        prompt slots before the chunk's KV scatter lands, page by page,
        shedding cold adapters and preempting victims when the unified
        pool runs dry (never the chunking row itself). False = stall."""
        if self.allocator is None:
            return True
        adm = self.admission
        need = pages_for_tokens(min(upto_tokens, self.cache_slots),
                                self.page_size)
        while len(adm.row_pages[st.row]) < need:
            ids = adm.grow_row(st.row)
            if ids is not None:
                self.preempt_stats["grown_pages"] += len(ids)
                if self.backend:
                    self.backend.clear_pages(ids)
                continue
            cands = [r for r in adm.rows
                     if r is not None and r.phase != "loading"
                     and adm.row_pages[r.row]]
            victim = select_victim(cands, exclude=(st,))
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _chunk_lora_ms(self, st: RequestState, n: int) -> float:
        spec = self.store.specs.get(st.req.adapter_uid)
        return self.tm.lora_prefill_gpu_ms(n, spec.rank) if spec else 0.0

    def _run_chunk(self, st: RequestState, n: int, t_end: float):
        """Execute/bill one prefill chunk for `st`, landing at `t_end`
        (this iteration's end). The final chunk samples the first token
        and transitions the row toward decode, gated on any pending
        adapter upload or KV swap-in exactly like a monolithic
        admission."""
        adm = self.admission
        start = st.prefill_pos
        final = start + n >= st.req.prompt_len
        if self.backend:
            self.backend.prefill_chunk(st, adm.row_pages[st.row], start, n,
                                       final)
        st.prefill_pos = start + n
        if not final:
            return
        st.first_token_ms = t_end
        st.token_times_ms.append(t_end)
        if not self.backend:
            st.generated.append(0)
        adm.row_pos[st.row] = st.req.prompt_len
        lf = st.load_finish_ms if st.load_finish_ms is not None else 0.0
        st.ready_ms = max(t_end, lf, st.kv_resume_ms)
        st.phase = "decode" if st.ready_ms <= t_end else "loading"

    def _preempt(self, st: RequestState):
        """Evict a running row to free its KV pages. The swap path copies
        the pages to host first (restored byte-for-byte on resume via the
        link scheduler); the recompute path drops them and re-prefills
        prompt + generated-so-far on resume — token-for-token identical
        either way, since greedy resampling of a replayed prefix
        reproduces it. A row whose ring has wrapped past `cache_slots`
        cannot be replayed by the padded prefill path, so recompute falls
        back to swap for it. The victim re-enters at the queue *front*:
        resumes beat fresh arrivals (S-LoRA's preemptive scheduling)."""
        adm = self.admission
        row = st.row
        if self.backend:
            self.backend.flush_readback()   # `generated` must be complete
        kind = self.preempt_policy
        # a half-prefilled (chunking) row has no decode position yet: its
        # written KV is the chunk prefix. Swap preserves chunk progress
        # (`prefill_pos` survives, resume restores the written pages and
        # chunking continues where it left off); recompute simply restarts
        # the prompt as a fresh chunked admission.
        chunking = st.phase == "prefill"
        pos = st.prefill_pos if chunking else int(adm.row_pos[row])
        if kind == "recompute" and pos > self.cache_slots:
            kind = "swap"
        if chunking and pos == 0:
            kind = "recompute"       # nothing written: plain re-admission
        st.resume_pos = pos
        # only pages with written slots travel: a freshly grown page the
        # row never wrote into (preempted at the boundary) is dropped —
        # the resume claim re-requests exactly the written prefix, and
        # growth re-claims the boundary page when decode reaches it again
        keep = -(-min(pos, self.cache_slots) // self.page_size)
        pages = list(adm.row_pages[row])[:keep]
        if kind == "swap":
            if self.backend and pages:
                st.swap_payload = self.backend.swap_out(pages)
            self.preempt_stats["swap_preemptions"] += 1
            self.preempt_stats["swapped_pages"] += len(pages)
        else:
            self.preempt_stats["recompute_preemptions"] += 1
            self.preempt_stats["recompute_tokens"] += \
                min(pos, self.cache_slots)
            if chunking:
                st.prefill_pos = 0
                st.resume_pos = 0
        adm.release(row)                    # frees pages, fires on_free
        st.kv_pages = []
        st.row = -1
        st.phase = "queued"
        # a recompute-dropped chunking row is a *fresh* chunked admission,
        # not a resume: nothing of it survives on device
        st.preempted = not (chunking and kind != "swap")
        st.resume_kind = "" if (chunking and kind != "swap") else kind
        st.preemptions += 1
        self.preempt_stats["preemptions"] += 1
        self._preempt_times.append(self.clock)
        adm.queue.appendleft(st)

    def _plan_megastep(self, ready, horizon_ms):
        """Choose K >= 2 decode iterations to fuse into one device call
        (`NumericsBackend.megastep`). Eligible only when the window
        provably contains no event single-step execution would have acted
        on: no queued arrival before the window end (nor the caller's
        horizon), no upload completion (a flip or a ready transition), no
        live row outside the ready set, and prefetch disabled (its
        per-iteration tick would drift against the single-step timeline).
        Returns (K, nsteps, per_iter_ms) — nsteps[i] is the tokens row i
        actually produces before its stop target freezes it — or None."""
        be = self.backend
        if be is None or be.pipeline != "fused" or be.megastep_max < 2:
            return None
        if self.prefetch or self.queue:
            return None
        live = [r for r in self.admission.rows
                if r is not None and not r.done]
        if any(r.phase == "prefill" for r in live):
            return None      # in-flight chunked prefill = boundary event
        if len(live) != len(ready):
            return None      # a loading row could become ready mid-window
        if any(r.assist_decode for r in ready):
            return None      # fault-shield rows flip event-by-event
        steps_left = [r.req.max_new_tokens - r.issued for r in ready]
        cap = min(be.megastep_max, max(steps_left))
        if self.allocator is not None:
            # lazy block tables: the window must end at the nearest
            # boundary-claim event — a row writing into an unclaimed page
            # mid-scan would corrupt the OOB-drop invariant. Rows that
            # finish before their boundary impose no bound.
            width = self.cache_slots // self.page_size
            for r, s in zip(ready, steps_left):
                b = boundary_steps(int(self.admission.row_pos[r.row]),
                                   len(self.admission.row_pages[r.row]),
                                   self.page_size, width)
                if b is not None and b < s:
                    cap = min(cap, b)
        if cap < 2:
            return None
        limit = horizon_ms if horizon_ms is not None else float("inf")
        nf = self.cold.tracker.next_finish_ms()
        if nf is not None:
            limit = min(limit, nf)
        # bill forward with the batch shrinking as rows finish (identical
        # to K single steps); stop at the first iteration that would cross
        # an event. An event exactly at the window end is fine — the next
        # step() acts on it at the same clock single-stepping would.
        per_iter = []
        t = self.clock
        for k in range(cap):
            batch_ranks = [self.store.specs[r.req.adapter_uid].rank
                           for r, s in zip(ready, steps_left) if s > k]
            d = self.tm.base_decode_ms(len(batch_ranks), self.avg_ctx) \
                + self.tm.lora_decode_ms(batch_ranks, self.kernel)
            if t + d > limit:
                break
            t += d
            per_iter.append(d)
        K = 1
        while K * 2 <= len(per_iter):
            K *= 2               # power-of-two K bounds scan compilations
        if K < 2:
            return None
        return K, [min(s, K) for s in steps_left], per_iter[:K]

    def _flip(self, events):
        """Load-complete events switch in-flight requests of that adapter
        from the CPU-assist LoRA path to the device pool (paper Fig 1/7)."""
        if not events:
            return
        for ev in events:
            for st in self.rows:
                if st is None or st.req.adapter_uid != ev.uid:
                    continue
                if st.assist_used and st.flip_ms is None:
                    st.flip_ms = ev.finish_ms
                st.assist_decode = False   # retry landed: back on device
                if st.phase == "loading":
                    st.phase = "decode"

    # ---------------------------------------------------- failure plane ----
    def _drain_row(self, st: RequestState, row: int):
        """Strip a live row off the dead device with a forced
        drop-and-recompute resume plan — swap is impossible, the KV pages
        died with the device. Mirrors `_preempt`'s recompute branch: the
        adopting server replays prompt + generated-so-far through the
        PR-6 machinery, token-for-token. A ring-wrapped row
        (pos > cache_slots) can only replay the ring depth — a documented
        parity limitation of crash recovery (the chaos benches keep
        outputs inside the ring). A half-prefilled chunking row restarts
        as a fresh chunked admission (its chunk prefix is gone)."""
        adm = self.admission
        chunking = st.phase == "prefill"
        pos = st.prefill_pos if chunking else int(adm.row_pos[row])
        st.resume_pos = pos
        if chunking:
            st.prefill_pos = 0
            st.resume_pos = 0
        adm.release(row)
        st.kv_pages = []
        st.row = -1
        st.phase = "queued"
        st.swap_payload = None
        st.kv_resume_ms = 0.0
        st.assist_decode = False
        st.load_finish_ms = None
        st.ready_ms = 0.0
        st.preempted = not chunking and pos > 0
        st.resume_kind = "recompute" if st.preempted else ""

    def crash(self, now_ms: float) -> List[RequestState]:
        """Fail-stop loss of this server's device state at `now_ms`
        (core/faults.py). Uploads already finished by the crash land
        first (they genuinely completed); everything else on the device
        dies — KV pages, the adapter pool, in-flight and queued uploads
        (canceled; LinkSan holds canceled uploads to never retire). Every
        queued and in-flight request is drained and returned for the
        cluster to re-admit on survivors. Tokens billed at iteration
        boundaries before the crash are kept (the crash lands between
        iterations — the simulator's granularity); `flush_readback` makes
        `generated` complete for the replay. The host store survives —
        host memory outlives the device in this failure model — and
        `restart` decides what to re-warm."""
        t = max(now_ms, self.clock)
        self.clock = t
        self.cold.poll(t)
        self._flip(self.cold.drain_completions())
        if self.backend:
            self.backend.flush_readback()   # `generated` must be complete
        adm = self.admission
        drained: List[RequestState] = []
        for row, st in enumerate(adm.rows):
            if st is None:
                continue
            if st.done:
                # full output already produced: retire, nothing to recover
                st.finish_ms = st.token_times_ms[-1] \
                    if st.token_times_ms else t
                st.phase = "done"
                adm.release(row)
                continue
            self._drain_row(st, row)
            drained.append(st)
        while adm.queue:
            st = adm.queue.popleft()
            st.row = -1
            drained.append(st)
        # the link dies with the device: cancel every upload, release the
        # canceled reservations, then evict every (ready) resident
        for ev in self.cold.tracker.cancel_all():
            if ev.slot >= 0 and not self.pool.slot_ready[ev.slot]:
                self.pool.release(ev.slot)
        for s in range(self.pool.n_slots):
            if self.pool.slot_uid[s] is not None:
                self.pool.evict(s)
        # drained requests leave this server's ledger entirely — they
        # complete (or are shed) on whichever server adopts them
        gone = set(id(s) for s in drained)
        self.states = [s for s in self.states if id(s) not in gone]
        self.fault_stats["crashes"] += 1
        self.fault_stats["drained_requests"] += len(drained)
        return drained

    def restart(self, now_ms: float):
        """Bring a crashed server back at `now_ms`: the device starts
        empty and cold. The cluster re-registers its placement-hosted
        adapters and warms the hottest through the normal prefetch path
        (warm rejoin, not cold); host store and telemetry survive."""
        self.clock = max(self.clock, now_ms)
        self.fault_stats["restarts"] += 1

    def adopt(self, st: RequestState, now_ms: float):
        """Admit a request drained from a crashed replica: the state —
        with its emitted tokens and recompute resume plan — joins this
        server's timeline. A resume re-enters at the queue *front*
        (resumes beat fresh arrivals, exactly as with preemption); a
        request that was still queued on the victim lines up normally."""
        if st.req.adapter_uid not in self.store:
            raise LookupError(
                f"adopting server does not host adapter "
                f"{st.req.adapter_uid!r} — the cluster must install it "
                "first (register-on-miss)")
        self.clock = max(self.clock, now_ms)
        self.states.append(st)
        st.row = -1
        if st.preempted:
            self.admission.queue.appendleft(st)
        else:
            self.admission.enqueue(st)
        self.fault_stats["adopted_requests"] += 1

    def run(self, requests: List[Request], max_iters: int = 100000):
        """Drive the engine over a trace; returns summary metrics."""
        pending = sorted(requests, key=lambda r: r.arrival_ms)
        i = 0
        iters = 0
        while (i < len(pending) or self.busy()) and iters < max_iters:
            while i < len(pending) and pending[i].arrival_ms <= self.clock:
                self.submit(pending[i])
                i += 1
            if not self.busy() and i < len(pending):
                self.clock = pending[i].arrival_ms   # jump to next arrival
                continue
            horizon = pending[i].arrival_ms if i < len(pending) else None
            self.step(horizon_ms=horizon)
            iters += 1
        if self.backend:
            self.backend.flush_readback()   # drain async token readbacks
        return summarize(self.states)
