"""Admission plane of the inference server: row assignment, the admission
policy (arrivals preempt decoding, paper Fig 2), and the popularity-EWMA
adapter prefetcher (beyond-paper: the mechanism S-LoRA leaves unspecified,
paper sec 2.3 — here concrete and composable with CPU-assist).

Owns the request queue, the batch-row bookkeeping, and the mapping from rows
to device pool slots. Knows nothing about tensors (that is the
NumericsBackend) or the virtual clock (that is the InferenceServer): it is
handed `clock` and returns the admissions plus the serial time they cost.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cold_start import AdmitPlan, ColdStartManager
from repro_torch.core.lora import DevicePool, HostLoRAStore
from repro_torch.serving.cache import pages_for_tokens
from repro_torch.serving.request import RequestState

POP_HALFLIFE_MS = 5000.0     # popularity EWMA half-life (simulated time)
PREFETCH_PER_TICK = 4        # uploads started per iteration at most
PREFETCH_HYSTERESIS = 1.5    # replace a resident only on a clear win


class AdmissionPlane:
    def __init__(self, cold: ColdStartManager, store: HostLoRAStore,
                 pool: DevicePool, max_batch: int, prefetch: bool = False,
                 allocator=None, page_size: int = 32,
                 cache_slots: int = 0, admit_footprint: str = "prompt",
                 kv_page_bytes: int = 0, chunk_budget: int = 0,
                 shed_late_slo: float = 0.0):
        if admit_footprint not in ("prompt", "full"):
            raise ValueError(f"unknown admit_footprint {admit_footprint!r}")
        # brownout shedding (core/faults.py): with shed_late_slo > 0, a
        # queued fresh request that has already waited longer than
        # shed_late_slo * slo_tpt_ms * max_new_tokens — i.e. its SLO is
        # provably unattainable even at zero serving time — is shed at
        # admission instead of dragging every resident row's ITL. 0 = off.
        self.shed_late_slo = shed_late_slo
        self.shed_count = 0
        # chunked prefill: prompts longer than chunk_budget are admitted in
        # phase "prefill" — pages claimed chunk-by-chunk by the engine's
        # interleaver, prefill compute billed per-iteration, only the
        # blocking part of a cold start charged serially here. 0 = off.
        self.chunk_budget = chunk_budget
        self.cold = cold
        self.store = store
        self.pool = pool
        self.max_batch = max_batch
        self.prefetch = prefetch
        # paged memory plane: admission claims each request's KV pages from
        # the unified KV/LoRA allocator (None: dense rows, no page gating).
        # `admit_footprint="prompt"` claims prompt pages only and lets the
        # block table grow lazily during decode (KV over-subscription);
        # "full" is the PR-5 baseline that reserves the whole lifetime
        # footprint up front.
        self.allocator = allocator
        self.page_size = page_size
        self.cache_slots = cache_slots
        self.admit_footprint = admit_footprint
        self.kv_page_bytes = kv_page_bytes   # link bytes per swapped page
        self.row_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.peak_active_rows = 0
        # set by the allocator's on_free hook: pages came back (retire,
        # preemption, adapter shed) since the last admit pass — the engine
        # re-checks deferred admissions promptly instead of waiting a step
        self.pages_freed = False
        if allocator is not None:
            allocator.on_free = self._note_pages_freed
        self.queue: collections.deque = collections.deque()
        self.rows: List[Optional[RequestState]] = [None] * max_batch
        self.row_slot = np.full(max_batch, -1, np.int64)   # adapter pool slot
        self.row_pos = np.zeros(max_batch, np.int64)       # next decode pos
        # popularity EWMA over *simulated time* (half-life POP_HALFLIFE_MS,
        # so scores on a server whose traffic dries up still fade), O(1)
        # per arrival: instead of decaying every key, scores are kept in an
        # inflated scale that grows as time passes; an occasional O(K)
        # renormalization keeps the scale finite
        self._popularity: Dict[str, float] = {}
        self._pop_scale = 1.0
        self._pop_t = 0.0        # simulated ms of the last update

    # ----------------------------------------------------------- queue ----
    def enqueue(self, st: RequestState):
        self.queue.append(st)
        # EWMA popularity update — always tracked (the cluster's placement
        # rebalance consumes it even when local prefetch is off)
        t = st.req.arrival_ms
        e = min(max(t - self._pop_t, 0.0) / POP_HALFLIFE_MS, 60.0)
        self._pop_scale *= 2.0 ** e
        self._pop_t = max(self._pop_t, t)
        self._popularity[st.req.adapter_uid] = \
            self._popularity.get(st.req.adapter_uid, 0.0) + self._pop_scale
        if self._pop_scale > 1e12:
            for k in self._popularity:
                self._popularity[k] /= self._pop_scale
            self._pop_scale = 1.0

    def popularity(self, now_ms: Optional[float] = None) -> Dict[str, float]:
        """Snapshot of the per-adapter popularity EWMA as of `now_ms`
        (default: as of the last arrival). Time-indexed: a server that
        stopped receiving traffic reports faded scores, not its frozen
        peak — the cluster aggregates these across servers at one instant
        to drive replica add/drop decisions."""
        ref = self._pop_t if now_ms is None else max(now_ms, self._pop_t)
        fade = 0.5 ** min((ref - self._pop_t) / POP_HALFLIFE_MS, 60.0)
        return {k: v / self._pop_scale * fade
                for k, v in self._popularity.items()}

    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.rows)

    def free_row(self) -> Optional[int]:
        for i, r in enumerate(self.rows):
            if r is None:
                return i
        return None

    def pinned_slots(self) -> List[int]:
        return [int(s) for s in self.row_slot if s >= 0]

    # ----------------------------------------------------------- paging ----
    def _note_pages_freed(self):
        self.pages_freed = True

    def kv_pages_needed(self, req) -> int:
        """*Lifetime* page demand of a request: prompt plus generated
        tokens, capped by the per-row ring depth. This gates `submit` (a
        request whose full footprint can never fit must be rejected, not
        deferred forever) — admission itself claims only `kv_pages_admit`
        and grows the block table lazily."""
        if self.allocator is None:
            return 0
        tokens = min(req.prompt_len + req.max_new_tokens, self.cache_slots)
        return pages_for_tokens(tokens, self.page_size)

    def kv_pages_admit(self, req, chunked: bool = False) -> int:
        """Pages claimed at admission: prompt only under over-subscription
        (`admit_footprint="prompt"`), the whole lifetime footprint under
        the up-front baseline. A chunked admission claims the first
        chunk's pages only — the rest arrive chunk-by-chunk through the
        engine's interleaver (the "full" baseline still reserves
        everything up front; chunking only staggers the writes)."""
        if self.allocator is None:
            return 0
        if self.admit_footprint == "full":
            return self.kv_pages_needed(req)
        tokens = min(req.prompt_len, self.cache_slots)
        if chunked:
            tokens = min(tokens, self.chunk_budget)
        return pages_for_tokens(tokens, self.page_size)

    def chunk_eligible(self, req) -> bool:
        """Prompts longer than one chunk take the chunked prefill path."""
        return 0 < self.chunk_budget < req.prompt_len

    def _chunk_admit(self, st: RequestState) -> bool:
        """Should this admission enter in phase "prefill"? Fresh long
        prompts always; preempted rows only when the prefill itself was
        interrupted (a swap-out mid-chunking preserves `prefill_pos` so
        resume restores chunk progress instead of the decode position)."""
        return self.chunk_eligible(st.req) and \
            (not st.preempted or st.prefill_pos < st.req.prompt_len)

    def kv_pages_resume(self, st: RequestState) -> int:
        """Pages a preempted request needs to re-admit: every KV slot
        written before preemption (`resume_pos` tokens, ring-capped) must
        be resident again — restored by swap-in or rebuilt by recompute —
        before decode can continue."""
        return pages_for_tokens(min(st.resume_pos, self.cache_slots),
                                self.page_size)

    def _claim_kv(self, st: RequestState) -> Optional[List[int]]:
        """Claim the request's admission KV pages (prompt pages, or the
        full restore set for a preempted resume), reclaiming cold resident
        adapters' pages (LRU-first, pinned slots excluded) when the unified
        pool is short — the KV-hungry-burst side of the shared budget. A
        demand that cannot be met even by shedding everything evictable
        defers without evicting anything (a doomed claim must not flush the
        warm adapter set)."""
        need = self.kv_pages_resume(st) if st.preempted \
            else self.kv_pages_admit(st.req, chunked=self._chunk_admit(st))
        pinned = self.pinned_slots()
        if self.allocator.free_pages + self.pool.sheddable_pages(pinned) \
                < need:
            return None
        owner = f"kv:{st.req.rid}"
        ids = self.allocator.claim(need, owner)
        while ids is None and self.pool.shed_cold(pinned=pinned):
            ids = self.allocator.claim(need, owner)
        return ids

    def grow_row(self, row: int) -> Optional[List[int]]:
        """Lazy block-table growth: claim the next logical page for a row
        whose decode write is crossing a page boundary, shedding cold
        adapter pages if the pool is short. Returns the claimed page ids
        (the caller must scrub them before the write — they may carry a
        previous tenant's entries) or None when the allocator is dry even
        after shedding: the engine's victim policy takes over."""
        st = self.rows[row]
        pinned = self.pinned_slots()
        owner = f"kv:{st.req.rid}"
        ids = self.allocator.claim(1, owner)
        while ids is None and self.pool.shed_cold(pinned=pinned):
            ids = self.allocator.claim(1, owner)
        if ids is None:
            return None
        self.row_pages[row].extend(ids)
        st.kv_pages.extend(ids)
        return ids

    def running_states(self) -> List[RequestState]:
        return [r for r in self.rows if r is not None]

    # ------------------------------------------------------- admission ----
    def admit(self, clock: float) -> Tuple[List[Tuple[RequestState,
                                                      AdmitPlan]], float]:
        """Admit queued arrivals into free rows (new arrivals preempt
        decoding, paper Fig 2). Preempted requests re-enter through the
        same path: they sit at the queue front, re-claim their restore
        pages, and are billed either a recompute prefill (drop path) or a
        link-scheduled KV swap-in (swap path) — never a new first token.
        Returns (admitted, serial_ms): the serial prefill/stall time the
        admissions add to this iteration."""
        self.pages_freed = False
        iter_ms = 0.0
        admitted = []
        while self.queue and self.free_row() is not None \
                and self.queue[0].req.arrival_ms <= clock:
            st = self.queue.popleft()
            if self._should_shed(st, clock):
                st.phase = "shed"
                st.shed = True
                st.row = -1
                self.shed_count += 1
                continue
            row = self.free_row()
            st.row = row
            self.rows[row] = st
            pages = None
            if self.allocator is not None:
                pages = self._claim_kv(st)
                if pages is None:   # pool exhausted: defer the admission
                    self.rows[row] = None
                    st.row = -1
                    self.queue.appendleft(st)
                    break
            resume = st.preempted
            chunked = self._chunk_admit(st)
            # swap resume restores KV bytes over the link — no prefill
            # compute; recompute resume re-prefills every written slot
            prefill_tokens = st.req.prompt_len if not resume else (
                0 if st.resume_kind == "swap"
                else min(st.resume_pos, self.cache_slots))
            plan = self.cold.admit(st.req.adapter_uid, clock + iter_ms,
                                   prefill_tokens,
                                   pinned=self.pinned_slots())
            if plan is None:     # every device slot pinned: requeue, stop
                if pages is not None:
                    self.allocator.free(pages)
                self.rows[row] = None
                st.row = -1
                self.queue.appendleft(st)
                break
            if pages is not None:
                # distinct lists: grow_row extends both (aliasing them
                # would double-append every lazy growth claim)
                self.row_pages[row] = list(pages)
                st.kv_pages = list(pages)
            st.cold_start = st.cold_start or plan.cold
            st.assist_used = st.assist_used or plan.assist
            if chunked:
                # chunked prefill: the compute is billed per-chunk inside
                # decode iterations by the engine's interleaver — only the
                # blocking part of a cold start (ondemand/slora upload
                # wait) and any KV swap-in link time charge serially here.
                # No first token yet: it arrives with the final chunk.
                iter_ms += plan.blocking_ms
                if resume and st.resume_kind == "swap" and pages:
                    ev = self.cold.upload_kv(st.req.rid,
                                             len(pages) * self.kv_page_bytes,
                                             clock + iter_ms)
                    st.kv_resume_ms = ev.finish_ms
                st.ready_ms = max(clock + iter_ms, st.kv_resume_ms)
                st.load_finish_ms = plan.load_finish_ms
                st.phase = "prefill"
                self.row_slot[row] = plan.slot
                self.row_pos[row] = st.prefill_pos
                admitted.append((st, plan))
                self.peak_active_rows = max(
                    self.peak_active_rows,
                    sum(r is not None for r in self.rows))
                continue
            # monolithic: the whole prompt's KV lands in one shot
            st.prefill_pos = st.req.prompt_len
            # prefill_ms is the full first-token latency post queue and
            # already contains any blocking load (ondemand/slora);
            # blocking_ms is reported separately for Fig 2 accounting, so
            # adding both would double-count the upload
            iter_ms += plan.prefill_ms
            if resume:
                st.ready_ms = plan.ready_decode_ms
                if st.resume_kind == "swap" and pages:
                    ev = self.cold.upload_kv(st.req.rid,
                                             len(pages) * self.kv_page_bytes,
                                             clock + iter_ms)
                    st.kv_resume_ms = ev.finish_ms
                    st.ready_ms = max(st.ready_ms, ev.finish_ms)
            else:
                st.first_token_ms = clock + iter_ms
                st.ready_ms = plan.ready_decode_ms
            st.load_finish_ms = plan.load_finish_ms
            st.phase = "loading" if st.ready_ms > clock + iter_ms \
                else "decode"
            self.row_slot[row] = plan.slot
            self.row_pos[row] = st.resume_pos if resume \
                else st.req.prompt_len
            admitted.append((st, plan))
            self.peak_active_rows = max(
                self.peak_active_rows,
                sum(r is not None for r in self.rows))
        return admitted, iter_ms

    def _should_shed(self, st: RequestState, clock: float) -> bool:
        """Brownout shedding gate: only fresh requests with a TPT SLO and
        no emitted work are eligible — a preempted/recovered request
        already holds tokens the caller promised, shedding it would lose
        them."""
        if self.shed_late_slo <= 0.0 or st.preempted or st.generated \
                or st.pending_tokens or st.recovered \
                or st.req.slo_tpt_ms is None:
            return False
        budget = self.shed_late_slo * st.req.slo_tpt_ms \
            * st.req.max_new_tokens
        return clock - st.req.arrival_ms > budget

    def release(self, row: int):
        self.rows[row] = None
        self.row_slot[row] = -1
        if self.allocator is not None and self.row_pages[row]:
            self.allocator.free(self.row_pages[row])
        self.row_pages[row] = []

    # -------------------------------------------------------- prefetch ----
    def prefetch_tick(self, now_ms: float):
        """Start async uploads of the hottest non-resident adapters into
        free, unpinned slots. The upload rides the host link through the
        LoadTracker — it occupies the link but never blocks the iteration.
        When demand traffic owns the link (a cold start's upload is still
        running or queued) the prefetcher backs off entirely: speculative
        transfers must never steal lane time a waiting request needs, and
        under `fifo` they would queue *ahead* of the next demand upload."""
        if not (self.prefetch and self._popularity):
            return
        if self.cold.tracker.demand_busy_ms(now_ms) > 0.0:
            return
        pinned = set(self.pinned_slots())
        pop = lambda u: self._popularity.get(u, 0.0)
        hot = sorted((u for u in self._popularity
                      if self.pool.lookup(u) is None),
                     key=pop, reverse=True)
        for uid in hot[:PREFETCH_PER_TICK]:
            # victim: unpinned ready slot with the least-popular resident,
            # replaced only on a clear popularity win (hysteresis)
            cands = [s for s in range(self.pool.n_slots)
                     if s not in pinned and self.pool.is_ready(s)]
            if not cands:
                break
            victim = min(cands, key=lambda s: pop(self.pool.slot_uid[s])
                         if self.pool.slot_uid[s] else -1.0)
            vu = self.pool.slot_uid[victim]
            if vu is not None and pop(uid) < PREFETCH_HYSTERESIS * pop(vu):
                continue
            # reserve-first: pin every slot except the chosen victim so the
            # reservation can only land there (overwriting the resident in
            # place). If it fails, nothing was evicted and the resident
            # survives — the old evict-then-reserve order lost the resident
            # whenever the reservation could not be honoured.
            keep = tuple(s for s in range(self.pool.n_slots) if s != victim)
            if self.cold.load_async(uid, now_ms, pinned=keep,
                                    demand=False) is None:
                break
