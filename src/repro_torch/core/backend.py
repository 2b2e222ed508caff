"""Numerics plane of the inference server: real PyTorch computation.

Mirrors `repro.core.backend` for `memory="paged"`, `pipeline="fused"`:
the base-model weights, the paged KV pool, LoRA argument construction and
a **device-resident decode pipeline** (`DecodePipeline`): greedy sampling
runs on the device, per-row last-token / position / stop-target state
lives in device tensors, and the host reads tokens back one step behind
(the previous step's tokens are copied to pinned memory while the current
step runs). Entry points:

  * `prefill_admitted` — **batched multi-request prefill**: every request
    admitted in one iteration is packed into one padded (N, L) call
    (per-request LoRA weights come from the device `StagingCache`, stacked
    along the slot dim), bucketed to powers of two like the reference. The
    residual stream is gathered at each row's last position before the
    unembed, the first token is sampled on the device, and the row caches
    land in their claimed pages with one indexed write per leaf.
  * `decode` — one iteration over the ready rows against the paged pool
    and the device LoRA slot pool (BGMV or MBGMV kernels). The active mask,
    slot map and block table are uploaded only when the batch composition
    changes: zero host->device transfers in steady state.
  * `megastep` — K decode iterations in one call: a Python loop over the
    same `_fused_step`, so it equals K single steps exactly. (A CUDA graph
    per K is later work.)

The port updates the KV pool and the pipeline state in place. Chunked
prefill, the dense memory plane, the per-step baseline pipeline and
temperature sampling raise NotImplementedError (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import DevicePool, HostLoRAStore, StagingCache
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.weights import init_params
from repro_torch.serving import cache as cache_lib
from repro_torch.serving.request import RequestState
from repro_torch.serving.sampling import sample

PIPELINES = ("fused", "perstep")
MEGASTEP_MAX = 8          # default cap on iterations fused into one call


def bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               "(ROADMAP.md queue 1)")


class DecodePipeline:
    """Device-resident per-row decode state + the async readback queue.

    Tensors (all (max_batch,) on the device):

      last_tok — last sampled token per row (next step's input)
      pos      — next decode position per row
      target   — stop position: the row freezes once pos reaches it
      active   — host-owned mask of rows in the current decode batch
      idx      — host-owned LoRA pool slot per row (-1: none)
      block_table — (max_batch, W) logical -> physical page, -1 unclaimed

    `active`/`idx`/`block_table` change only on events (admission,
    retirement, a boundary page claim); `refresh` re-uploads them only
    when their host signature changes.

    Readback: `stash` starts a non-blocking copy of the step's tokens into
    pinned host memory and records an event; the queue drains one step
    behind, waiting only for that event, so step k-1's tokens cross while
    step k runs. `flush` drains everything."""

    def __init__(self, max_batch: int, stats: Dict[str, int],
                 bt_width: int, device: torch.device):
        self.max_batch = max_batch
        self.stats = stats
        self.device = device
        i32 = dict(dtype=torch.int32, device=device)
        self.last_tok = torch.zeros(max_batch, **i32)
        self.pos = torch.zeros(max_batch, **i32)
        self.target = torch.zeros(max_batch, **i32)
        self.active = torch.zeros(max_batch, dtype=torch.bool, device=device)
        self.idx = torch.full((max_batch,), -1, **i32)
        self.bt_width = bt_width
        self.block_table = torch.full((max_batch, bt_width), -1, **i32)
        self._sig: Optional[bytes] = None
        self._pending: List[Tuple[torch.Tensor, Optional[torch.cuda.Event],
                                  List[Tuple[RequestState, int, int]]]] = []
        self.readback_depth = 1

    # ------------------------------------------------------- row state ----
    def refresh(self, ready: List[RequestState], row_slot, row_pages):
        """Sync the active mask, LoRA slot map and block table with the
        engine's ready set; uploads only when the composition changed."""
        active = np.zeros((self.max_batch,), bool)
        for st in ready:
            active[st.row] = True
        idx = np.asarray(row_slot, np.int64).copy()
        idx[~active] = -1
        bt = np.full((self.max_batch, self.bt_width), -1, np.int32)
        for st in ready:
            pg = row_pages[st.row]
            bt[st.row, :len(pg)] = pg
        sig = active.tobytes() + idx.tobytes() + bt.tobytes()
        if sig != self._sig:
            self.active = _upload(active, self.device)
            self.idx = _upload(idx.astype(np.int32), self.device)
            self.block_table = _upload(bt, self.device)
            self._sig = sig
            self.stats["h2d"] += 3
            self.stats["h2d_bytes"] += active.nbytes + 4 * self.max_batch \
                + bt.nbytes

    # -------------------------------------------------------- readback ----
    def stash(self, toks: torch.Tensor,
              entries: List[Tuple[RequestState, int, int]]):
        """Queue a step's token tensor; each entry (st, col, n) drains n
        tokens for `st` from column `col` (prefill: batch index,
        decode/megastep: engine row)."""
        for st, _, n in entries:
            st.pending_tokens += n
        host = torch.empty(toks.shape, dtype=toks.dtype,
                           pin_memory=toks.is_cuda)
        host.copy_(toks, non_blocking=True)
        ev = None
        if toks.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        self._pending.append((host, ev, entries))
        while len(self._pending) > self.readback_depth:
            self._drain_one()

    def _drain_one(self):
        host, ev, entries = self._pending.pop(0)
        if ev is not None:
            ev.synchronize()
        arr = host.numpy()
        self.stats["d2h"] += 1
        self.stats["d2h_bytes"] += arr.nbytes
        for st, col, n in entries:
            vals = [int(arr[col])] if arr.ndim == 1 \
                else [int(v) for v in arr[:n, col]]
            st.generated.extend(vals)
            st.pending_tokens -= n

    def flush(self):
        while self._pending:
            self._drain_one()


class NumericsBackend:
    def __init__(self, cfg: ModelConfig, *, kernel: str, max_batch: int,
                 cache_slots: int, store: HostLoRAStore, pool: DevicePool,
                 params=None, seed: int = 0, pipeline: str = "fused",
                 megastep: int = MEGASTEP_MAX, temperature: float = 0.0,
                 staging_slots: int = 16, memory: str = "paged",
                 page_size: int = 32, allocator=None, device=None):
        if pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {pipeline!r}")
        if memory not in ("dense", "paged"):
            raise ValueError(f"unknown memory plane {memory!r}")
        if pipeline != "fused":
            raise _not_ported(f"pipeline={pipeline!r}")
        if memory != "paged":
            raise _not_ported(f"memory={memory!r}")
        if temperature > 0.0:
            raise _not_ported("temperature sampling")
        if not model_lib.supports_paged(cfg):
            raise ValueError(
                f"{cfg.name}: family does not support the paged cache")
        if cache_slots % page_size:
            raise ValueError(
                f"cache_slots ({cache_slots}) must be a multiple of "
                f"page_size ({page_size}) so a row's block table tiles "
                "its ring exactly")
        if allocator is None:
            raise ValueError("memory='paged' requires a PageAllocator")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kernel = kernel
        self.max_batch = max_batch
        self.cache_slots = cache_slots
        self.store = store
        self.pool = pool
        self.pipeline = pipeline
        self.megastep_max = megastep
        self.temperature = temperature
        self.paged = True
        self.page_size = page_size
        self.allocator = allocator
        self.bt_width = cache_slots // page_size
        self.params = params if params is not None \
            else init_params(cfg, seed, self.device)
        row_cache = model_lib.cache_abstract(cfg, 1, cache_slots)
        self.cache = cache_lib.zeros_paged(row_cache, allocator.n_pages,
                                           page_size, self.device)
        self.transfer_stats: Dict[str, int] = {
            "h2d": 0, "h2d_bytes": 0, "d2h": 0, "d2h_bytes": 0,
            "decode_steps": 0, "megasteps": 0, "megastep_iters": 0,
            "prefills": 0, "prefill_chunks": 0}
        self.pipe = DecodePipeline(max_batch, self.transfer_stats,
                                   self.bt_width, self.device)
        self.staging = StagingCache(staging_slots,
                                    on_upload=self._count_upload,
                                    device=self.device)

    def _mode_str(self):
        return "bgmv" if self.kernel == "bgmv" else "mbgmv"

    def _count_upload(self, nbytes: int):
        self.transfer_stats["h2d"] += 1
        self.transfer_stats["h2d_bytes"] += nbytes

    def flush_readback(self):
        """Drain every queued async token readback (end of run, or before
        host code that needs `st.generated` current)."""
        self.pipe.flush()

    # ------------------------------------------------------ preemption ----
    def swap_out(self, pages: List[int]):
        """Copy a preemption victim's KV pages to host memory; returns the
        payload `swap_in` restores from."""
        payload = cache_lib.extract_pages(self.cache, pages)
        self.transfer_stats["d2h"] += 1
        self.transfer_stats["d2h_bytes"] += cache_lib.tree_nbytes(payload)
        return payload

    def swap_in(self, states: List[RequestState], row_pages):
        """Restore swap-preempted rows: insert each saved payload into the
        freshly claimed pages and re-seed the pipeline's per-row state, so
        the row continues decoding exactly where it stopped."""
        pipe = self.pipe
        for st in states:
            payload, st.swap_payload = st.swap_payload, None
            cache_lib.insert_pages(self.cache, payload, st.kv_pages)
            self.transfer_stats["h2d"] += 1
            self.transfer_stats["h2d_bytes"] += \
                cache_lib.tree_nbytes(payload)
            r = st.row
            pipe.last_tok[r] = int(st.generated[-1])
            pipe.pos[r] = int(st.resume_pos)
            pipe.target[r] = st.req.prompt_len + st.req.max_new_tokens - 1

    def clear_pages(self, ids: List[int]):
        """Scrub freshly grown pages (pos = -1): a page claimed mid-decode
        may carry a previous tenant's positions."""
        cache_lib.clear_pages(self.cache, ids)

    def restore_pages(self, st: RequestState):
        raise _not_ported("chunked prefill (restore_pages)")

    def prefill_chunk(self, st, row_pages, start, n_tokens, final):
        raise _not_ported("chunked prefill")

    # ---------------------------------------------------------- prefill ----
    def _lora_arg_stacked(self, uids: List[str]):
        """Batch-N lora arg (CPU-assist path numerics): request i reads
        pseudo-slot i of a pool stacked from the staged device copies."""
        ws = [self.staging.get(u, self.store) for u in uids]
        pool = {t: {"a": torch.stack([w[t]["a"] for w in ws], 1),
                    "b": torch.stack([w[t]["b"] for w in ws], 1)}
                for t in ws[0]}
        ranks = [min(self.store.specs[u].rank, self.cfg.lora.max_rank)
                 for u in uids]
        pool["ranks"] = _upload(np.asarray(ranks, np.int32), self.device)
        return {"pool": pool,
                "idx": torch.arange(len(uids), dtype=torch.int32,
                                    device=self.device)}

    @torch.no_grad()
    def prefill_admitted(self, states: List[RequestState]):
        """One padded prefill call for all requests admitted this
        iteration: samples each row's first token on the device, writes
        every row cache into its pages, and seeds the decode pipeline's
        last-token / position / stop-target state; tokens reach
        `st.generated` through the async readback queue.

        Recompute resumes (`st.preempted`) ride the same call: the row
        prefills prompt + generated[:-1] and, under greedy, re-samples
        exactly generated[-1], which re-seeds last_tok. No token is
        emitted for resumed rows."""
        if not states:
            return
        lens = np.array([min(st.resume_pos, self.cache_slots)
                         if st.preempted else st.req.prompt_len
                         for st in states])
        if int(lens.max()) > self.cache_slots:
            bad = [st.req.rid for st in states
                   if st.req.prompt_len > self.cache_slots]
            raise ValueError(
                f"requests {bad}: prompt exceeds the {self.bt_width}-page "
                f"block table (page_size {self.page_size}) per row — the "
                "engine must reject these at submit time")
        Lp = min(bucket(int(lens.max())), self.cache_slots)
        Nb = bucket(len(states), lo=1)
        N = len(states)
        toks = np.zeros((Nb, Lp), np.int32)
        lens_b = np.ones((Nb,), np.int32)
        rows = np.zeros((N,), np.int64)
        tgts = np.zeros((N,), np.int32)
        for i, st in enumerate(states):
            if st.preempted:
                seq = np.asarray(
                    list(st.req.prompt) + list(st.generated[:-1]), np.int32)
                if len(seq) != lens[i]:
                    raise RuntimeError(
                        f"resume length mismatch for {st.req.rid}: "
                        f"{len(seq)} != {lens[i]}")
                toks[i, :lens[i]] = seq
            else:
                toks[i, :lens[i]] = st.req.prompt
            lens_b[i] = lens[i]
            rows[i] = st.row
            # a resumed row owes the remaining tokens, not max_new more
            tgts[i] = st.req.prompt_len + st.req.max_new_tokens - 1
        uids = [st.req.adapter_uid for st in states]
        lora = self._lora_arg_stacked(uids + [uids[0]] * (Nb - N))
        lora["mode"] = self._mode_str()
        ps = self.page_size
        Sp = -(-Lp // ps) * ps          # prefill cache depth, page-tiled
        npr = Sp // ps
        page_ids = np.full((Nb, npr), -1, np.int64)
        claimed: List[int] = []
        for i, st in enumerate(states):
            page_ids[i, :min(len(st.kv_pages), npr)] = st.kv_pages[:npr]
            claimed.extend(st.kv_pages)
        self.transfer_stats["h2d"] += 6    # toks, lens, rows, targets,
        self.transfer_stats["h2d_bytes"] += (  # page ids, clear list
            toks.nbytes + lens_b.nbytes + rows.nbytes + tgts.nbytes
            + page_ids.nbytes + 8 * len(claimed))
        self.transfer_stats["prefills"] += 1

        lens_d = _upload(lens_b, self.device)
        logits, row_caches = model_lib.prefill(
            self.cfg, self.params, {"tokens": _upload(toks, self.device)},
            lora=lora,
            cache_slots=Sp, last_pos=lens_d - 1)
        toks_out = sample(logits[:, 0], temperature=self.temperature)
        # slots past each request's true length never become attendable
        live = torch.arange(Sp, device=self.device)[None, None] \
            < lens_d[None, :, None]
        row_caches["pos"] = torch.where(live, row_caches["pos"], -1)
        # pages reclaimed from a retired row carry stale positions the
        # attention mask would trust: scrub every claimed page first
        if claimed:
            cache_lib.clear_pages(self.cache, claimed)
        cache_lib.scatter_pages(self.cache, row_caches, page_ids)
        pipe = self.pipe
        rows_d = _upload(rows, self.device)
        pipe.last_tok[rows_d] = toks_out[:N]
        pipe.pos[rows_d] = lens_d[:N]
        pipe.target[rows_d] = _upload(tgts, self.device)
        for st in states:
            if not st.preempted:
                st.token_times_ms.append(st.first_token_ms)
        # resumed rows re-sample a token they already emitted — exclude
        # them from the stash so the readback never appends it again
        pipe.stash(toks_out, [(st, i, 1) for i, st in enumerate(states)
                              if not st.preempted])

    # ----------------------------------------------------------- decode ----
    def _fused_step(self, lora, active):
        """One decode iteration shared by `decode` and `megastep`, so K
        fused iterations equal K single calls. Rows that are inactive or at
        their stop target drop their KV write (sink page), keep their token
        and position. Returns the step's (max_batch,) tokens."""
        pipe = self.pipe
        act = active & (pipe.pos < pipe.target)
        logits, _ = model_lib.decode(
            self.cfg, self.params, self.cache, pipe.last_tok[:, None],
            pipe.pos, lora=lora, write_mask=act,
            block_table=pipe.block_table)
        toks = sample(logits[:, -1], temperature=self.temperature)
        pipe.last_tok = torch.where(act, toks, pipe.last_tok)
        pipe.pos = torch.where(act, pipe.pos + 1, pipe.pos)
        return toks

    def _lora_arg(self):
        return {"pool": self.pool.pool, "idx": self.pipe.idx,
                "mode": self._mode_str()}

    @torch.no_grad()
    def decode(self, ready: List[RequestState], row_slot, row_pos,
               row_pages=None):
        """One decode iteration over the ready rows."""
        self.transfer_stats["decode_steps"] += 1
        pipe = self.pipe
        pipe.refresh(ready, row_slot, row_pages)
        toks = self._fused_step(self._lora_arg(), pipe.active)
        pipe.stash(toks, [(st, st.row, 1) for st in ready])

    @torch.no_grad()
    def megastep(self, ready: List[RequestState], nsteps: List[int], K: int,
                 row_slot, row_pages=None):
        """K decode iterations in one call; per-row stop targets freeze
        rows that reach max_new_tokens mid-window. `nsteps[i]` = tokens
        request i actually produces; the (K, B) token block drains through
        the async readback queue like any other step."""
        if K < 2:
            raise RuntimeError(f"megastep needs K >= 2 (K={K})")
        self.transfer_stats["decode_steps"] += K
        self.transfer_stats["megasteps"] += 1
        self.transfer_stats["megastep_iters"] += K
        pipe = self.pipe
        pipe.refresh(ready, row_slot, row_pages)
        lora = self._lora_arg()
        ys = torch.stack([self._fused_step(lora, pipe.active)
                          for _ in range(K)])
        pipe.stash(ys, [(st, st.row, n) for st, n in zip(ready, nsteps)])
