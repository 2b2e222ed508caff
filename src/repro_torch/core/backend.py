"""Numerics plane of the inference server: real PyTorch computation.

Mirrors `repro.core.backend`: the base-model weights, the KV memory plane
(the paged pool, or the dense per-row slab with bf16/f32 or int8 KV),
LoRA argument construction and a **device-resident decode pipeline**
(`DecodePipeline`): sampling (greedy, or temperature through the
pipeline's `torch.Generator`) runs on the device, per-row last-token /
position / stop-target state lives in device tensors, and the host reads
tokens back one step behind (the previous step's tokens are copied to
pinned memory while the current step runs). Entry points:

  * `prefill_admitted` — **batched multi-request prefill**: every request
    admitted in one iteration is packed into one padded (N, L) call
    (per-request LoRA weights come from the device `StagingCache`, copied
    into a staging pool of `max_batch` slots), bucketed to powers of two
    like the reference. The
    residual stream is gathered at each row's last position before the
    unembed, the first token is sampled on the device, and the row caches
    land in their claimed pages (paged) or their slab rows (dense) with
    one indexed write per leaf.
  * `decode` — one iteration over the ready rows against the KV plane and
    the device LoRA slot pool (BGMV or MBGMV kernels). The active mask,
    slot map and block table are uploaded only when the batch composition
    changes: zero host->device transfers in steady state.
  * `megastep` — K decode iterations in one call: a Python loop over the
    same `_fused_step`, so it equals K single steps exactly, temperature
    draws included.
  * `prefill_chunk` — one chunk of a long prompt's prefill for one row
    (chunked prefill, paged plane only), written into the row's claimed
    pages in place; only the final chunk samples and seeds the row's
    pipeline state.

On the card `decode`, each `megastep[K=k]`, each prefill bucket of at
most `graph_tokens` tokens (`prefill[Nb=n,Lp=l]`; larger buckets run
eagerly, counted) and each chunk width (`prefill_chunk[C=c]`,
`prefill_chunk_final[C=c]`) run as CUDA graphs (`core.graphs.StepGraphs`,
the counterpart of the reference's jitted, donated steps): every tensor
a step reads keeps its storage, and the steps, `refresh`, swap-in and
the staging of adapters write it in place; host-built metadata goes up
through pinned staging without blocking the host, a prefill's or a
chunk's into its static inputs (`core.graphs.StaticInputs`).
`graphs=False` runs every step eagerly (a comparison arm). Under the
sanitizers (``REPRO_SANITIZE=1``) `retrace_san` watches the graphs for a
re-capture after steady state, as the reference's RetraceSan watches its
trace caches.

`pipeline="perstep"` keeps the reference's pre-pipeline baseline on the
dense plane: host-built token and position arrays each step, greedy
sampling off the full logits, a synchronous readback, and a flush after
each prefill. The port updates the KV plane and the pipeline state in
place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import retrace, sanitizers
from repro_torch.configs.base import ModelConfig
from repro_torch.core.graphs import StaticInputs, StepGraphs, leaves
from repro_torch.core.lora import (DevicePool, HostLoRAStore, StagingCache,
                                   pool_init, pool_insert)
from repro_torch.device import resolve_device, upload
from repro_torch.models import model as model_lib
from repro_torch.models.weights import init_params
from repro_torch.serving import cache as cache_lib
from repro_torch.serving.request import RequestState
from repro_torch.serving.sampling import sample

PIPELINES = ("fused", "perstep")
MEGASTEP_MAX = 8          # default cap on iterations fused into one call
# the largest prefill bucket (Nb x Lp tokens) run as a CUDA graph; larger
# ones run eagerly, counted in `StepGraphs.stats()` (PERF.md section 6,
# PR 23: a graph keeps its activations in the pool for good, and a bucket
# this large is device-bound)
PREFILL_GRAPH_TOKENS = 4096


def bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _mask_pad_slots(row_caches, lens):
    """Invalidate, in place, every `pos` slot at or past each row's true
    prompt length (`lens`, one a batch row), so the packed call's pad
    tokens never become attendable. As the reference's, only `pos` leaves
    are touched: a recurrent family's state (SSM state, conv tails,
    RG-LRU h) keeps what the bucket's pad tokens wrote, so its tokens
    depend on the bucket padding (ROADMAP.md section 3)."""
    for name, x in cache_lib.tree_leaves(row_caches):
        if name == "pos":
            live = torch.arange(x.shape[-1], device=x.device)[None] \
                < lens[:, None]
            while live.dim() < x.dim():        # stacked: (L, B, slots)
                live = live[None]
            x.masked_fill_(~live, -1)


class DecodePipeline:
    """Device-resident per-row decode state + the async readback queue.

    Tensors (all (max_batch,) on the device):

      last_tok — last sampled token per row (next step's input)
      pos      — next decode position per row
      target   — stop position: the row freezes once pos reaches it
      active   — host-owned mask of rows in the current decode batch
      idx      — host-owned LoRA pool slot per row (-1: none)
      block_table — paged plane: (max_batch, W) logical -> physical page,
                 -1 unclaimed; None on the dense plane

    `active`/`idx`/`block_table` change only on events (admission,
    retirement, a boundary page claim); `refresh` re-uploads them only
    when their host signature changes. Every buffer keeps its storage for
    the pipeline's life (a captured step reads it by address): writes go
    in place. `gen` is the sampling generator
    (the reference threads a PRNG key through its step state).

    Readback: `stash` starts a non-blocking copy of the step's tokens into
    pinned host memory and records an event; the queue drains one step
    behind, waiting only for that event, so step k-1's tokens cross while
    step k runs. `flush` drains everything."""

    def __init__(self, max_batch: int, seed: int, stats: Dict[str, int],
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
        self.block_table = torch.full((max_batch, bt_width), -1, **i32) \
            if bt_width else None
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self._sig: Optional[bytes] = None
        self._pending: List[Tuple[torch.Tensor, Optional[torch.cuda.Event],
                                  List[Tuple[RequestState, int, int]]]] = []
        self.readback_depth = 1

    # ------------------------------------------------------- row state ----
    def refresh(self, ready: List[RequestState], row_slot, row_pages):
        """Sync the active mask, LoRA slot map and block table with the
        engine's ready set; uploads, in place, only when the composition
        changed."""
        active = np.zeros((self.max_batch,), bool)
        for st in ready:
            active[st.row] = True
        idx = np.asarray(row_slot, np.int64).copy()
        idx[~active] = -1
        sig = active.tobytes() + idx.tobytes()
        bt = None
        if self.bt_width:
            bt = np.full((self.max_batch, self.bt_width), -1, np.int32)
            for st in ready:
                pg = row_pages[st.row]
                bt[st.row, :len(pg)] = pg
            sig += bt.tobytes()
        if sig != self._sig:
            upload(active, self.device, out=self.active)
            upload(idx.astype(np.int32), self.device, out=self.idx)
            self._sig = sig
            self.stats["h2d"] += 2
            self.stats["h2d_bytes"] += active.nbytes + 4 * self.max_batch
            if bt is not None:
                upload(bt, self.device, out=self.block_table)
                self.stats["h2d"] += 1
                self.stats["h2d_bytes"] += bt.nbytes

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
            # lint: allow-host-sync — the readback drain: waits only for
            # the event of a step already one behind the one queued now
            ev.synchronize()
        # lint: allow-host-sync — `host` is the pinned host copy the event
        # guarded; reading it moves nothing across the link
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
                 page_size: int = 32, allocator=None, device=None,
                 graphs: bool = True):
        if pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {pipeline!r}")
        if memory not in ("dense", "paged"):
            raise ValueError(f"unknown memory plane {memory!r}")
        if pipeline == "perstep" and temperature > 0.0:
            raise ValueError(
                "pipeline='perstep' is the greedy-only legacy baseline; "
                "temperature sampling needs the fused pipeline (its "
                "generator lives in the device-resident step state)")
        if cfg.family in ("audio", "encdec"):
            raise ValueError(
                f"{cfg.name}: the server passes each request's tokens only, "
                "and an encoder-decoder model needs its encoder input "
                "(enc_embeds) at prefill; drive it through model.prefill / "
                "model.decode (the reference's server cannot serve it "
                "either)")
        self.paged = memory == "paged"
        if self.paged:
            if pipeline != "fused":
                raise ValueError(
                    "the paged memory plane rides the fused pipeline")
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
        self.megastep_max = megastep if pipeline == "fused" else 0
        self.temperature = temperature
        self.page_size = page_size
        self.allocator = allocator
        self.bt_width = cache_slots // page_size if self.paged else 0
        self.params = params if params is not None \
            else init_params(cfg, seed, self.device)
        row_cache = model_lib.cache_abstract(cfg, 1, cache_slots)
        self.cache = cache_lib.zeros_paged(
            row_cache, allocator.n_pages, page_size, self.device) \
            if self.paged else cache_lib.zeros_like_batched(
                row_cache, max_batch, self.device)
        self.transfer_stats: Dict[str, int] = {
            "h2d": 0, "h2d_bytes": 0, "d2h": 0, "d2h_bytes": 0,
            "decode_steps": 0, "megasteps": 0, "megastep_iters": 0,
            "prefills": 0, "prefill_chunks": 0}
        self.pipe = DecodePipeline(max_batch, seed + 1, self.transfer_stats,
                                   self.bt_width, self.device)
        self.staging = StagingCache(staging_slots,
                                    on_upload=self._count_upload,
                                    device=self.device)
        # the prefill's and chunk's LoRA staging pool: slot i holds the
        # staged adapter of the call's i-th request, written in place
        self.stage = pool_init(cfg, max_batch, self.device)
        # the static inputs of each prefill bucket and chunk width
        self.inputs: Dict[str, StaticInputs] = {}
        self.graph_tokens = PREFILL_GRAPH_TOKENS
        # the decode / megastep[K=k] / prefill / chunk graphs (captured on
        # the card only); RetraceSan (REPRO_SANITIZE=1) watches them for a
        # re-capture after steady state
        self.graphs = StepGraphs(self.device, capture=graphs)
        self.retrace_san = (retrace.RetraceSan()
                            if sanitizers.enabled() else None)

    def _san_check(self, ids, prefix: str, op: str) -> None:
        """PageSan access check (REPRO_SANITIZE=1) for host-known page id
        lists (no device sync: every id list here is host-built)."""
        san = getattr(self.allocator, "san", None) \
            if self.allocator is not None else None
        if san is not None:
            san.check_access(ids, prefix, op)

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
        self._san_check(pages, "kv:", "swap-out extract")
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
            self._san_check(st.kv_pages, "kv:", "swap-in insert")
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
        self._san_check(ids, "kv:", "page scrub")
        cache_lib.clear_pages(self.cache, ids)

    def restore_pages(self, st: RequestState):
        """Swap-in for a half-prefilled (chunk-phase) row: reinsert the
        saved page payload only. Unlike `swap_in` there is no pipeline
        re-seed — the row has no sampled token yet; its next chunk simply
        continues from st.prefill_pos against the restored pages."""
        payload, st.swap_payload = st.swap_payload, None
        self._san_check(st.kv_pages, "kv:", "chunk swap-in insert")
        cache_lib.insert_pages(self.cache, payload, st.kv_pages)
        self.transfer_stats["h2d"] += 1
        self.transfer_stats["h2d_bytes"] += cache_lib.tree_nbytes(payload)

    def _static(self, key: str, shapes) -> StaticInputs:
        """The static inputs under `key`, allocated on first use."""
        si = self.inputs.get(key)
        if si is None:
            si = self.inputs[key] = StaticInputs(shapes, self.device)
        return si

    @torch.no_grad()
    def prefill_chunk(self, st: RequestState, row_pages: List[int],
                      start: int, n_tokens: int, final: bool):
        """One chunk of an incremental prefill for a single row: consume
        prompt[start : start+n_tokens] against the row's claimed pages,
        writing the chunk's K/V into them in place. Only the final chunk
        samples — through the same last-position gather, sample and
        pipeline seed as `prefill_admitted`; its token reaches
        `st.generated` through the readback queue. The chunk width is
        bucketed (powers of two, capped at cache_slots) like the
        reference's, and each (width, final) runs as a graph
        (`prefill_chunk[C=c]`, `prefill_chunk_final[C=c]`): the tokens,
        start, length, row, the row's page ids (padded to the block
        table's width with -1, as the reference pads them) and the stop
        target go up in one upload into the width's static inputs."""
        if not self.paged:
            raise RuntimeError("chunked prefill rides the paged memory "
                               "plane (memory='paged')")
        if start + n_tokens > self.cache_slots:
            raise ValueError(
                f"request {st.req.rid}: chunk [{start}, {start + n_tokens})"
                f" exceeds the {self.cache_slots}-slot block table")
        Cb = min(bucket(n_tokens), self.cache_slots)
        si = self._static(f"chunk[C={Cb}]", {
            "tokens": (1, Cb), "start": (), "clen": (), "row": (1,),
            "plen": (1,), "tgt": (1,), "ids": (self.bt_width,),
            "idx": (1,)})
        h = si.host
        h["tokens"][:] = 0
        h["tokens"][0, :n_tokens] = st.req.prompt[start:start + n_tokens]
        h["start"][...], h["clen"][...] = start, n_tokens
        h["row"][0], h["plen"][0] = st.row, st.req.prompt_len
        h["tgt"][0] = st.req.prompt_len + st.req.max_new_tokens - 1
        h["ids"][:] = -1
        h["ids"][:len(row_pages)] = row_pages
        self._san_check(list(row_pages), "kv:", "chunk scatter")
        self._stage_adapters([st.req.adapter_uid])
        self.transfer_stats["h2d"] += 1    # tokens, positions, page ids
        self.transfer_stats["h2d_bytes"] += si.upload()
        self.transfer_stats["prefill_chunks"] += 1
        name = "prefill_chunk_final" if final else "prefill_chunk"
        tok = self._run(f"{name}[C={Cb}]", leaves(self.stage) + [si.flat],
                        lambda: self._chunk_step(si, final))
        if final:
            self.pipe.stash(tok, [(st, 0, 1)])

    def _chunk_step(self, si: StaticInputs, final: bool):
        """The captured chunk step: the chunk through the stack into the
        row's pages; the final chunk samples and seeds the row's pipeline
        state (its row, from the static inputs)."""
        lora = {"pool": self.stage, "idx": si["idx"],
                "mode": self._mode_str()}
        logits = model_lib.prefill_chunk(
            self.cfg, self.params, si["tokens"], si["start"], si["clen"],
            self.cache, si["ids"], lora=lora, last=final)
        if not final:
            return None
        pipe = self.pipe
        tok = sample(logits[:, 0], temperature=self.temperature,
                     generator=pipe.gen)
        r = si["row"].long()
        pipe.last_tok[r] = tok
        pipe.pos[r] = si["plen"]
        pipe.target[r] = si["tgt"]
        return tok

    # ---------------------------------------------------------- prefill ----
    def _stage_adapters(self, uids: List[str]) -> None:
        """Write request i's adapter (its staged device copy) into slot i
        of the staging pool, and its rank, in place."""
        if len(uids) > self.max_batch:
            raise ValueError(f"{len(uids)} adapters for a staging pool of "
                             f"{self.max_batch} slots")
        for i, u in enumerate(uids):
            pool_insert(self.stage, self.cfg, self.staging.get(u, self.store),
                        i, min(self.store.specs[u].rank,
                               self.cfg.lora.max_rank))

    def _lora_arg_stacked(self, uids: List[str]):
        """Batch-N lora arg (CPU-assist path numerics): request i reads
        slot i of the staging pool, written from the staged device
        copies."""
        self._stage_adapters(uids)
        return {"pool": self.stage,
                "idx": torch.arange(len(uids), dtype=torch.int32,
                                    device=self.device)}

    @torch.no_grad()
    def prefill_admitted(self, states: List[RequestState]):
        """One padded prefill call for all requests admitted this
        iteration: samples each row's first token on the device, writes
        every row cache into its pages, and seeds the decode pipeline's
        last-token / position / stop-target state; tokens reach
        `st.generated` through the async readback queue.

        The call is bucketed to (Nb, Lp) like the reference's, and a
        bucket of at most `graph_tokens` tokens runs as a graph
        (`prefill[Nb=n,Lp=l]`); larger buckets run eagerly, counted in
        the key's `eager`. The host-built tokens, lengths, rows, stop
        targets, LoRA slots and page ids go up in one upload into the
        bucket's static inputs. The N requests fill the first N of Nb
        entries; a pad entry repeats entry 0's row, slot, target and
        batch entry (its writes repeat entry 0's values), its tokens are
        0, its length 1, and its pages the sink.

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
            unit = (f"{self.bt_width}-page block table "
                    f"(page_size {self.page_size})" if self.paged
                    else f"{self.cache_slots} KV-cache slots") + " per row"
            raise ValueError(
                f"requests {bad}: prompt exceeds the {unit} — the engine "
                "must reject these at submit time")
        Lp = min(bucket(int(lens.max())), self.cache_slots)
        Nb = bucket(len(states), lo=1)
        N = len(states)
        ps = self.page_size
        # the row caches' depth: page-tiled on the paged plane; on the
        # dense plane the slab row past Lp is cleared by scatter_rows
        Sp = -(-Lp // ps) * ps if self.paged else Lp
        npr = Sp // ps if self.paged else 0
        shapes = {"tokens": (Nb, Lp), "lens": (Nb,), "rows": (Nb,),
                  "sel": (Nb,), "tgts": (Nb,), "idx": (Nb,)}
        if self.paged:
            shapes.update(page_ids=(Nb, npr), clear=(Nb * self.bt_width,))
        name = f"prefill[Nb={Nb},Lp={Lp}]"
        si = self._static(name, shapes)
        h = si.host
        h["tokens"][:] = 0
        h["lens"][:] = 1
        for i, st in enumerate(states):
            if st.preempted:
                seq = np.asarray(
                    list(st.req.prompt) + list(st.generated[:-1]), np.int32)
                if len(seq) != lens[i]:
                    raise RuntimeError(
                        f"resume length mismatch for {st.req.rid}: "
                        f"{len(seq)} != {lens[i]}")
                h["tokens"][i, :lens[i]] = seq
            else:
                h["tokens"][i, :lens[i]] = st.req.prompt
            h["lens"][i] = lens[i]
            h["rows"][i] = st.row
            # a resumed row owes the remaining tokens, not max_new more
            h["tgts"][i] = st.req.prompt_len + st.req.max_new_tokens - 1
        h["sel"][:N] = np.arange(N)
        h["idx"][:N] = np.arange(N)
        for k in ("rows", "sel", "tgts", "idx"):
            h[k][N:] = h[k][0]
        if self.paged:
            self._page_ids(states, h["page_ids"], h["clear"], npr)
        self._stage_adapters([st.req.adapter_uid for st in states])
        self.transfer_stats["h2d"] += 1    # every input in one upload
        self.transfer_stats["h2d_bytes"] += si.upload()
        self.transfer_stats["prefills"] += 1
        toks = self._run(name, leaves(self.stage) + [si.flat],
                         lambda: self._prefill_step(si, Sp),
                         graph=Nb * Lp <= self.graph_tokens)
        for st in states:
            if not st.preempted:
                st.token_times_ms.append(st.first_token_ms)
        # resumed rows re-sample a token they already emitted — exclude
        # them from the stash so the readback never appends it again
        self.pipe.stash(toks, [(st, i, 1) for i, st in enumerate(states)
                               if not st.preempted])
        if self.pipeline == "perstep":
            self.pipe.flush()  # legacy path: synchronous readback

    def _page_ids(self, states, page_ids, clear, npr: int):
        """Fill a bucket's page ids (each request's first npr claimed
        pages, where its row caches land) and its scrub list (every
        claimed page), the rest -1: the sink."""
        page_ids[:] = -1
        clear[:] = -1
        n = 0
        for i, st in enumerate(states):
            page_ids[i, :min(len(st.kv_pages), npr)] = st.kv_pages[:npr]
            clear[n:n + len(st.kv_pages)] = st.kv_pages
            n += len(st.kv_pages)
        self._san_check([p for st in states for p in st.kv_pages], "kv:",
                        "prefill scatter")

    def _prefill_step(self, si: StaticInputs, Sp: int) -> torch.Tensor:
        """The captured prefill step over a bucket's static inputs:
        samples every entry's first token, writes the row caches into
        their pages (scrubbing every claimed page first: a page reclaimed
        from a retired row carries stale positions the attention mask
        would trust) or slab rows, and seeds the pipeline's state."""
        pipe = self.pipe
        lens = si["lens"]
        lora = {"pool": self.stage, "idx": si["idx"],
                "mode": self._mode_str()}
        logits, row_caches = model_lib.prefill(
            self.cfg, self.params, {"tokens": si["tokens"]}, lora=lora,
            cache_slots=Sp, last_pos=lens - 1)
        toks = sample(logits[:, 0], temperature=self.temperature,
                      generator=pipe.gen)
        _mask_pad_slots(row_caches, lens)
        rows, sel = si["rows"].long(), si["sel"].long()
        if self.paged:
            cache_lib.clear_pages(self.cache, si["clear"])
            cache_lib.scatter_pages(self.cache, row_caches, si["page_ids"])
        else:
            cache_lib.scatter_rows(self.cache, row_caches, rows, sel)
        pipe.last_tok[rows] = toks[sel]
        pipe.pos[rows] = lens[sel]
        pipe.target[rows] = si["tgts"]
        return toks

    # ----------------------------------------------------------- decode ----
    def _fused_step(self, lora, active):
        """One decode iteration shared by `decode` and `megastep`, so K
        fused iterations equal K single calls. Rows that are inactive or at
        their stop target drop their KV write (the sink page, or their
        dense slot written back unchanged), keep their token and position.
        Writes the pipeline's state in place (it runs under a CUDA graph).
        Returns the step's (max_batch,) tokens."""
        pipe = self.pipe
        act = active & (pipe.pos < pipe.target)
        logits, _ = model_lib.decode(
            self.cfg, self.params, self.cache, pipe.last_tok[:, None],
            pipe.pos, lora=lora, write_mask=act,
            block_table=pipe.block_table)
        toks = sample(logits[:, -1], temperature=self.temperature,
                      generator=pipe.gen)
        pipe.last_tok.copy_(torch.where(act, toks, pipe.last_tok))
        pipe.pos.add_(act.to(pipe.pos.dtype))
        return toks

    def _lora_arg(self):
        return {"pool": self.pool.pool, "idx": self.pipe.idx,
                "mode": self._mode_str()}

    def _run(self, name: str, reads: List[torch.Tensor], step,
             graph: bool = True) -> torch.Tensor:
        """`step` under graph key `name` (`core.graphs`): its signature
        covers the pipeline's buffers, the KV plane's leaves and `reads`
        (the LoRA pool's leaves, the ranks included; a prefill's or a
        chunk's staging pool and static inputs)."""
        pipe = self.pipe
        bufs = [pipe.last_tok, pipe.pos, pipe.target, pipe.active, pipe.idx]
        if pipe.block_table is not None:
            bufs.append(pipe.block_table)
        inputs = bufs + leaves(self.cache) + reads
        gens = (pipe.gen,) if self.temperature > 0.0 else ()
        out = self.graphs.run(name, inputs, step, gens, graph=graph)
        if self.retrace_san is not None:
            self.retrace_san.observe(name, self.graphs.entries[name])
        return out

    def _run_step(self, name: str, step) -> torch.Tensor:
        """A decode / megastep call under key `name`: it reads the LoRA
        device pool."""
        return self._run(name, leaves(self.pool.pool), step)

    @torch.no_grad()
    def decode(self, ready: List[RequestState], row_slot, row_pos,
               row_pages=None):
        """One decode iteration over the ready rows."""
        self.transfer_stats["decode_steps"] += 1
        if self.pipeline == "perstep":
            return self._decode_perstep(ready, row_slot, row_pos)
        pipe = self.pipe
        if self.paged and row_pages is not None:
            self._san_check([p for st in ready for p in row_pages[st.row]],
                            "kv:", "decode block table")
        pipe.refresh(ready, row_slot, row_pages)
        lora = self._lora_arg()
        toks = self._run_step(
            "decode", lambda: self._fused_step(lora, pipe.active))
        pipe.stash(toks, [(st, st.row, 1) for st in ready])

    @torch.no_grad()
    def megastep(self, ready: List[RequestState], nsteps: List[int], K: int,
                 row_slot, row_pages=None):
        """K decode iterations in one call; per-row stop targets freeze
        rows that reach max_new_tokens mid-window. `nsteps[i]` = tokens
        request i actually produces; the (K, B) token block drains through
        the async readback queue like any other step."""
        if self.pipeline != "fused" or K < 2:
            raise RuntimeError(
                "megastep needs the fused pipeline and K >= 2 "
                f"(pipeline={self.pipeline!r}, K={K})")
        self.transfer_stats["decode_steps"] += K
        self.transfer_stats["megasteps"] += 1
        self.transfer_stats["megastep_iters"] += K
        pipe = self.pipe
        if self.paged and row_pages is not None:
            self._san_check([p for st in ready for p in row_pages[st.row]],
                            "kv:", "megastep block table")
        pipe.refresh(ready, row_slot, row_pages)
        lora = self._lora_arg()
        ys = self._run_step(f"megastep[K={K}]", lambda: torch.stack(
            [self._fused_step(lora, pipe.active) for _ in range(K)]))
        pipe.stash(ys, [(st, st.row, n) for st, n in zip(ready, nsteps)])

    # ------------------------------------------------ legacy (perstep) ----
    def _decode_perstep(self, ready, row_slot, row_pos):
        """Pre-pipeline baseline: host-built token/position arrays each
        step, greedy sampling off the full logits, synchronous readback.
        Every row writes its token (no write mask), as in the reference."""
        toks = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        live = np.zeros((self.max_batch,), bool)
        idx = np.asarray(row_slot).astype(np.int32)
        for st in ready:
            toks[st.row, 0] = st.generated[-1] if st.generated else 0
            pos[st.row] = row_pos[st.row]
            live[st.row] = True
        idx[~live] = -1
        lora = {"pool": self.pool.pool, "idx": upload(idx, self.device),
                "mode": self._mode_str()}
        self.transfer_stats["h2d"] += 3
        self.transfer_stats["h2d_bytes"] += (toks.nbytes + pos.nbytes
                                             + idx.nbytes)
        logits, _ = model_lib.decode(
            self.cfg, self.params, self.cache, upload(toks, self.device),
            upload(pos, self.device), lora=lora)
        # lint: allow-host-sync — the per-step pipeline's synchronous
        # readback, by design (the pre-pipeline baseline it keeps)
        new = sample(logits[:, -1]).cpu().numpy()
        self.transfer_stats["d2h"] += 1
        self.transfer_stats["d2h_bytes"] += new.nbytes
        for st in ready:
            st.generated.append(int(new[st.row]))
