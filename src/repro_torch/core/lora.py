"""LoRA adapters: specs, weight synthesis, the device slot pool, and the
batched delta. Mirrors `repro.core.lora`; the delta goes through
`kernels.ops.lora_delta`, so on the card it runs the BGMV / MBGMV CUDA
kernels and on the CPU their plain versions.

Semantics shared by all paths: the pool stores A/B padded with zeros beyond
each adapter's true rank, so the padding path (BGMV: compute r_max) and the
rank-block-skip path (MBGMV: compute ceil(rank/rank_block) blocks) produce
identical numerics — only their cost differs (max-rank law vs sum-rank law,
paper sec 2.3/ sec 5).

The port's rank axis is `padded_rank(max_rank)` wide, the next multiple of
8 (the kernels read 16-byte rows), where the reference's is max_rank: the
extra columns are zero like every column past an adapter's rank, so every
delta is the reference's. Trees crossing between the packages are padded
on the way in and trimmed on the way out (`pad_adapter`, `trim_adapter`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.device import upload
from repro_torch.kernels import ops
from repro_torch.kernels.bgmv import padded_rank
from repro_torch.models.param import Box, split


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    uid: str
    rank: int
    base_model: str
    seed: int = 0

    def nbytes(self, cfg: ModelConfig) -> int:
        """Host->device upload size of this adapter (bf16)."""
        total = 0
        for tgt in cfg.lora.targets:
            d_in, d_out = lora_target_dims(cfg, tgt)
            total += (d_in + d_out) * self.rank
        n_blocks = cfg.n_layers + cfg.n_enc_layers
        return total * n_blocks * 2


def lora_target_dims(cfg: ModelConfig, target: str) -> Tuple[int, int]:
    d = cfg.d_model
    if target == "q":
        return d, cfg.n_heads * cfg.hd
    if target in ("k", "v"):
        return d, cfg.n_kv_heads * cfg.hd
    if target == "in_proj":              # mamba2: full in-projection
        s = cfg.ssm
        d_in_total = 2 * s.expand * d + 2 * s.n_groups * s.state_dim \
            + (s.expand * d) // s.head_dim
        return d, d_in_total
    if target == "out_proj":
        return cfg.ssm.expand * d, d
    raise ValueError(target)


def make_adapter_weights(cfg: ModelConfig, spec: AdapterSpec,
                         dtype=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Synthesize adapter weights exactly as the reference does (same numpy
    stream, seeded from hash((uid, seed)) — Python salts string hashes per
    process, so the two packages agree only inside one process). Padded to
    the pool's padded rank with zeros. Returns {target: {a: (L, d_in,
    r_pad), b: (L, r_pad, d_out)}} as CPU tensors in `dtype` (the
    config's), r_pad = padded_rank(max_rank)."""
    dtype = dtype or cfg.torch_dtype
    r_max = cfg.lora.max_rank
    r_pad = padded_rank(r_max)
    L = cfg.n_layers + cfg.n_enc_layers
    rng = np.random.default_rng(abs(hash((spec.uid, spec.seed))) % (2 ** 31))
    r = min(spec.rank, r_max)      # pool is sized for max_rank
    out = {}
    for tgt in cfg.lora.targets:
        d_in, d_out = lora_target_dims(cfg, tgt)
        a = np.zeros((L, d_in, r_pad), np.float32)
        b = np.zeros((L, r_pad, d_out), np.float32)
        a[:, :, :r] = rng.normal(0, d_in ** -0.5, (L, d_in, r))
        b[:, :r, :] = rng.normal(0, r ** -0.5, (L, r, d_out))
        out[tgt] = {"a": torch.from_numpy(a).to(dtype),
                    "b": torch.from_numpy(b).to(dtype)}
    return out


# ------------------------------------------------------------- pool ----

def pool_abstract(cfg: ModelConfig, n_slots: Optional[int] = None):
    """The device pool's `Box` tree on the meta device (shapes and logical
    axes, no allocation): {target: {a: (L, slots, d_in, r_pad), b: (L,
    slots, r_pad, d_out)}, ranks: (slots,) int32}, r_pad =
    padded_rank(max_rank) where the reference's rank axis is max_rank."""
    r_max, slots = padded_rank(cfg.lora.max_rank), \
        n_slots or cfg.lora.n_slots
    L = cfg.n_layers + cfg.n_enc_layers

    def meta(shape, dtype=cfg.torch_dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    pool = {}
    for tgt in cfg.lora.targets:
        d_in, d_out = lora_target_dims(cfg, tgt)
        pool[tgt] = {
            "a": Box(meta((L, slots, d_in, r_max)),
                     ("layers", "slots", "lora_in", "lora_rank")),
            "b": Box(meta((L, slots, r_max, d_out)),
                     ("layers", "slots", "lora_rank", "qkv")),
        }
    pool["ranks"] = Box(meta((slots,), torch.int32), ("slots",))
    return pool


def pool_init(cfg: ModelConfig, n_slots: Optional[int] = None,
              device=None):
    """Zero device pool of `pool_abstract`'s shapes. Allocated once:
    uploads write into it."""
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    return zeros(split(pool_abstract(cfg, n_slots))[0])


def pool_insert(pool, cfg, weights, slot: int, rank: int):
    """Write adapter weights into device slot `slot`, in place (the
    reference rebuilds the pool functionally). Returns `pool`."""
    for tgt, ab in weights.items():
        pool[tgt]["a"][:, slot].copy_(ab["a"])
        pool[tgt]["b"][:, slot].copy_(ab["b"])
    # a fill kernel: an indexed write of a host int would copy it from the
    # host, which waits for the device
    pool["ranks"][slot].fill_(rank)
    return pool


def pad_adapter(cfg: ModelConfig, tree):
    """An adapter-shaped tree ({target: {a: (L, d_in, r), b: (L, r,
    d_out)}}, tensors) with r = max_rank, as the reference holds it ->
    the port's r_pad columns, the new ones zero (a max_rank that is a
    multiple of 8 needs none)."""
    r_pad = padded_rank(cfg.lora.max_rank)

    def pad(x, axis):
        extra = r_pad - x.shape[axis]
        if extra <= 0:
            return x
        shape = list(x.shape)
        shape[axis] = extra
        return torch.cat([x, x.new_zeros(shape)], axis)

    return {t: {"a": pad(ab["a"], -1), "b": pad(ab["b"], -2)}
            for t, ab in tree.items()}


def trim_adapter(cfg: ModelConfig, tree):
    """The inverse of `pad_adapter`: the reference's max_rank columns
    (views, no copies)."""
    r = cfg.lora.max_rank
    return {t: {"a": ab["a"][..., :r], "b": ab["b"][..., :r, :]}
            for t, ab in tree.items()}


def is_adapter_tree(cfg: ModelConfig, tree) -> bool:
    """True for a {target: {a, b}} tree over the config's LoRA targets (an
    adapter, or the optimizer moments of one)."""
    return isinstance(tree, dict) and bool(tree) \
        and set(tree) <= set(cfg.lora.targets) \
        and all(isinstance(v, dict) and set(v) == {"a", "b"}
                for v in tree.values())


# --------------------------------------------------------- batched delta ----

def lora_apply(x, lora_layer, target, lora_idx, ranks, mode="bgmv",
               rank_block=16, live=None):
    """Hook used inside model blocks. x: (B, T, d_in); lora_layer: per-layer
    slice of the pool ({target: {a, b}}); lora_idx (B,) int32; live: the
    step's precomputed (B,) `ops.lora_live`, or None. Returns the
    (B, T, d_out) delta, or None if this target has no adapter. The B*T
    rows go through one kernel launch with each row's slot repeated T
    times (prefill and decode share the kernels)."""
    if lora_layer is None or target not in lora_layer:
        return None
    ab = lora_layer[target]
    if shd.is_dtensor(x):
        return _lora_apply_dist(x, ab, lora_idx, ranks, mode, rank_block)
    B, T, d_in = x.shape
    if T > 1:
        lora_idx = lora_idx.repeat_interleave(T)
        live = None if live is None else live.repeat_interleave(T)
    delta = ops.lora_delta(x.reshape(B * T, d_in), ab["a"], ab["b"],
                           lora_idx, ranks=ranks, mode=mode,
                           rank_block=rank_block, live=live)
    return delta.reshape(B, T, -1)


def _lora_apply_dist(x, ab, lora_idx, ranks, mode, rank_block):
    """The kernels' custom ops on each rank's rows: A's d_in and B's d_out
    cut over "model" as the pool is (`lora_in`, `qkv`), x's columns cut
    with A's rows, the shrink's partial sums added across that cut."""
    mesh = shd.current_mesh()

    def local(placed, x, a, b, idx, ranks):
        B, T, d_in = x.shape
        idx = idx.repeat_interleave(T)
        live = ops.lora_live(idx, ranks, mode, a.shape[-1], rank_block)
        y = ops.lora_shrink_op(x.reshape(B * T, d_in), a, idx, live)
        if placed.get("lora_in"):
            y = shd.sum_over(y, shd.group_of(mesh, placed["lora_in"]))
        # f32 y goes to the expand, which rounds it to the pool's dtype as
        # it loads it (the decode and wgmma kernels: no cast launch; the
        # mma.sync f32 / tail tiles cast in the wrapper), as lora_delta
        y = y if b.dtype == x.dtype else y.to(x.dtype)
        return ops.lora_expand_op(y, b, idx, live).reshape(B, T, -1)

    return shd.local_call(
        local, (x, ab["a"], ab["b"], lora_idx, ranks),
        (("batch", None, "lora_in"), ("slots", "lora_in", "lora_rank"),
         ("slots", "lora_rank", "qkv"), ("batch",), ("slots",)),
        ("batch", None, "qkv"))


# --------------------------------------------------------- host store ----

class HostLoRAStore:
    """In-memory local LoRA repository (paper Fig 6): all adapters of a
    server live in host memory; device pool holds the hot subset."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs: Dict[str, AdapterSpec] = {}
        self._weights: Dict[str, dict] = {}
        # when each adapter joined this store (simulated ms); adapters
        # installed mid-run by the cluster's register-on-miss path have
        # registered_ms > 0
        self.registered_ms: Dict[str, float] = {}

    def register(self, spec: AdapterSpec, materialize=True,
                 now_ms: float = 0.0):
        self.specs[spec.uid] = spec
        self.registered_ms[spec.uid] = now_ms
        if materialize:
            self._weights[spec.uid] = make_adapter_weights(self.cfg, spec)

    def weights(self, uid: str):
        if uid not in self._weights:
            self._weights[uid] = make_adapter_weights(self.cfg, self.specs[uid])
        return self._weights[uid]

    def __contains__(self, uid):
        return uid in self.specs


class StagingCache:
    """Small LRU of per-adapter *device* copies of host LoRA weights — the
    CPU-assist prefill path's staging area.

    The batched prefill builds its pseudo-pool by stacking the admitted
    requests' host weights; without a cache every prefill of a hot adapter
    re-uploads the same arrays over the host link. Entries are keyed by
    ``(uid, registered_ms)`` so a re-registered adapter (the cluster's
    install/rebalance paths bump ``HostLoRAStore.registered_ms``) never
    serves a stale copy. Eviction is LRU with a small bound — the staging
    area is a prefill-window cache, not a second device pool.

    ``hits``/``misses``/``evictions`` are telemetry for the pipeline
    benchmark and tests; ``on_upload(nbytes)`` lets the owner count the
    host-link transfers the misses cost."""

    def __init__(self, slots: int = 16, on_upload=None,
                 device=torch.device("cpu")):
        if slots < 1:
            raise ValueError(f"need at least one adapter slot, got {slots}")
        self.slots = slots
        self._entries: "Dict[Tuple[str, float], dict]" = {}
        self._order: List[Tuple[str, float]] = []
        self._on_upload = on_upload
        self.device = device
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, uid: str, store: "HostLoRAStore"):
        """Device copy of `uid`'s weights ({target: {a, b}} tensors)."""
        key = (uid, store.registered_ms.get(uid, 0.0))
        ent = self._entries.get(key)
        if ent is not None:
            self.hits += 1
            self._order.remove(key)
            self._order.append(key)
            return ent
        self.misses += 1
        # a re-registered adapter supersedes its old generation: purge any
        # stale (uid, older_ms) entries so dead copies never hold LRU slots
        for stale in [k for k in self._order if k[0] == uid]:
            self._order.remove(stale)
            del self._entries[stale]
        w = store.weights(uid)
        # through pinned staging: the host does not wait for the copy
        ent = {t: {ab: upload(w[t][ab], self.device) for ab in ("a", "b")}
               for t in w}
        if self._on_upload is not None:
            self._on_upload(sum(int(w[t][ab].nbytes) for t in w
                                for ab in ("a", "b")))
        self._entries[key] = ent
        self._order.append(key)
        while len(self._order) > self.slots:
            old = self._order.pop(0)
            del self._entries[old]
            self.evictions += 1
        return ent

    def __len__(self):
        return len(self._entries)


class DevicePool:
    """Stateful wrapper around the functional slot pool with LRU eviction and
    in-flight slot reservation: a cold start *reserves* its slot when the
    upload begins (so concurrent admissions cannot double-claim it) and the
    slot becomes *ready* only when the LoadTracker retires the upload.
    Reserved-but-not-ready slots are never eviction victims.
    materialize=False keeps slot bookkeeping only (timing-only simulations).

    With `allocator` (the paged memory plane's `PageAllocator`) each
    resident adapter additionally holds ``ceil(nbytes / page_bytes)`` pages
    from the unified KV/LoRA pool: reserve claims them, evict/release frees
    them, and `shed_cold` lets a KV-hungry admission reclaim the pages of
    cold (ready, unpinned) residents LRU-first. Without an allocator the
    pool behaves exactly as before (a static reservation)."""

    def __init__(self, cfg: ModelConfig, n_slots: Optional[int] = None,
                 materialize: bool = True, allocator=None,
                 page_bytes: int = 0, device=None):
        self.cfg = cfg
        self.n_slots = n_slots or cfg.lora.n_slots
        self.materialize = materialize
        self.pool = pool_init(cfg, self.n_slots, device) if materialize \
            else None
        self.slot_uid: List[Optional[str]] = [None] * self.n_slots
        self.slot_ready: List[bool] = [True] * self.n_slots
        self.allocator = allocator
        self.page_bytes = page_bytes
        self.slot_pages: List[List[int]] = [[] for _ in range(self.n_slots)]
        self._clock = 0
        self._last_used = [0] * self.n_slots

    def pages_for(self, nbytes: int) -> int:
        """Unified-pool page cost of an adapter of `nbytes` (0 when the
        pool is not page-accounted)."""
        if self.allocator is None:
            return 0
        return max(1, -(-int(nbytes) // self.page_bytes))

    def lookup(self, uid: str) -> Optional[int]:
        for s, u in enumerate(self.slot_uid):
            if u == uid:
                self._touch(s)
                return s
        return None

    def is_ready(self, slot: int) -> bool:
        return self.slot_ready[slot]

    def inflight_slots(self) -> List[int]:
        return [s for s, u in enumerate(self.slot_uid)
                if u is not None and not self.slot_ready[s]]

    def _touch(self, slot):
        self._clock += 1
        self._last_used[slot] = self._clock

    def choose_victim(self, pinned: Sequence[int] = ()) -> Optional[int]:
        cands = [s for s in range(len(self.slot_uid))
                 if s not in pinned
                 and (self.slot_uid[s] is None or self.slot_ready[s])]
        if not cands:
            return None       # every slot pinned or mid-upload
        free = [s for s in cands if self.slot_uid[s] is None]
        if free:
            return free[0]
        return min(cands, key=lambda s: self._last_used[s])

    def reserve(self, uid: str, weights, rank: int,
                pinned: Sequence[int] = (),
                nbytes: int = 0) -> Optional[int]:
        """Claim a slot for an upload in flight. The device copy is written
        eagerly when materialized (numerics must be valid the moment the
        virtual-time upload lands); readiness gates the *timeline* and the
        eviction policy, not the arrays. Under the unified pool the
        adapter's pages are claimed here (shedding colder residents if the
        budget is short); on failure nothing is evicted — the chosen victim
        survives a reservation that cannot be honoured."""
        slot = self.choose_victim(pinned)
        if slot is None:
            return None
        if self.allocator is not None:
            need = self.pages_for(nbytes)
            pin = tuple(pinned) + (slot,)
            if (self.allocator.free_pages + len(self.slot_pages[slot])
                    + self.sheddable_pages(pin)) < need:
                return None          # doomed: evict nothing, victim stays
            while (self.allocator.free_pages
                   + len(self.slot_pages[slot])) < need:
                if not self.shed_cold(pinned=pin):
                    return None      # budget exhausted, victim untouched
            if self.slot_pages[slot]:
                self.allocator.free(self.slot_pages[slot])
            self.slot_pages[slot] = self.allocator.claim(
                need, f"adapter:{uid}")
        if self.materialize:     # in place: a captured step reads it
            pool_insert(self.pool, self.cfg, weights, slot, rank)
        self.slot_uid[slot] = uid
        self.slot_ready[slot] = False
        self._touch(slot)
        return slot

    def commit(self, slot: int):
        """Upload landed: the slot joins the ready set."""
        self.slot_ready[slot] = True
        self._touch(slot)

    def _free_pages_of(self, slot: int):
        if self.allocator is not None and self.slot_pages[slot]:
            self.allocator.free(self.slot_pages[slot])
            self.slot_pages[slot] = []

    def evict(self, slot: int):
        """Drop a resident adapter (prefetch victim selection / unified-
        pool reclaim); its pages return to the shared allocator."""
        if not self.slot_ready[slot]:
            raise RuntimeError("cannot evict a slot mid-upload")
        self.slot_uid[slot] = None
        self.slot_ready[slot] = True
        self._free_pages_of(slot)

    def release(self, slot: int):
        """Abandon an in-flight reservation (the link scheduler canceled a
        queued speculative upload): the slot returns to the free set. Any
        eagerly-written weights are simply overwritten by the next tenant."""
        if self.slot_ready[slot]:
            raise RuntimeError("release is for mid-upload slots")
        self.slot_uid[slot] = None
        self.slot_ready[slot] = True
        self._free_pages_of(slot)

    def _shed_candidates(self, pinned: Sequence[int] = ()) -> List[int]:
        return [s for s in range(self.n_slots)
                if s not in pinned and self.slot_uid[s] is not None
                and self.slot_ready[s]]

    def sheddable_pages(self, pinned: Sequence[int] = ()) -> int:
        """Pages reclaimable by evicting every cold (ready, unpinned)
        resident — callers check this *before* shedding, so a claim that
        can never succeed evicts nothing (doomed reclaims must not flush
        the warm set)."""
        return sum(len(self.slot_pages[s])
                   for s in self._shed_candidates(pinned))

    def shed_cold(self, pinned: Sequence[int] = ()) -> bool:
        """Evict the least-recently-used ready, unpinned resident — the
        unified pool's reclaim lever: a KV-hungry admission (or a hotter
        adapter) frees a cold speculative adapter's pages. Returns False
        when nothing evictable remains."""
        cands = self._shed_candidates(pinned)
        if not cands:
            return False
        self.evict(min(cands, key=lambda s: self._last_used[s]))
        return True

    def insert(self, uid: str, weights, rank: int,
               pinned: Sequence[int] = (),
               nbytes: int = 0) -> Optional[int]:
        """Synchronous reserve+commit (cached oracle / tests)."""
        slot = self.reserve(uid, weights, rank, pinned, nbytes=nbytes)
        if slot is not None:
            self.commit(slot)
        return slot
