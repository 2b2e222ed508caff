"""KV-cache memory plane for continuous batching. Mirrors
`repro.serving.cache`; every pool is updated in place. Two layouts:

* **Dense rows**: a fixed ``max_batch`` slab of ``cache_slots``-deep rows;
  a request owns one whole row, and its prefill cache is scattered into
  that row (``zeros_like_batched`` / ``scatter_rows`` / ``gather_row``).
  The slab has the tree of the family's row cache (`models.model.
  cache_abstract`): the layered dict of the decoder-only families (k/v
  ``(L, max_batch, KV, S, hd)``, pos ``(L, max_batch, S)``, with int8 KV
  the f32 scales ``(L, max_batch, KV, S)``) and the SSM's stacked state,
  batch on axis 1; the hybrid's per-layer list, batch on axis 0 (the
  reference's ``_batch_axis``).

* **Paged**: a fixed pool of ``(page_size, kv_heads, head_dim)`` pages
  shared by every request, plus a per-row *block table* mapping logical
  page ``j`` of a row to a physical page id (``-1`` = unclaimed).
  ``PageAllocator`` is the single id space both the KV block tables and
  the LoRA ``DevicePool`` draw from, and the engine's lazy growth /
  preemption arithmetic is the reference's. Pool layout (per leaf,
  layer-leading): k/v ``(L, n_pages + 1, KV, page_size, hd)``, pos
  ``(L, n_pages + 1, page_size)`` with -1 = empty. The extra last page is
  the write sink (see models/layers.py): where the reference drops an
  out-of-bounds scatter, the port writes there.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import sanitizers
from repro_torch.device import upload


# ------------------------------------------------------------ dense rows ----

def _batch_axis(cache) -> int:
    return 0 if isinstance(cache, list) else 1


def tree_leaves(cache):
    """(name, tensor) of every leaf of a cache tree: a dict, or a list of
    dicts (names repeat across layers)."""
    if isinstance(cache, list):
        return [leaf for c in cache for leaf in tree_leaves(c)]
    return list(cache.items())


def _slot_axis(name: str, ax: int):
    """The slot axis of a KV leaf (k/v/scales: after the KV-head axis,
    pos: right after the batch axis); None for recurrent state, which has
    no slots."""
    if name == "pos":
        return ax + 1
    if name in ("k", "v", "k_scale", "v_scale"):
        return ax + 2
    return None


def zeros_like_batched(row_cache_abstract, max_batch: int, device=None):
    """The dense slab from a batch-1 cache stand-in
    (`models.model.cache_abstract`): the batch axis widened to
    `max_batch`; int32 leaves (pos) filled with -1, the others with
    zeros."""
    ax = _batch_axis(row_cache_abstract)

    def mk(x):
        shape = list(x.shape)
        shape[ax] = max_batch
        fill = -1 if x.dtype == torch.int32 else 0
        return torch.full(shape, fill, dtype=x.dtype, device=device)

    if isinstance(row_cache_abstract, list):
        return [{n: mk(x) for n, x in c.items()} for c in row_cache_abstract]
    return {n: mk(x) for n, x in row_cache_abstract.items()}


def scatter_rows(pool_cache, row_caches, rows, sel=None):
    """Write request i's prefill cache (batch entry i of `row_caches`)
    into slab row rows[i], in place, replacing the whole row. A KV leaf's
    slots [0, Sp) come from the row cache and the slots past its depth
    Sp <= S are cleared (payload and scales 0, pos -1), as the
    reference's full-depth row write leaves them; a recurrent-state leaf
    is copied whole. Host-built `rows`: entries outside [0, max_batch)
    are dropped (the reference's out-of-bounds mode). With `sel`, `rows`
    and `sel` are index tensors of one length (a captured prefill's
    static buffers): entry j writes batch entry sel[j] into row rows[j],
    every row in range; a padded prefill repeats a real entry (its row
    and its batch entry), which writes the same values twice."""
    ax = _batch_axis(pool_cache)
    leaves = tree_leaves(pool_cache)
    dev = leaves[0][1].device
    if sel is None:
        max_batch = leaves[0][1].shape[ax]
        sel = [i for i, r in enumerate(rows) if 0 <= int(r) < max_batch]
        if not sel:
            return pool_cache
        rows = [int(rows[i]) for i in sel]
    dst_rows, src_rows = _device_index(rows, dev), _device_index(sel, dev)
    for (name, dst), (_, src) in zip(leaves, tree_leaves(row_caches)):
        src = src.index_select(ax, src_rows)
        lead = (slice(None),) * ax + (dst_rows,)
        sax = _slot_axis(name, ax)
        if sax is None:
            dst[lead] = src
            continue
        mid = (slice(None),) * (sax - ax - 1)
        sp = src.shape[sax]
        dst[lead + mid + (slice(0, sp),)] = src
        # a fill kernel, not an indexed write of a host scalar (a copy
        # from the host, which a CUDA graph capture refuses)
        dst.narrow(sax, sp, dst.shape[sax] - sp).index_fill_(
            ax, dst_rows, -1 if name == "pos" else 0)
    return pool_cache


def scatter_row(pool_cache, row_cache, row: int):
    """Insert a single-request cache (batch 1) at slab row `row`."""
    return scatter_rows(pool_cache, row_cache, [row])


def gather_row(pool_cache, row: int):
    """Slab row `row` as a batch-1 cache (views, no copy)."""
    ax = _batch_axis(pool_cache)
    if isinstance(pool_cache, list):
        return [{n: x.narrow(ax, row, 1) for n, x in c.items()}
                for c in pool_cache]
    return {n: x.narrow(ax, row, 1) for n, x in pool_cache.items()}


# ----------------------------------------------------------------- paged ----

def kv_page_nbytes(cfg, page_size: int) -> int:
    """Device bytes of one KV page: k+v payload for `page_size` token slots
    across every layer (the unit of the unified KV/LoRA page accounting)."""
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    return 2 * cfg.n_layers * cfg.n_kv_heads * page_size * cfg.hd * itemsize


class PageAllocator:
    """One fixed pool of device pages shared by KV block tables and LoRA
    adapter slots (S-LoRA's unified memory, PAPERS.md). Page ids live in a
    single space ``[0, n_pages)``: a page claimed for a row's KV can never
    simultaneously back an adapter, and vice versa. Claims are all-or-
    nothing; ``free`` rejects double-frees. ``owner_of`` exposes the tag a
    page was claimed under (``kv:<rid>`` / ``adapter:<uid>``) for tests and
    telemetry. ``on_free`` (optional callback, invoked after every free)
    lets the admission plane re-check deferred requests on each page-free
    event instead of only on its own admit attempts."""

    def __init__(self, n_pages: int):
        if n_pages <= 0:
            raise ValueError(f"n_pages must be positive, got {n_pages}")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._owner: Dict[int, str] = {}
        self.on_free = None
        # PageSan (REPRO_SANITIZE=1): shadow ownership + quarantine. Freed
        # pages sit in quarantine instead of the free list until capacity
        # pressure, so stale block-table references hit a dead page and are
        # reported as use-after-free. Capacity-neutral: `free_pages` counts
        # quarantined pages and `claim` recycles them on demand.
        self.san = (sanitizers.PageSan(n_pages)
                    if sanitizers.enabled() else None)

    @property
    def free_pages(self) -> int:
        n = len(self._free)
        if self.san is not None:
            n += len(self.san.quarantine)
        return n

    @property
    def used_pages(self) -> int:
        return self.n_pages - self.free_pages

    def claim(self, n: int, owner: str) -> Optional[List[int]]:
        """Claim `n` pages under `owner`, or None (and no change) if fewer
        than `n` are free."""
        if n < 0:
            raise ValueError(f"cannot claim a negative page count ({n})")
        if n > self.free_pages:
            return None
        if self.san is not None and n > len(self._free):
            # capacity pressure: recycle quarantined pages, oldest first
            self._free[:0] = self.san.take_quarantined(n - len(self._free))
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._owner[i] = owner
        if self.san is not None:
            self.san.on_claim(ids, owner)
        return ids

    def free(self, ids: Sequence[int]) -> None:
        if self.san is not None:
            self.san.pre_free(ids)
        for i in ids:
            if i not in self._owner:
                raise ValueError(f"page {i} freed but not claimed")
            del self._owner[i]
            if self.san is None:
                self._free.append(i)
        if self.san is not None:
            self.san.on_free(ids)   # -> quarantine, not the free list
        if ids and self.on_free is not None:
            self.on_free()

    def owner_of(self, page: int) -> Optional[str]:
        return self._owner.get(page)

    def owned_by(self, prefix: str) -> List[int]:
        return [p for p, o in self._owner.items() if o.startswith(prefix)]


def zeros_paged(row_cache_abstract, n_pages: int, page_size: int,
                device=None):
    """The physical page pool, from a batch-1 cache stand-in of the
    layered layout (`models.model.cache_abstract`): k/v (L, 1, KV, S, hd)
    -> (L, n_pages + 1, KV, page_size, hd); pos (L, 1, S) ->
    (L, n_pages + 1, page_size), -1 = empty slot."""
    out = {}
    for name, x in row_cache_abstract.items():
        if x.dim() == 5:
            L, _, kvh, _, hd = x.shape
            out[name] = torch.zeros((L, n_pages + 1, kvh, page_size, hd),
                                    dtype=x.dtype, device=device)
        elif x.dim() == 3:
            out[name] = torch.full((x.shape[0], n_pages + 1, page_size), -1,
                                   dtype=x.dtype, device=device)
        else:
            raise ValueError(
                f"unpageable cache leaf {name!r} of ndim {x.dim()} — the "
                "paged layout supports the uniform layered k/v/pos cache")
    return out


def _device_index(idx, device) -> torch.Tensor:
    """An index (rows, page ids) as an int64 tensor on `device`: a tensor
    already there as it is, a host-built one uploaded through pinned
    staging (`repro_torch.device.upload`), so the host never waits."""
    if torch.is_tensor(idx) and idx.device.type == device.type:
        return idx.long()
    return upload(np.asarray(idx, np.int64), device)


def _ids(pool_cache, page_ids) -> torch.Tensor:
    """Page ids (host-built, or an index tensor on the pool's device) as a
    device index; entries < 0 go to the sink page."""
    sink = pool_cache["pos"].shape[1] - 1
    ids = _device_index(page_ids, pool_cache["pos"].device)
    return torch.where(ids >= 0, ids, sink)


def scatter_pages(pool_cache, row_caches, page_ids):
    """Move every admitted request's prefill cache into its claimed pages
    with one indexed write per leaf, in place. `row_caches` carries batch
    Nb on axis 1 with a slot depth Sp that is a multiple of page_size;
    `page_ids` is (Nb, Sp // page_size) of destination pages — entries < 0
    (shorter requests, padding rows) land in the sink page."""
    ids = _ids(pool_cache, page_ids).reshape(-1)
    for name, dst in pool_cache.items():
        src = row_caches[name]
        if dst.dim() == 5:       # k / v: (L, P + 1, KV, ps, hd)
            ps = dst.shape[3]
            L, Nb, kvh, Sp, hd = src.shape
            s = src.reshape(L, Nb, kvh, Sp // ps, ps, hd)
            s = s.permute(0, 1, 3, 2, 4, 5).reshape(L, -1, kvh, ps, hd)
        else:                    # pos: (L, P + 1, ps)
            s = src.reshape(src.shape[0], -1, dst.shape[2])
        dst[:, ids] = s
    return pool_cache


# --------------------------------------------- lazy growth / preemption ----

def pages_for_tokens(tokens: int, page_size: int) -> int:
    """Pages needed to hold `tokens` KV slots."""
    return -(-max(int(tokens), 0) // page_size)


def boundary_steps(pos: int, n_claimed: int, page_size: int,
                   width: int) -> Optional[int]:
    """Decode steps a row can take before its ring write position crosses
    into an unclaimed logical page — the boundary-claim event that megastep
    planning must not fuse across. `pos` is the next write position,
    `n_claimed` the row's claimed-page count (claims are a logical prefix),
    `width` the block-table width. None = fully grown: the ring wraps onto
    already-claimed pages and no boundary event can occur. A result <= 0
    means the *current* write needs a page claimed first."""
    if n_claimed >= width:
        return None
    slot = int(pos) % (width * page_size)
    return n_claimed * page_size - slot


def clear_pages(pool_cache, page_ids):
    """Scrub reclaimed pages before reuse by invalidating their position
    slots (pos = -1), in place: stale positions of a previous tenant would
    become attendable once the new row's clock passes them. k/v payload
    can stay — it is masked by pos < 0."""
    pool_cache["pos"].index_fill_(1, _ids(pool_cache, page_ids), -1)
    return pool_cache


def extract_pages(pool_cache, page_ids):
    """Swap-out: device -> host copy of a row's claimed pages (k/v payload
    and pos), keyed by position in `page_ids`."""
    ids = _ids(pool_cache, page_ids)
    # lint: allow-host-sync — swap-out copies the victim's pages to host
    # memory: the preemption policy's designed device->host transfer
    return {name: x[:, ids].cpu() for name, x in pool_cache.items()}


def insert_pages(pool_cache, payload, page_ids):
    """Swap-in: write an `extract_pages` payload into freshly claimed pages
    (ids may differ from the originals), in place. Every slot of the
    destination pages is overwritten. On the card the payload goes up
    through pinned staging, so the host does not wait for the copy."""
    ids = _ids(pool_cache, page_ids)
    for name, dst in pool_cache.items():
        src = payload[name]
        if dst.is_cuda:
            src = src.pin_memory()
        dst[:, ids] = src.to(dst.device, dst.dtype, non_blocking=True)
    return pool_cache


def tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return int(tree.nbytes)


def gather_pages(pool_cache, page_ids):
    """Reconstruct one row's cache in the dense batch-1 layout from its
    block-table pages. `page_ids` is the row's (W,) logical->physical map;
    unclaimed (< 0) logical pages come back as empty (k/v zeros, pos -1)."""
    raw = _device_index(page_ids, pool_cache["pos"].device)
    safe, valid = raw.clamp(min=0), raw >= 0
    out = {}
    for name, x in pool_cache.items():
        g = x[:, safe]
        if x.dim() == 5:         # (L, W, KV, ps, hd)
            L, _, kvh, ps, hd = x.shape
            g = torch.where(valid[None, :, None, None, None], g, 0)
            out[name] = g.transpose(1, 2).reshape(L, 1, kvh, -1, hd)
        else:                    # (L, W, ps)
            g = torch.where(valid[None, :, None], g, -1)
            out[name] = g.reshape(x.shape[0], 1, -1)
    return out
