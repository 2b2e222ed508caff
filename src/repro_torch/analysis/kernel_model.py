"""The launch each CUDA kernel of the port would make at every registered
config, and whether its wrapper takes the shape, computed on the CPU.

The reference's `repro.analysis.kernel_model` intercepts `pl.pallas_call`
and walks BlockSpecs; CUDA kernels have neither. Here a kernel's launch is
what its wrapper passes to the library: the wrapper's own plan functions
(`bgmv.shrink_plan`, `bgmv.expand_plan`, `paged.split_plan`,
`paged.launch_tiles`, `flash.padded_width`, `flash.persistent_grid`) and
shape
rules (`bgmv.shrink_refusal`, `bgmv.expand_refusal`,
`paged.shape_refusal`, `flash.shape_refusal`) are called, so there is no
second copy of the launch math to drift. The paged rule lives in C++
(`rt_paged_attention_fits`); `paged.fits` is its Python copy, held equal
to it over a grid of (G, hd) by `kernel_verify` on the card, as
`paged.group_tiles` is to `rt_paged_attention_tiles` and `paged.route`
(which kernel: the group kernel or the lane kernel) to
`rt_paged_attention_route`, and `flash.tile_order` (the bf16 flash
kernel's walk over query tiles) to `rt_flash_attention_order`.

`config_cases()` yields one `Case` per registered config at its real
widths (head dim, heads over KV heads, the LoRA targets' d_in / d_out
from d_model, the padded `max_rank`, `rank_block`); rows, batch and
pages stay small, as they change a launch's grid and not its per-block
footprint, except where they choose a path: each LoRA kernel is
modelled at two decode batches (8 rows and the decode paths' largest,
64) and at three row counts, so every path appears (the shrink's
decode blocks, its persistent wgmma kernel in bf16 at d_in a multiple of
8, in clusters of 1 to 8 d slices, and the cp.async row tiles of 64 and
128 rows otherwise; the expand's decode blocks and its row
tiles: the persistent wgmma kernel's tiles of 64 and 128 columns in
bf16 at d_out a multiple of 8, the mma.sync kernel otherwise). `launches(case)`
gives each kernel of the config's serving and training path as a
`Launch`: the C entry point's shape arguments, the path, and the
refusal (None: the wrapper takes it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, all_arch_ids, get_config
from repro_torch.core.lora import lora_target_dims
from repro_torch.kernels import bgmv, flash, paged

H100_SMS = 132                 # the card's SMs: the plans' `sms` off the card
DECODE_ROWS = (8, 64)          # decode batches: the decode paths (64:
                               # their largest shared memory)
PREFILL_ROWS = (512, 4096, 32768)   # a chunk, a training step's rows and a
                                    # prefill: row tiles of 64 split 8
                                    # ways, of 128 split 4 ways, of 128
FLASH_LEN = 512                # a prefill's length a row
PAGED_BATCH = 8
PAGE_SIZE = 32
CACHE_SLOTS = 512              # a row's block table: 16 pages of 32
CONFIGS = ("llama2-7b", "llama2-13b", "llama2-70b")   # beside ARCH_IDS


@dataclasses.dataclass(frozen=True)
class Case:
    """One registered config at its real widths."""
    config: str
    dtype: torch.dtype
    hd: int
    n_heads: int
    n_kv_heads: int
    max_rank: int
    r_pad: int                      # the pool's rank columns
    rank_block: int
    n_slots: int
    lora: Tuple[Tuple[str, int, int], ...]   # (target, d_in, d_out)
    attention: bool                 # prefill attention (flash) on the path
    paged: bool                     # paged decode attention on the path

    @property
    def group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch the wrapper would make: `kernel` (the wrapper's
    name), `path` (which of its launch shapes), `dtype`, `args` (the C
    entry point's shape arguments, by name) and `refusal` (None: the
    wrapper takes the shape; else its message) with the `rule` that
    gave it."""
    case: str
    kernel: str
    path: str
    dtype: torch.dtype
    args: Dict[str, int]
    refusal: Optional[str]
    rule: str

    @property
    def label(self) -> str:
        return f"{self.case} {self.kernel}[{self.path}]"


def case_from_config(cfg: ModelConfig) -> Case:
    from repro_torch.models.model import supports_paged
    from repro_torch.models.transformer import hybrid_layer_kinds
    attention = cfg.family != "ssm" and (
        not cfg.hybrid or "attn" in hybrid_layer_kinds(cfg))
    return Case(
        config=cfg.name, dtype=cfg.torch_dtype, hd=cfg.hd,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        max_rank=cfg.lora.max_rank,
        r_pad=bgmv.padded_rank(cfg.lora.max_rank),
        rank_block=cfg.lora.rank_block, n_slots=cfg.lora.n_slots,
        lora=tuple((t, *lora_target_dims(cfg, t)) for t in cfg.lora.targets),
        attention=attention, paged=supports_paged(cfg))


def config_cases() -> Iterator[Case]:
    """One Case per registered config (real widths)."""
    for name in list(CONFIGS) + all_arch_ids():
        yield case_from_config(get_config(name))


def shape_cases() -> Iterator[Case]:
    """llama2-7b at shapes the reference's kernels take and no registered
    config reaches: an MQA group of 32 at hd 128 (`n_kv_heads=1`: paged
    attention on the group kernel in bf16, in group tiles of the lane
    kernel in f32), hd 80 (`head_dim=80`, flash at a padded width) and
    LoRA targets of 4,100 -> 1,000 and 1,000 -> 4,100 (the shrink's and
    the expand's tails)."""
    base = get_config("llama2-7b")
    for label, kw in (("n_kv_heads=1", dict(n_kv_heads=1)),
                      ("n_kv_heads=1 f32", dict(n_kv_heads=1,
                                                dtype="float32")),
                      ("head_dim=80", dict(head_dim=80))):
        case = case_from_config(dataclasses.replace(base, **kw))
        yield dataclasses.replace(case, config=f"{base.name} {label}")
    yield dataclasses.replace(case_from_config(base),
                              config=f"{base.name} LoRA 4100 <-> 1000",
                              lora=(("q", 4100, 1000), ("o", 1000, 4100)))


def _lora_launches(case: Case, sms: int,
                   room: Mapping[int, int]) -> Iterator[Launch]:
    seen = set()
    for _, d_in, d_out in case.lora:
        for rows in (*DECODE_ROWS, *PREFILL_ROWS):
            key = (d_in, d_out, rows)
            if key in seen:
                continue
            seen.add(key)
            sp = bgmv.shrink_plan(rows, d_in, case.n_slots, sms, case.r_pad,
                                  case.dtype, room)
            yield Launch(
                case.config, "lora_shrink",
                ("decode" if sp.tile == 0 else
                 f"persistent x{sp.split}" if sp.per_tile == 0 else
                 f"tile {sp.tile}")
                + ("" if d_in % 8 == 0 else " tail"), case.dtype,
                dict(rows=rows, d_in=d_in, r_max=case.r_pad,
                     slots=case.n_slots, tile=sp.tile, d_chunk=sp.d_chunk,
                     split=sp.split, grid=sp.grid,
                     per_tile=sp.per_tile),
                bgmv.shrink_refusal(d_in, case.r_pad), "bgmv.shrink_refusal")
            ep = bgmv.expand_plan(rows, d_out, sms, case.dtype)
            # the decode and wgmma kernels take the shrink's f32 y
            # (ops.lora_delta); the mma.sync row tiles y in B's dtype
            y_dtype = torch.float32 if ep.grid == 0 or ep.cols \
                else case.dtype
            yield Launch(
                case.config, "lora_expand",
                ("decode" if ep.grid == 0 else "row tiles")
                + ("" if d_out % 8 == 0 else " tail"), case.dtype,
                dict(rows=rows, r_max=case.r_pad, d_out=d_out,
                     blocks=ep.grid, cols=ep.cols, y_dtype=y_dtype),
                bgmv.expand_refusal(case.r_pad, d_out),
                "bgmv.expand_refusal")


def launches(case: Case, sms: int = H100_SMS,
             room: Mapping[int, int] = bgmv.H100_CLUSTER_ROOM
             ) -> List[Launch]:
    """Every kernel launch on `case`'s path (see the module docstring);
    `room`: the clusters of each split the card holds at once
    (`bgmv.cluster_room`)."""
    out = list(_lora_launches(case, sms, room))
    if case.attention:
        width = ("" if flash.shape_refusal(case.hd, case.dtype)
                 or flash.padded_width(case.hd, case.dtype) == case.hd
                 else f" at {flash.padded_width(case.hd, case.dtype)}")
        out.append(Launch(
            case.config, "flash_attention",
            ("bf16 wgmma" if case.dtype == torch.bfloat16 else "f32")
            + f" hd {case.hd}{width}",
            case.dtype, dict(B=1, H=case.n_heads, Lq=FLASH_LEN, Lk=FLASH_LEN,
                             hd=case.hd, causal=1, window=0),
            flash.shape_refusal(case.hd, case.dtype), "flash.shape_refusal"))
    if case.paged:
        W = CACHE_SLOTS // PAGE_SIZE
        group = paged.route(case.group, case.hd, case.dtype) == 1
        tiles = paged.launch_tiles(case.group, case.hd, case.dtype)
        nsplit = paged.split_plan(PAGED_BATCH, case.n_kv_heads, W, sms,
                                  tiles)
        out.append(Launch(
            case.config, "paged_attention",
            ("one split" if nsplit == 1 else f"{nsplit} splits + combine")
            + f" G {case.group} hd {case.hd}"
            + (" on the group kernel" if group else
               "" if tiles == 1 else f" in {tiles} group tiles"),
            case.dtype, dict(B=PAGED_BATCH, H=case.n_heads,
                             KV=case.n_kv_heads, ps=PAGE_SIZE, hd=case.hd,
                             W=W, nsplit=nsplit),
            paged.shape_refusal(case.group, case.hd), "paged.shape_refusal"))
    return out
