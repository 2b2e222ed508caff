"""Family dispatch: one interface over dense / MoE / VLM, SSM, hybrid and
encoder-decoder models. Mirrors `repro.models.model`.

  prefill(cfg, params, batch, ...) -> (logits, row caches)
  prefill_chunk(cfg, params, ...)  -> logits of the final chunk, or None
  decode(cfg, params, cache, ...)  -> (logits, cache)
  loss(cfg, params, batch, ...)    -> (scalar, {"ce": ...})
  cache_abstract(cfg, batch, ...)  -> meta-device stand-ins of the cache
  abstract_params(cfg)             -> meta parameters + logical axes
  input_specs(cfg, shape)          -> meta stand-ins of a shape's inputs
  cache_logical_axes / batch_logical_axes -> their logical axes

The decoder-only families decode over the dense per-row cache (bf16/f32
or int8 KV) or the paged pool, with full or sliding-window attention;
the SSM and the hybrid over the dense rows of their recurrent state (and,
for the hybrid, local-attention KV); whisper over its per-layer self and
cross caches, through the model API only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import encdec, layers, rglru, ssm as ssm_mod, \
    transformer
from repro_torch.models.param import split


def supports_last_pos(cfg: ModelConfig) -> bool:
    """True when prefill() accepts `last_pos` (per-row pre-unembed
    gather)."""
    return cfg.family not in ("audio", "encdec")


def supports_write_mask(cfg: ModelConfig) -> bool:
    """True when decode() accepts `write_mask` (per-row cache-write
    drop)."""
    return cfg.family not in ("audio", "encdec")


def supports_paged(cfg: ModelConfig) -> bool:
    """True when decode() accepts the paged (block-table) cache layout: the
    uniform layered GQA KV cache without int8 quantization."""
    return (cfg.family not in ("audio", "encdec", "ssm")
            and not cfg.hybrid and cfg.kv_cache_dtype != "int8")


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """True when the serving backend may split this model's prefill into
    fixed-token chunks (backend.prefill_chunk): the paged layered GQA cache
    plus per-position-independent blocks (MoE capacity routing depends on
    how many tokens share the batch)."""
    return supports_paged(cfg) and not cfg.moe


def prefill_chunk(cfg, params, tokens_c, start, clen, cache, page_ids, *,
                  lora=None, last=False, window=None):
    """One chunk of an incremental prefill, written into the row's pages of
    the paged pool in place; see transformer.prefill_chunk."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"chunked prefill unsupported for {cfg.name}")
    return transformer.prefill_chunk(cfg, params, tokens_c, start, clen,
                                     cache, page_ids, lora=lora, last=last,
                                     window=window)


def prefill(cfg, params, batch, *, lora=None, cache_slots=None, window=None,
            last_only=False, last_pos=None):
    """batch: {tokens, [enc_embeds], [prefix_embeds]}. -> (logits, row
    caches). `window`: sliding-window causal attention (the flash kernel
    on the card), else full causal."""
    if cfg.family in ("audio", "encdec"):
        if last_pos is not None:
            raise ValueError("last_pos unsupported for encdec families")
        return encdec.prefill(cfg, params, batch["tokens"],
                              batch["enc_embeds"], lora=lora,
                              cache_slots=cache_slots, last_only=last_only)
    if cfg.family == "ssm":
        return _ssm_prefill(cfg, params, batch["tokens"], lora=lora,
                            need_cache=cache_slots is not None,
                            last_only=last_only, last_pos=last_pos)
    return transformer.prefill(
        cfg, params, batch["tokens"],
        prefix_embeds=batch.get("prefix_embeds"), lora=lora,
        cache_slots=cache_slots, window=window, last_only=last_only,
        last_pos=last_pos)


def _ssm_prefill(cfg, params, tokens, *, lora=None, need_cache=False,
                 last_only=False, last_pos=None):
    """The SSM stack's prefill; the cache stacks each layer's state on a
    leading layer axis: {"state": (L, B, H, P, N), "conv": (L, B, W - 1,
    conv_dim)}."""
    x = transformer.embed_tokens(cfg, params, tokens)
    live = transformer._lora_live(cfg, lora)

    def layer(x, i, p_l):
        ll, idx, ranks, mode = transformer._lora_slice(lora, i)
        return ssm_mod.ssm_block_apply(cfg, p_l, x, lora_layer=ll,
                                       lora_idx=idx, lora_ranks=ranks,
                                       lora_mode=mode, lora_live=live)

    caches = []
    for i, p_l in enumerate(params.blocks):
        x, c = transformer.remat_layer(cfg, layer, x, i, p_l)
        caches.append(c)
    if last_pos is not None:
        x = x[torch.arange(x.shape[0], device=x.device),
              last_pos.long()][:, None]
    elif last_only:
        x = x[:, -1:]
    cache = {n: torch.stack([c[n] for c in caches]) for n in caches[0]} \
        if need_cache else None
    return transformer.unembed(cfg, params, x), cache


def loss(cfg, params, batch, *, lora=None, aux_weight=0.01):
    """Next-token cross-entropy under `loss_mask` (+ aux_weight x the MoE
    load-balance loss summed over layers), as `repro.models.model.loss`:
    batch {tokens, [loss_mask], [prefix_embeds], [enc_embeds]}; the VLM's
    logits at its `n_prefix_tokens` patch positions are dropped. The
    log-sum-exp runs in f32 with the row max taken out (no gradient
    through it); the label's logit is gathered, which equals the
    reference's one-hot contraction. Returns (loss, {"ce": ce})."""
    if cfg.moe:
        logits, _, aux = transformer.prefill(
            cfg, params, batch["tokens"],
            prefix_embeds=batch.get("prefix_embeds"), lora=lora,
            return_aux=True)
    else:
        logits, _ = prefill(cfg, params, batch, lora=lora)
        aux = 0.0
    skip = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    ce = _cross_entropy(logits, batch["tokens"], batch.get("loss_mask"),
                        skip)
    return ce + aux_weight * aux, {"ce": ce}


def _cross_entropy(logits, tokens, mask, skip):
    """The masked mean of -log p(token t+1) over the logits after `skip`
    positions. Given DTensors, each rank takes its rows and its slice of
    the vocab, the vocab's max, exp-sum and label logit are combined
    across the ranks that hold the slices, and the masked sums across the
    rows' ranks."""
    if not shd.is_dtensor(logits):
        return _ce(logits, tokens, mask, skip)
    mesh = shd.current_mesh()

    def local(placed, logits, tokens, mask):
        cut, rows = placed.get("vocab"), placed.get("batch")
        vocab = None if not cut else (shd.group_of(mesh, cut),
                                      logits.shape[-1]
                                      * shd.coordinate(mesh, cut))
        return _ce(logits, tokens, mask, skip, vocab,
                   shd.group_of(mesh, rows) if rows else None)

    mask = torch.ones_like(tokens) if mask is None else mask
    return shd.local_call(local, (logits, tokens, mask),
                          (("batch", None, "vocab"), ("batch", None),
                           ("batch", None)), ())


def _ce(logits, tokens, mask, skip, vocab=None, rows=None):
    """`_cross_entropy` on one rank: `vocab` (group, offset of this
    rank's slice) when the vocab is cut, `rows` the group the rows are cut
    over. The log-sum-exp runs in f32 with the row max taken out (no
    gradient through it); the label's logit is gathered, which equals the
    reference's one-hot contraction."""
    lg = logits[:, skip:][:, :-1].float()
    targets = tokens[:, 1:].long()
    top = lg.amax(-1, keepdim=True).detach()
    if vocab is not None:
        top = shd.max_over(top, vocab[0])
    shifted = lg - top
    sums = torch.exp(shifted).sum(-1)
    if vocab is None:
        label = shifted.gather(-1, targets[..., None])[..., 0]
    else:
        n = lg.shape[-1]
        rel = targets - vocab[1]
        hit = (rel >= 0) & (rel < n)
        label = torch.where(hit, shifted.gather(
            -1, rel.clamp(0, n - 1)[..., None])[..., 0], 0.0)
        sums = shd.sum_over(sums, vocab[0])
        label = shd.sum_over(label, vocab[0])
    nll = torch.log(sums) - label
    mask = mask[:, 1:].float() if mask is not None else torch.ones_like(nll)
    num, den = (nll * mask).sum(), mask.sum()
    if rows is not None:
        num, den = shd.sum_over(num, rows), shd.sum_over(den, rows)
    return num / torch.clamp(den, min=1.0)


def decode(cfg, params, cache, tokens_t, pos, *, lora=None, window=None,
           write_mask=None, block_table=None):
    """block_table (B, W): the cache is the paged page-pool layout;
    write_mask (B,) bool: rows with False skip the cache write (recurrent
    state keeps its old rows); `window`: sliding-window attention, plain
    PyTorch on both planes (the paged kernel is full-attention only, as
    the reference's). The cache is updated in place and returned."""
    if cfg.family in ("audio", "encdec"):
        if write_mask is not None:
            raise ValueError("write_mask unsupported for encdec")
        if block_table is not None:
            raise ValueError("paged cache unsupported for encdec")
        return encdec.decode_step(cfg, params, cache, tokens_t, pos,
                                  lora=lora)
    if cfg.family == "ssm":
        if block_table is not None:
            raise ValueError("paged cache unsupported for ssm")
        return _ssm_decode(cfg, params, cache, tokens_t, pos, lora=lora,
                           write_mask=write_mask)
    return transformer.decode_step(cfg, params, cache, tokens_t, pos,
                                   lora=lora, window=window,
                                   write_mask=write_mask,
                                   block_table=block_table)


def _ssm_decode(cfg, params, cache, tokens_t, pos, *, lora=None,
                write_mask=None):
    x = transformer.embed_tokens(cfg, params, tokens_t)
    live = transformer._lora_live(cfg, lora)
    for i, p_l in enumerate(params.blocks):
        ll, idx, ranks, mode = transformer._lora_slice(lora, i)
        c_l = {n: shd.take_layer(t, i) for n, t in cache.items()}
        x, c = ssm_mod.ssm_block_step(cfg, p_l, x, c_l, lora_layer=ll,
                                      lora_idx=idx, lora_ranks=ranks,
                                      lora_mode=mode, lora_live=live)
        transformer.write_state(c_l, c, write_mask)
    return transformer.unembed(cfg, params, x), cache


def decode_cache_slots(cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """Cache depth for a decode shape: full-depth unless the sliding-window
    variant is in force (long contexts on windowed archs)."""
    if cfg.sliding_window and seq_len > 65536:
        return cfg.sliding_window
    return seq_len


def decode_window(cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """The decode window that goes with `decode_cache_slots`."""
    return cfg.sliding_window if (cfg.sliding_window and seq_len > 65536) \
        else None


def cache_abstract(cfg: ModelConfig, batch: int, seq_len: int):
    """Meta-device tensors matching the dense decode cache layout. The
    decoder-only families: k/v (L, batch, KV, slots, hd), pos (L, batch,
    slots) int32, and with int8 KV an int8 payload beside k_scale/v_scale
    (L, batch, KV, slots) f32. The SSM: state (L, batch, H, P, N), conv
    (L, batch, W - 1, conv_dim). The hybrid: a list, {h (batch, w), conv
    (batch, 3, w)} a recurrent layer, a window-deep kv cache (no layer
    axis) an attention layer. Enc-dec: a list of {self, cross} kv
    caches."""
    transformer._check_family(cfg)
    quant = cfg.kv_cache_dtype == "int8"

    def kv(slots, allow_quant=True, **kw):
        return layers.cache_init(batch, cfg.n_kv_heads, slots, cfg.hd,
                                 cfg.torch_dtype,
                                 quantized=quant and allow_quant,
                                 device="meta", **kw)

    if cfg.family == "ssm":
        return {n: t[None].expand(cfg.n_layers, *t.shape)
                for n, t in ssm_mod.ssm_cache_init(cfg, batch,
                                                   "meta").items()}
    if cfg.hybrid:
        return [rglru.rglru_cache_init(cfg, batch, "meta")
                if kind == "rglru"
                else kv(min(seq_len, cfg.hybrid.window))
                for kind in transformer.hybrid_layer_kinds(cfg)]
    if cfg.family in ("audio", "encdec"):
        return [{"self": kv(min(seq_len, cfg.max_ctx), allow_quant=False),
                 "cross": kv(cfg.enc_seq, allow_quant=False)}
                for _ in range(cfg.n_layers)]
    return kv(decode_cache_slots(cfg, seq_len), layers=cfg.n_layers)


# ------------------------------------------------- logical axes, dry run ----

def abstract_params(cfg: ModelConfig):
    """(meta-device value tree, logical axes tree) of the parameters
    without allocation, keyed as `models.weights.params_from_jax` keys
    the reference's tree. Two layouts differ from the reference's: a
    uniform stack's layers are a list, each leaf without the reference's
    leading "layers" axis; the rest is leaf for leaf (the MoE's EP-native
    layout under `cfg.moe_ep` included)."""
    from repro_torch.models.weights import init_tree
    transformer._check_family(cfg)
    return split(init_tree(cfg, 0, torch.device("meta")))


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta-device stand-ins for every model input of a dry-run shape:
    {"batch": {tokens (B, L) int32, [loss_mask], [enc_embeds],
    [prefix_embeds]}} for train / prefill, {"tokens_t" (B, 1), "pos" (B,),
    "cache"} for decode (one new token against a seq_len-deep cache)."""
    B, L = shape.global_batch, shape.seq_len

    def sd(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": sd((B, L))}
        if shape.kind == "train":
            batch["loss_mask"] = sd((B, L))
        if cfg.family in ("audio", "encdec"):
            batch["enc_embeds"] = sd((B, cfg.enc_seq, cfg.d_model),
                                     cfg.torch_dtype)
        if cfg.family == "vlm" and cfg.n_prefix_tokens:
            batch["prefix_embeds"] = sd((B, cfg.n_prefix_tokens,
                                         cfg.d_model), cfg.torch_dtype)
        return {"batch": batch}
    return {"tokens_t": sd((B, 1)), "pos": sd((B,)),
            "cache": cache_abstract(cfg, B, L)}


def cache_logical_axes(cfg: ModelConfig, cache_tree):
    """Logical axes of every cache leaf, by its name and rank."""
    def axes_of(name, nd):
        if name in layers.CACHE_AXES:              # a KV cache's leaves
            base = layers.CACHE_AXES[name]
            return ("layers",) * (nd - len(base)) + base
        if name == "state":
            return ("layers",) * (nd - 4) + ("batch", "heads", None, None)
        if name == "conv":
            return ("layers",) * (nd - 3) + ("batch", None, "mlp")
        if name == "h":
            return ("batch", "mlp")
        return ("batch",) + (None,) * (nd - 1)

    def walk(t, name=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, name) for v in t]
        return axes_of(name, t.dim())

    return walk(cache_tree)


def batch_logical_axes(batch_tree):
    """Batch inputs: dim 0 over ("pod", "data")."""
    if isinstance(batch_tree, dict):
        return {k: batch_logical_axes(v) for k, v in batch_tree.items()}
    return ("batch",) + (None,) * (batch_tree.dim() - 1)
