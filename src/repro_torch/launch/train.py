"""Training launcher: full fine-tuning or LoRA-adapter training on the
synthetic pipeline, with checkpointing. Mirrors `repro.launch.train`; runs
on the card unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --lora-rank 8 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \\
      --lora-rank 64 --seq 512            # full width, on the card

Each logged step prints its loss, gradient norm, learning rate, time
(CUDA events on the card, the host clock on the CPU) and tokens/s. On the
card each step runs as a CUDA graph (`core.graphs.StepGraphs`, key
`train`: the counterpart of the reference's jitted step); a `Trainer`
made with `graphs=False` runs it eagerly, the comparison arm.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.analysis import retrace, sanitizers
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.graphs import StepGraphs
from repro_torch.core.lora import pad_adapter, trim_adapter
from repro_torch.data.pipeline import DataConfig, packed_batches
from repro_torch.device import resolve_device, upload
from repro_torch.models.weights import (init_params, stack_layers,
                                        unstack_layers)
from repro_torch.training import checkpoint, optim, train as train_lib
from repro_torch.training import tree as tree_lib


class Trainer:
    """One training run: the model, what is trained (a LoRA adapter of
    `lora_rank` > 0, else every parameter), the optimizer state and the
    step. `params`: weights already on the device (else seeded ones).

    The trained leaves, the optimizer state, the step's metrics (0-d
    buffers) and the batch (static buffers, filled in place) keep their
    storage for the trainer's life: `step` writes them in place, so that
    on the card it runs as a CUDA graph under key `train` (its first call
    eagerly on the capture's side stream, its second captured, then
    replayed); `graphs=False` runs every step eagerly."""

    def __init__(self, cfg: ModelConfig, *, lora_rank: int = 0,
                 lr: float = 1e-3, steps: int = 100, seed: int = 0,
                 device=None, params=None, accum: int = 1,
                 graphs: bool = True):
        self.cfg, self.rank = cfg, lora_rank
        self.device = resolve_device(device)
        self.params = params if params is not None \
            else init_params(cfg, seed, self.device)
        self.opt_cfg = optim.AdamWConfig(lr=lr,
                                         warmup_steps=max(steps // 10, 1),
                                         total_steps=steps)
        if lora_rank > 0:
            g = torch.Generator(device=self.device).manual_seed(seed + 1)
            self.adapter = train_lib.init_lora_adapter(cfg, lora_rank, g)
            self.state = optim.init(self.adapter)
            self._step = train_lib.make_lora_train_step_(cfg, self.opt_cfg,
                                                         lora_rank)
        else:
            self.adapter = None
            self.state = optim.init(tree_lib.param_tree(self.params))
            self._step = train_lib.make_train_step_(cfg, self.opt_cfg,
                                                    accum=accum)
        self.metrics = {k: torch.zeros((), dtype=torch.float32,
                                       device=self.device)
                        for k in ("loss", "grad_norm", "lr")}
        self.batch: Dict[str, torch.Tensor] = {}
        self.graphs = StepGraphs(self.device, capture=graphs)
        # under the sanitizers (REPRO_SANITIZE=1) RetraceSan watches the
        # step's graph for a re-capture after steady state
        self.retrace_san = (retrace.RetraceSan()
                            if sanitizers.enabled() else None)

    def trained(self):
        """The tree being trained: the adapter, or the parameter tree."""
        return self.adapter if self.adapter is not None \
            else tree_lib.param_tree(self.params)

    def checkpoint_tree(self):
        """What a checkpoint holds: the trained tree and the optimizer
        state in the reference's layout, as it writes them: an adapter's
        (and its moments') rank axis trimmed to max_rank
        (`core.lora.trim_adapter`), a full fine-tune's uniform stack (and
        its moments) stacked on a leading layer axis
        (`models.weights.stack_layers`). `load_checkpoint` maps back."""
        return self._map_layout(trim_adapter, stack_layers,
                                {"model": self.trained(), "opt": self.state})

    def load_checkpoint(self, path: str):
        """(tree, manifest) of a checkpoint that either package wrote, in
        this trainer's layout: loaded (shapes checked) into
        `checkpoint_tree`'s structure, then an adapter's rank axis padded
        (`core.lora.pad_adapter`) or a uniform stack's layers listed
        (`models.weights.unstack_layers`). The trainer's own leaves take
        its values in place (a graphed step reads them by address)."""
        tree, manifest = checkpoint.load(path, self.checkpoint_tree())
        tree = self._map_layout(pad_adapter, unstack_layers, tree)
        with torch.no_grad():
            for dst, src in zip(tree_lib.leaves(
                    {"model": self.trained(), "opt": self.state}),
                    tree_lib.leaves(tree)):
                dst.copy_(src)
        return tree, manifest

    def _map_layout(self, on_adapter, on_params, tree):
        """`on_adapter(cfg, .)` (or, for a full fine-tune,
        `on_params(cfg, .)`) on the trained tree and its moments of a
        {"model", "opt"} tree."""
        fn = on_adapter if self.adapter is not None else on_params
        st = tree["opt"]
        return {"model": fn(self.cfg, tree["model"]),
                "opt": optim.AdamWState(st.step, fn(self.cfg, st.mu),
                                        fn(self.cfg, st.nu))}

    def step(self, batch) -> dict:
        """One training step on `batch` (host arrays, or tensors), copied
        into the trainer's static batch buffers. Returns the step's
        metrics, copies queued on the stream (no synchronization)."""
        self._stage_batch(batch)
        inputs = list(self.batch.values()) + tree_lib.leaves(
            {"model": self.trained(), "opt": self.state})
        self.graphs.run("train", inputs, self._captured_step)
        if self.retrace_san is not None:
            self.retrace_san.observe("train", self.graphs.entries["train"])
        return {k: v.clone() for k, v in self.metrics.items()}

    def _captured_step(self) -> torch.Tensor:
        """The step `StepGraphs` runs or captures: trained leaves, optimizer
        state and metrics written in place."""
        if self.adapter is not None:
            m = self._step(self.adapter, self.state, self.params,
                           self.batch)
        else:
            m = self._step(self.params, self.state, self.batch)
        for k, buf in self.metrics.items():
            buf.copy_(m[k])
        return self.metrics["loss"]

    def _stage_batch(self, batch) -> None:
        """Copy `batch` into the static buffers: host arrays through pinned
        staging, device tensors on the stream; a new shape or dtype takes
        new buffers (a new signature of the step)."""
        for k, v in batch.items():
            if not torch.is_tensor(v):
                v = torch.from_numpy(np.ascontiguousarray(v))
            buf = self.batch.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                # lint: allow-donated-reuse — a batch of a new shape or
                # dtype is a new signature of the step (re-captured), as
                # the reference's jitted step retraces on a new shape
                buf = self.batch[k] = torch.empty(
                    v.shape, dtype=v.dtype, device=self.device)
            if v.device == buf.device:
                buf.copy_(v)
            else:
                upload(v, self.device, out=buf)

    def batches(self, batch: int, seq: int, seed: int = 0
                ) -> Iterator[dict]:
        """`packed_batches` as tensors on the device, uploaded through
        pinned staging (the host does not wait)."""
        for b in packed_batches(DataConfig(vocab=self.cfg.vocab,
                                           seq_len=seq, batch=batch,
                                           seed=seed)):
            yield {k: upload(v, self.device) for k, v in b.items()}


def run(trainer: Trainer, data, steps: int, *, log_every: int = 10,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50) -> list:
    """`steps` steps on batches from `data`; returns one record a step
    (loss, grad_norm, lr, ms, tok_s). On the card a step's time is taken
    with CUDA events around it (the host queues ahead; logged steps
    synchronize to print), on the CPU with the host clock."""
    cuda = trainer.device.type == "cuda"
    marks, recs = [], []
    for step in range(1, steps + 1):
        batch = next(data)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        m = trainer.step(batch)
        if cuda:
            end.record()
            marks.append((start, end))
        else:
            marks.append(1e3 * (time.perf_counter() - t0))
        recs.append({"step": step, "tokens": batch["tokens"].numel(), **m})
        if step % log_every == 0 or step == 1:
            r = _record(recs[-1], marks[-1])
            print(f"step {step:5d} loss {r['loss']:.4f} "
                  f"gnorm {r['grad_norm']:.3f} lr {r['lr']:.2e} "
                  f"{r['ms']:.1f} ms/step {r['tok_s']:.0f} tok/s",
                  flush=True)
        if ckpt_dir and step % ckpt_every == 0:
            checkpoint.save(checkpoint.step_path(ckpt_dir, step),
                            trainer.checkpoint_tree(), step=step)
            checkpoint.retain(ckpt_dir, keep=3)
    return [_record(r, mk) for r, mk in zip(recs, marks)]


def _record(r, mark) -> dict:
    if isinstance(mark, tuple):
        mark[1].synchronize()
        mark = mark[0].elapsed_time(mark[1])
    return {"step": r["step"], "loss": float(r["loss"]),
            "grad_norm": float(r["grad_norm"]), "lr": float(r["lr"]),
            "ms": mark, "tok_s": 1e3 * r["tokens"] / mark}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lora-rank", type=int, default=0,
                    help=">0: train a LoRA adapter instead of full params")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    trainer = Trainer(cfg, lora_rank=args.lora_rank, lr=args.lr,
                      steps=args.steps, seed=args.seed, device=args.device)
    t0 = time.time()
    recs = run(trainer, trainer.batches(args.batch, args.seq, args.seed),
               args.steps, log_every=args.log_every, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every)
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s, final loss "
          f"{recs[-1]['loss']:.4f}")
    return recs


if __name__ == "__main__":
    main()
