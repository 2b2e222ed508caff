"""CUDA graphs of the port's steps: the counterpart of the reference's
jitted, donated steps (`repro.core.backend`: `decode`, `megastep[K=k]`,
one packed prefill a (Nb, Lp) bucket, the chunk step a (C, final); and
`repro.launch.train`'s jitted training steps), each traced once a
signature and then replayed with its buffers donated.

`StepGraphs` keeps one entry a key (`"decode"`, `"megastep[K=2]"`,
`"prefill[Nb=2,Lp=64]"`, `"prefill_chunk[C=512]"`,
`"prefill_chunk_final[C=512]"`, `"train"`, ...). An entry's signature is
the shape, dtype and address of every tensor the step reads (the step
state, the KV plane's leaves, the LoRA pools' leaves, a bucket's static
inputs, a trainer's parameters, moments and batch): a graph replays raw
device pointers, so the step's buffers keep their storage and are
written in place, as the reference reuses its donated buffers. On the
card a signature's first call runs eagerly (the warm-up; its results are
real) on the side stream the capture uses (PyTorch's rule for capturing
a backward pass), its second is captured and then replayed once, and
later calls replay. A call under another signature (a buffer was
rebound) drops the entry's graph and starts over: a re-capture, which
`analysis.retrace.RetraceSan` sees through the entry's `_cache_size`. A
call made with `graph=False` runs eagerly by the caller's stated policy
(the prefill buckets past the backend's cap) and is counted as such. On
the CPU nothing is captured: the signatures are kept and observed alike
and every call runs eagerly.

The graphs of one `StepGraphs` share one memory pool and replay in
series on the current stream. A graph's output is a tensor of that pool
which its next replay overwrites, and which another key's replay may
overwrite too: the caller copies it out (queues the copy on the stream)
before the next replay. The Python code of the step does not run on a
replay, so each replay adds to the kernel wrappers' launch counters what
its capture counted (the capture itself launches nothing). A capture or
a replay that fails raises: nothing falls back to eager.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import upload
from repro_torch.kernels import bgmv, flash, paged

# the kernel wrappers whose `.launches` count launches on the card
COUNTERS = (bgmv.lora_shrink, bgmv.lora_expand, paged.paged_attention,
            flash.flash_attention)


def leaves(tree) -> List[torch.Tensor]:
    """Every tensor of a nested dict / list / tuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for v in tree for t in leaves(v)]


def signature(tensors: Iterable[torch.Tensor]) -> Tuple:
    """What a graph of a step over `tensors` depends on: each one's
    address, shape and dtype."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


class StaticInputs:
    """The host-built inputs of a captured step (a prefill bucket's
    tokens, lengths, rows and page ids; a chunk's positions; a training
    batch) as named int32 views of one device buffer, `flat`, allocated
    here once and never rebound: a graph reads the views by address.
    The caller writes the host mirror (`host[name]`, numpy views of one
    array) and `upload`s it: one pinned, non-blocking copy a call."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]],
                 device: torch.device):
        sizes = [math.prod(s) for s in shapes.values()]
        self.flat = torch.zeros(sum(sizes), dtype=torch.int32,
                                device=device)
        self._host = np.zeros(sum(sizes), np.int32)
        self.views: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, np.ndarray] = {}
        off = 0
        for (name, shape), n in zip(shapes.items(), sizes):
            self.views[name] = self.flat[off:off + n].view(shape)
            self.host[name] = self._host[off:off + n].reshape(shape)
            off += n

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.views[name]

    def upload(self) -> int:
        """Copy the host mirror into `flat` in place; returns its bytes."""
        upload(self._host, self.flat.device, out=self.flat)
        return self._host.nbytes


class GraphEntry:
    """One key's current signature and graph.

    `builds` counts the signatures the key was (re)built for: its jitted
    counterpart's trace-cache size. `launches` holds, per counter of
    `COUNTERS`, what one replay launches."""

    def __init__(self, name: str):
        self.name = name
        self.sig: Optional[Tuple] = None
        self.builds = 0
        self.calls = 0              # calls under the current signature
        self.graph = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Tuple[int, ...] = ()
        self.captures = 0
        self.replays = 0
        self.eager = 0              # calls run eagerly by the caller's cap
        self.capture_s: List[float] = []
        self.pool_bytes: List[Optional[int]] = []

    def _cache_size(self) -> int:
        return self.builds

    def _reset(self, sig: Tuple) -> None:
        self.sig, self.calls = sig, 0
        self.graph = self.out = None
        self.launches = ()
        self.builds += 1


class StepGraphs:
    """The step graphs of one backend or one trainer (see the module
    docstring). `capture=False`, or a device other than CUDA, runs every
    call eagerly. `keep_graphs` (set before a key's capture) keeps each
    captured graph's cudaGraph_t (`CUDAGraph(keep_graph=True)`,
    instantiated at once), so a tool can read its nodes and edges through
    `entries[key].graph.raw_cuda_graph()`."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.keep_graphs = False
        self.entries: Dict[str, GraphEntry] = {}
        self.pool = None            # torch.cuda.graph_pool_handle()
        self._stream = None         # the side stream captures run on

    def run(self, name: str, inputs: Sequence[torch.Tensor],
            step: Callable[[], torch.Tensor],
            generators: Sequence[torch.Generator] = (),
            graph: bool = True) -> torch.Tensor:
        """Run `step` (a closure over `inputs`, returning one tensor)
        under key `name`: eagerly, or captured and replayed. `generators`
        are the step's random generators, registered with each graph so
        that every replay draws anew. `graph=False`: the caller's policy
        keeps this call eager; it is counted in the key's `eager`."""
        e = self.entries.get(name)
        if e is None:
            e = self.entries[name] = GraphEntry(name)
        if not graph:
            e.eager += 1
            return step()
        sig = signature(inputs)
        if sig != e.sig:
            e._reset(sig)
        e.calls += 1
        if not self.capture:
            return step()
        if e.calls == 1:
            return self._warm(step)
        if e.graph is None:
            self._capture(e, step, generators)
        e.graph.replay()
        e.replays += 1
        for fn, n in zip(COUNTERS, e.launches):
            fn.launches += n
        return e.out

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _warm(self, step):
        """A key's eager first call, on the side stream its capture will
        use; the current stream then waits for it, and its output is
        marked as used there."""
        side, main = self._side_stream(), \
            torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = step()
        main.wait_stream(side)
        for t in leaves(out):
            t.record_stream(main)
        return out

    def _capture(self, e: GraphEntry, step, generators) -> None:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        side = self._side_stream()
        g = torch.cuda.CUDAGraph(keep_graph=self.keep_graphs)
        for gen in generators:
            if not hasattr(g, "register_generator_state"):
                raise RuntimeError(
                    "this PyTorch's CUDAGraph has no "
                    "register_generator_state: a graph of a sampling step "
                    "would replay one draw")
            g.register_generator_state(gen)
        before = [fn.launches for fn in COUNTERS]
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        # a capture must not run on the default stream; it records
        # without executing, so no synchronization is needed around it
        side.wait_stream(main)
        # no garbage collection under the capture: collecting a dropped
        # backend destroys its graphs, which a capture forbids (it would
        # invalidate this one)
        gc_was = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                g.capture_begin(pool=self.pool)
                try:
                    out = step()
                except BaseException:
                    # the step's own error is the one to raise
                    with contextlib.suppress(Exception):
                        g.capture_end()
                    raise
                g.capture_end()
                if self.keep_graphs:
                    g.instantiate()
            main.wait_stream(side)
            e.launches = tuple(fn.launches - b
                               for fn, b in zip(COUNTERS, before))
        finally:
            if gc_was:
                gc.enable()
            for fn, b in zip(COUNTERS, before):
                fn.launches = b         # the capture launched nothing
        e.graph, e.out = g, out
        e.captures += 1
        e.capture_s.append(time.perf_counter() - t0)
        e.pool_bytes.append(self.pool_bytes())

    def pool_bytes(self) -> Optional[int]:
        """Bytes of the allocator's segments in this object's graph pool,
        where PyTorch's memory snapshot exposes a segment's pool (else
        None)."""
        if self.pool is None:
            return 0
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" not in segs[0]:
            return None
        return sum(seg["total_size"] for seg in segs
                   if tuple(seg.get("segment_pool_id", ())) ==
                   tuple(self.pool))

    def stats(self) -> Dict[str, Dict[str, object]]:
        """Per key: signatures built, captures, replays, calls run eagerly
        by the caller's cap, capture seconds, the pool's bytes after each
        capture and the launches of one replay."""
        return {n: {"builds": e.builds, "captures": e.captures,
                    "replays": e.replays, "eager": e.eager,
                    "capture_s": list(e.capture_s),
                    "pool_bytes": list(e.pool_bytes),
                    "launches_a_replay": dict(zip(
                        (fn.__name__ for fn in COUNTERS), e.launches))}
                for n, e in self.entries.items()}
