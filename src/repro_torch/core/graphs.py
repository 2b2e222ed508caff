"""CUDA graphs of the decode step: the port's counterpart of the
reference's jitted, donated `decode` and `megastep[K=k]` steps
(`repro.core.backend`: traced once a signature, then replayed with its
buffers donated).

`StepGraphs` keeps one entry a key (`"decode"`, `"megastep[K=2]"`, ...).
An entry's signature is the shape, dtype and address of every tensor the
step reads (the decode pipeline's buffers, the KV plane's leaves, the
LoRA pool's leaves and ranks): a graph replays raw device pointers, so
the step's buffers keep their storage and are written in place, as the
reference reuses its donated buffers. On the card a signature's first
call runs eagerly (the warm-up; its results are real), its second is
captured and then replayed once, and later calls replay. A call under
another signature (a buffer was rebound) drops the entry's graph and
starts over: a re-capture, which `analysis.retrace.RetraceSan` sees
through the entry's `_cache_size`. On the CPU nothing is captured: the
signatures are kept and observed alike and every call runs eagerly.

The graphs of one `StepGraphs` share one memory pool and replay in
series on the current stream. A graph's output is a tensor of that pool
which its next replay overwrites: the caller copies it out (queues the
copy on the stream) before the next replay. The Python code of the step
does not run on a replay, so each replay adds to the kernel wrappers'
launch counters what its capture counted (the capture itself launches
nothing). A capture or a replay that fails raises: nothing falls back to
eager.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

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
        self.capture_s: List[float] = []

    def _cache_size(self) -> int:
        return self.builds

    def _reset(self, sig: Tuple) -> None:
        self.sig, self.calls = sig, 0
        self.graph = self.out = None
        self.launches = ()
        self.builds += 1


class StepGraphs:
    """The decode step's graphs of one backend (see the module
    docstring). `capture=False`, or a device other than CUDA, runs every
    call eagerly."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.entries: Dict[str, GraphEntry] = {}
        self.pool = None            # torch.cuda.graph_pool_handle()
        self._stream = None         # the side stream captures run on

    def run(self, name: str, inputs: Sequence[torch.Tensor],
            step: Callable[[], torch.Tensor],
            generators: Sequence[torch.Generator] = ()) -> torch.Tensor:
        """Run `step` (a closure over `inputs`, returning one tensor)
        under key `name`: eagerly, or captured and replayed. `generators`
        are the step's random generators, registered with each graph so
        that every replay draws anew."""
        e = self.entries.get(name)
        if e is None:
            e = self.entries[name] = GraphEntry(name)
        sig = signature(inputs)
        if sig != e.sig:
            e._reset(sig)
        e.calls += 1
        if not self.capture or e.calls == 1:
            return step()
        if e.graph is None:
            self._capture(e, step, generators)
        e.graph.replay()
        e.replays += 1
        for fn, n in zip(COUNTERS, e.launches):
            fn.launches += n
        return e.out

    def _capture(self, e: GraphEntry, step, generators) -> None:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        g = torch.cuda.CUDAGraph()
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
        self._stream.wait_stream(main)
        # no garbage collection under the capture: collecting a dropped
        # backend destroys its graphs, which a capture forbids (it would
        # invalidate this one)
        gc_was = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                g.capture_begin(pool=self.pool)
                try:
                    out = step()
                except BaseException:
                    # the step's own error is the one to raise
                    with contextlib.suppress(Exception):
                        g.capture_end()
                    raise
                g.capture_end()
            main.wait_stream(self._stream)
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

    def stats(self) -> Dict[str, Dict[str, object]]:
        """Per key: signatures built, captures, replays, capture seconds
        and the launches of one replay."""
        return {n: {"builds": e.builds, "captures": e.captures,
                    "replays": e.replays, "capture_s": list(e.capture_s),
                    "launches_a_replay": dict(zip(
                        (fn.__name__ for fn in COUNTERS), e.launches))}
                for n, e in self.entries.items()}
