"""Correctness tooling plane of the port: runtime sanitizers, a static
lint of the hot path, and the kernels' launch model and card checks.

* **Runtime** — `sanitizers` (env-gated, ``REPRO_SANITIZE=1``, the
  reference's switch): PageSan (page ownership and quarantine over
  `serving.cache.PageAllocator`, access checks on the page-id lists the
  backend builds) and LinkSan (happens-before on the cold-start link
  scheduler, `core.cold_start.LoadTracker`); and `retrace`, RetraceSan
  (a re-capture of the decode step's CUDA graphs, `core.graphs`, after
  steady state). Nothing when disabled: every hook is guarded on an
  attribute set at construction.
* **Static** — `callgraph` (a plain-`ast` view of the package and the
  functions the serving hot path reaches) and `lint` (host syncs on the
  hot path, bare asserts, kernel wrappers without a plain version, and
  the captured step's rules: graphs captured in one place, buffers
  written in place, no host branch on a tensor). CLI:
  ``python -m repro_torch.analysis.lint src/``.
* **Kernels** — `kernel_model` (each kernel's launch at every registered
  config, from the wrappers' own plan and shape-rule functions; runs on
  the CPU) and `kernel_verify` (footprint, canary and mutant checks of
  the CUDA kernels; runs only on the card, from chip_smoke.py).
"""
from repro_torch.analysis.sanitizers import (  # noqa: F401
    LinkSan,
    LinkSanError,
    PageSan,
    PageSanError,
    SanitizerError,
    enabled,
    force,
)
