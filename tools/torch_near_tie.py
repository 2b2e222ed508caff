#!/usr/bin/env python
"""Where the port's server parts from the reference's on one parity case,
and by how much the reference's greedy choice won there.

Usage (on the CPU, JAX and PyTorch in one process):
    PYTHONHASHSEED=31 PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tools/torch_near_tie.py

Runs the case of
`tests/test_torch_dense_serving.py::test_dense_server_tokens_match_reference`
at llama2-7b, mbgmv, int8 KV through both packages' servers, with each
backend's `sample` wrapped to keep the logits it samples from. Adapter
weights seed from the process-salted `hash((uid, seed))`, so the hash
seed picks the adapters; the derived seeds are printed first. Then, for
the first sampling call whose greedy tokens differ: the row, the
reference's top-2 logits and their gap, the port's, and the largest
difference between the two rows' logits. A gap below that difference is
a near-tie: the two packages' summation orders (and, in int8, the KV
entries an f32 rounding boundary sends one quantization step apart) are
enough to flip it.
"""
from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(REPO, "src"), os.path.join(REPO, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.backend as jb  # noqa: E402
import repro_torch.core.backend as tb  # noqa: E402

_JLOG, _TLOG = [], []
_JSAMPLE, _TSAMPLE = jb.sample, tb.sample


def _jsample(logits, *a, **k):
    jax.debug.callback(lambda x: _JLOG.append(np.asarray(x, np.float64)),
                       logits, ordered=True)
    return _JSAMPLE(logits, *a, **k)


def _tsample(logits, *a, **k):
    _TLOG.append(logits.detach().double().numpy().copy())
    return _TSAMPLE(logits, *a, **k)


def main() -> int:
    jb.sample, tb.sample = _jsample, _tsample
    import test_torch_dense_serving as case
    js, ts = case._pair("mbgmv", arch="llama2-7b", kv="int8",
                        memory="dense", cache_slots=24)
    print("adapter seeds", {u: abs(hash((u, sp.seed))) % 2 ** 31
                            for u, sp in ts.store.specs.items()})
    case._run((js, ts), case._ring_trace())
    jt, tt = case._tokens(js), case._tokens(ts)
    for rid in sorted(jt):
        if jt[rid] != tt[rid]:
            i = next(i for i, (a, b) in enumerate(zip(jt[rid], tt[rid]))
                     if a != b)
            print(f"request {rid}: token {i} is {jt[rid][i]} in the "
                  f"reference, {tt[rid][i]} in the port")
    for n, (a, b) in enumerate(zip(_JLOG, _TLOG)):
        a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        bad = np.nonzero(a2.argmax(-1) != b2.argmax(-1))[0]
        if not bad.size:
            continue
        r = int(bad[0])
        sa, sb = np.sort(a2[r])[::-1], np.sort(b2[r])[::-1]
        print(f"sampling call {n}, row {r}: reference top-2 {sa[:2]} (gap "
              f"{sa[0] - sa[1]:.3e}), port top-2 {sb[:2]} (gap "
              f"{sb[0] - sb[1]:.3e}), max |logit| {np.abs(a2[r]).max():.3e}"
              f", max |reference - port| on the row "
              f"{np.abs(a2[r] - b2[r]).max():.3e}")
        return 0
    print(f"no sampling call differs ({len(_JLOG)} calls)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
