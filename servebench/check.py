"""What decides `correct`: the tokens the timed path served, held to the
plain reference.

Once the window has closed and the program's state is freed, a sample of
the requests the run finished, drawn from the seed, is recomputed by the
configuration's reference (`servebench/reference/<name>.py`) from its
prompt and served tokens alone, in float32. At every served position the
number compared is the gap by which the served token's reference logit
lies below the reference's best there; the run's number is the widest
gap over the sample. The sample always holds the request with the most
served tokens and the one with the longest prompt, and a request of every
adapter rank the run finished. It is checked against the cell's limit in
`servebench/limits/<cell>.json`.

The control (`control=True`, never in a benchmark run) puts the
reference in float8 in the program's place on the same prompts and
tokens: at each position the token it puts first is read on the float32
reference in the same way.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
SAMPLE = 8               # requests a run's check recomputes


def load_limits(cell: str, root: Path = HERE) -> dict:
    path = root / "limits" / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no limits for {cell!r} at {path}")
    return json.loads(path.read_text())


def load_reference(name: str, root: Path = HERE):
    path = root / "reference" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"servebench_reference_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def choose(finished: Sequence, n: int, seed: int) -> List:
    """The sample: the request with the most served tokens, the one with
    the longest prompt, one of each rank not yet in, then the rest drawn
    from the seed, `n` in all (fewer if fewer finished)."""
    if not finished:
        return []
    rng = np.random.default_rng([int(seed), 2 ** 33])
    pool = sorted(finished, key=lambda r: r.rid)
    pick = [max(pool, key=lambda r: (r.max_new, -r.rid)),
            max(pool, key=lambda r: (r.prompt_len, -r.rid))]
    for rank in sorted({r.rank for r in pool}):
        if rank not in {r.rank for r in pick}:
            cands = [r for r in pool if r.rank == rank]
            pick.append(cands[int(rng.integers(len(cands)))])
    rest = [r for r in pool if r not in pick]
    order = rng.permutation(len(rest))
    pick += [rest[i] for i in order[:max(0, n - len(pick))]]
    seen, out = set(), []
    for r in pick:
        if r.rid not in seen:
            seen.add(r.rid)
            out.append(r)
    return out


def gaps(torch, spec, weights, adapters: Dict[str, dict], sample,
         control: bool = False, block: int = 4) -> Dict[str, object]:
    """Widest gap of the served tokens (and, with `control`, of the
    float8 reference's first choices) below the float32 reference's best,
    over the sample, in blocks of `block` sequences."""
    ref = load_reference(spec.reference)
    sizes = {"d_model": spec.d_model, "n_heads": spec.n_heads,
             "n_kv_heads": spec.n_kv_heads, "hd": spec.hd, "eps": spec.eps,
             "rope_theta": spec.rope_theta}
    dev = weights.embed.device
    served, ctrl, per = [], [], []
    for i in range(0, len(sample), block):
        part = sample[i:i + block]
        toks = [torch.as_tensor(
            np.concatenate([r.state.req.prompt,
                            np.asarray(r.state.generated[:-1], np.int32)]),
            dtype=torch.long, device=dev) for r in part]
        starts = [r.prompt_len - 1 for r in part]
        ads = [adapters[r.adapter] for r in part]
        ranks = [r.rank for r in part]
        picks = None
        if control:
            low = ref.forward(sizes, weights, ads, ranks, toks, starts,
                              quant="fp8")
            picks = [x.argmax(-1) for x in low]
            del low
        logits = ref.forward(sizes, weights, ads, ranks, toks, starts)
        for j, (r, lg) in enumerate(zip(part, logits)):
            out = torch.as_tensor(r.state.generated, dtype=torch.long,
                                  device=dev)
            best = lg.max(-1).values
            g = best - lg.gather(1, out[:, None])[:, 0]
            served.append(float(g.max()))
            per.append({"rid": r.rid, "rank": r.rank,
                        "prompt": r.prompt_len, "served": len(out),
                        "gap": float(g.max())})
            if picks is not None:
                gc = best - lg.gather(1, picks[j][:, None])[:, 0]
                ctrl.append(float(gc.max()))
                per[-1]["control_gap"] = float(gc.max())
        del logits
    out = {"max_logit_gap": max(served) if served else float("nan"),
           "served_tokens": sum(p["served"] for p in per),
           "requests": per}
    if control:
        out["control_max_logit_gap"] = max(ctrl) if ctrl else float("nan")
    return out
