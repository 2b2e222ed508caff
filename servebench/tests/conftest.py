"""The benchmark's own tests: `PYTHONPATH=src:. python -m pytest -q
servebench/tests` from the root of a checkout (the repo's `pytest` run
collects `tests/` only). Tests marked `cuda` need the card and skip here."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SB = ROOT / "servebench"


def tiny_config(name="yi-9b"):
    """A configuration file's dict cut to a CPU test's size."""
    c = json.loads((SB / "configs" / f"{name}.json").read_text())
    c.update(name=c["name"] + "-tiny", hidden_size=64, intermediate_size=128,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             num_hidden_layers=2, vocab_size=256, torch_dtype="float32")
    c["lora"] = dict(c["lora"], max_rank=8, rank_block=4)
    return c


def tiny_mix(name="chat-backlog"):
    m = copy.deepcopy(json.loads((SB / "traffic" / f"{name}.json")
                                 .read_text()))
    m["prompt"].update(median=16, min=4, max=64)
    m["output"].update(median=6, min=2, max=12)
    m["adapters"].update(ranks=[2, 4, 8], per_rank=2)
    m["block"] = 8
    m["server"].update(max_batch=4, cache_slots=128, page_size=8)
    m["trace_span_s"] = 0.5
    return m


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch
