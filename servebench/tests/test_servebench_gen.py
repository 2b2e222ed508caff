"""The traffic generator: deterministic for a seed, the same sizes for
every seed (in another order), within the mix's ranges."""
import itertools
import json

import numpy as np
import pytest

from servebench import gen

from conftest import SB

MIXES = sorted(p.stem for p in (SB / "traffic").glob("*.json"))


def take(mix, seed, n, vocab=1000):
    return list(itertools.islice(gen.Traffic(mix, vocab, seed).stream(), n))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = gen.load_mix(name)
    a, b = take(mix, 2 ** 31 + 5, 70), take(mix, 2 ** 31 + 5, 70)
    for x, y in zip(a, b):
        assert (x.adapter, x.max_new) == (y.adapter, y.max_new)
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_sizes_in_another_order(name):
    mix = gen.load_mix(name)
    blk = mix["block"]
    a, b = take(mix, 1, 2 * blk), take(mix, 2 ** 33 + 7, 2 * blk)
    for part in (slice(0, blk), slice(blk, 2 * blk)):
        assert sorted(len(r.prompt) for r in a[part]) == \
            sorted(len(r.prompt) for r in b[part])
        assert sorted(r.max_new for r in a[part]) == \
            sorted(r.max_new for r in b[part])
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_ranges(name):
    mix = gen.load_mix(name)
    reqs = take(mix, 3, 256, vocab=500)
    p, o = mix["prompt"], mix["output"]
    assert all(p["min"] <= len(r.prompt) <= p["max"] for r in reqs)
    assert all(o["min"] <= r.max_new <= o["max"] for r in reqs)
    assert all(0 <= int(r.prompt.min()) and int(r.prompt.max()) < 500
               for r in reqs)
    s = mix["server"]
    assert all(len(r.prompt) + r.max_new <= s["cache_slots"] for r in reqs)
    longest = gen.Traffic(mix, 500, 3).longest_context()
    assert max(len(r.prompt) + r.max_new for r in reqs) <= longest \
        <= s["cache_slots"]


def test_lognormal_quantiles_and_clip():
    spec = {"dist": "lognormal", "median": 256, "sigma": 1.0, "min": 32,
            "max": 2048}
    x = gen.lengths(spec, 32)
    assert x[15] < 256 < x[16] or 256 in (x[15], x[16])
    assert x.min() == 32 and x.max() == 2048
    assert list(x) == sorted(x)


def test_zipf_popularity_of_the_picks():
    mix = gen.load_mix("chat-backlog")
    t = gen.Traffic(mix, 100, 11)
    reqs = take(mix, 11, 32 * 200, vocab=100)
    counts = {}
    for r in reqs:
        counts[r.adapter] = counts.get(r.adapter, 0) + 1
    hot = t.adapters[int(t.by_rank[0])].uid      # popularity rank 0
    share = counts[hot] / len(reqs)
    assert share == pytest.approx(t.p_sorted[0], rel=0.05)
    assert share == max(counts.values()) / len(reqs)
    # the hottest adapter depends on the seed, not on the rank order
    hots = {int(gen.Traffic(mix, 100, s).by_rank[0]) for s in range(6)}
    assert len(hots) > 1


def test_prefill_buckets_cover_the_lengths():
    mix = gen.load_mix("chat-backlog")
    b = gen.prefill_buckets(mix, 32, 512)
    lens = gen.lengths(mix["prompt"], mix["block"])
    assert {lp for _, lp in b} == {gen.bucket(int(n)) for n in lens}
    assert {nb for nb, _ in b} == {1, 2, 4, 8, 16, 32}
    assert all(gen.bucket(int(n)) < 2 * n or n <= 8 for n in lens)


def test_a_context_past_the_cache_is_refused():
    from servebench.cell import Cell
    mix = gen.load_mix("chat-backlog")
    mix["server"] = dict(mix["server"], cache_slots=256)
    wl = {"name": "yi-9b.chat-backlog", "config": "yi-9b"}
    with pytest.raises(ValueError, match="cache slots"):
        Cell(wl, 1, 1.0, device="cpu", mix=mix)
