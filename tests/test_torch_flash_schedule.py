"""The bf16 flash kernel's persistent walk, on the CPU: `flash.tile_order`
and `flash.work_walks` are the Python copies of the kernel's TileOrder and
its snake deal of work tiles (csrc/flash_attention.cu; the card holds
`tile_order` equal to `rt_flash_attention_order`). Every (query tile,
head, row) is taken exactly once, each (head, row)'s tiles come heaviest
first under causal masks and windows, no block carries more than a
tile's weight above the mean, the grid never passes the SM count it is
given, and a single tile is a grid of one. The weights are held to a
brute-force count of the KV tiles that hold a valid (query, key) pair."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash  # noqa: E402

# (B, H, Lq, Lk, hd, causal, window, sms)
WALKS = [
    (8, 32, 512, 512, 128, True, None, 132),      # training, 8 x 512
    (8, 32, 4096, 4096, 128, True, None, 132),    # yi-9b's long prompt
    (8, 32, 256, 256, 80, True, None, 132),       # K2 at width 96
    (4, 10, 256, 256, 256, True, 2048, 132),      # recurrentgemma's window
    (2, 10, 3000, 3000, 256, True, 2048, 132),    # window < L: rise, fall
    (2, 16, 1000, 1000, 64, False, 200, 132),     # a window alone: falls
    (1, 4, 777, 333, 128, True, 100, 7),          # Lq > Lk, few SMs
    (1, 4, 129, 1100, 128, True, 200, 7),         # Lq < Lk
    (1, 1, 1, 1, 32, True, None, 132),            # one tile
    (1, 1, 127, 127, 128, True, None, 132),
    (1, 1, 129, 129, 128, True, None, 132),       # two tiles, two blocks
    (3, 5, 640, 0, 128, True, None, 16),          # no key at all
]


def _brute_weights(Lq, Lk, causal, window, bk):
    """KV tiles holding a valid (query, key) pair of each query tile's BQ
    rows (rows past Lq included, as the kernel's tiles are whole)."""
    out = []
    for m in range(-(-Lq // flash.BQ)):
        q = np.arange(m * flash.BQ, (m + 1) * flash.BQ)[:, None]
        k = np.arange(Lk)[None]
        ok = np.ones((q.shape[0], Lk), bool)
        if causal:
            ok &= k <= q
        if window:
            ok &= q - k < window
        out.append(len({int(j) for j in np.nonzero(ok.any(0))[0] // bk}))
    return out


@pytest.mark.parametrize("B,H,Lq,Lk,hd,causal,window,sms", WALKS)
def test_every_work_tile_once_heaviest_first_and_balanced(B, H, Lq, Lk, hd,
                                                          causal, window,
                                                          sms):
    walks = flash.work_walks(B, H, Lq, Lk, hd, causal, window, sms)
    nq = -(-Lq // flash.BQ)
    taken = [t for walk in walks for t in walk]
    assert sorted(taken) == sorted(itertools.product(
        range(nq), range(H), range(B)))
    assert len(walks) == flash.persistent_grid(B, H, Lq, sms) <= sms
    assert all(walks)                       # no block without a tile
    w = flash.tile_weights(Lq, Lk, causal, window, flash.key_tile(hd))
    for walk in walks:
        # a block's tiles of one (head, row) come heaviest first
        for h, b in {(h, b) for _, h, b in walk}:
            mine = [w[m] for m, hh, bb in walk if (hh, bb) == (h, b)]
            assert mine == sorted(mine, reverse=True)
    # the snake pairs heavy ranks with light: no block carries more than
    # one tile's weight above the mean
    load = [sum(w[m] for m, _, _ in walk) for walk in walks]
    assert max(load) - sum(load) / len(load) <= max(w)
    # the tiles of a round run at once: they hold the query tiles of at
    # most ceil(grid / nq) + 1 (head, row)s, so they share keys in L2
    rounds = [walk[0] for walk in walks]
    assert len({(h, b) for _, h, b in rounds}) <= -(-len(walks) // nq) + 1


@pytest.mark.parametrize("Lq,Lk", [(1, 1), (300, 300), (1000, 333),
                                   (129, 1100), (4096, 4096), (640, 0)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 1),
                                           (True, 100), (True, 2048),
                                           (False, None), (False, 200)])
@pytest.mark.parametrize("bk", [128, 64])
def test_tile_weights_count_the_masks_and_the_order_never_rises(
        Lq, Lk, causal, window, bk):
    w = flash.tile_weights(Lq, Lk, causal, window, bk)
    assert w == _brute_weights(Lq, Lk, causal, window, bk)
    # the premise of the two cursors: weights rise, then fall
    peak = int(np.argmax(w))
    assert w[:peak + 1] == sorted(w[:peak + 1])
    assert w[peak:] == sorted(w[peak:], reverse=True)
    order = flash.tile_order(Lq, Lk, causal, window, bk)
    assert sorted(order) == list(range(len(w)))
    assert [w[m] for m in order] == sorted(w, reverse=True)


def test_causal_order_is_latest_tile_first_and_a_window_alone_earliest():
    """The two common cases in full: a causal prefill walks its query tiles
    from the last (most keys) down; a non-causal window from the first."""
    assert flash.tile_order(512, 512, True, None, 128) == [3, 2, 1, 0]
    assert flash.tile_order(1000, 1000, False, 200, 128) == list(range(8))
    w = flash.tile_weights(1000, 1000, False, 200, 128)
    assert w[0] == w[1] == 8 and w[-1] < w[0]
    # a causal window over a long prompt: the plateau from where it
    # begins, then the rise from its top
    w = flash.tile_weights(1000, 1000, True, 300, 128)
    assert w == [1, 2, 3, 4, 4, 4, 4, 4]
    assert flash.tile_order(1000, 1000, True, 300, 128)[:6] == \
        [3, 4, 5, 6, 7, 2]


def test_snake_deals_heavy_and_light_ranks_to_each_block():
    """8 x 512 (4 query tiles a head, 132 blocks): block i takes rank i % 4
    in even rounds and rank 3 - i % 4 in odd ones, so every block's tiles
    see 5 KV tiles a pair; a plain stride would give block 0 rank 0 (4 KV
    tiles) every round and block 3 rank 3 (1)."""
    walks = flash.work_walks(8, 32, 512, 512, 128, True, None, 132)
    w = flash.tile_weights(512, 512, True, None, 128)
    for walk in walks:
        pairs = [w[a[0]] + w[b[0]] for a, b in zip(walk[::2], walk[1::2])]
        assert set(pairs) == {5}


@pytest.mark.parametrize("B,H,Lq,sms,want", [
    (1, 1, 1, 132, 1), (1, 1, 128, 132, 1), (1, 1, 129, 132, 2),
    (8, 32, 512, 132, 132), (1, 4, 300, 132, 12), (2, 3, 5000, 1, 1)])
def test_persistent_grid_is_min_of_work_tiles_and_sms(B, H, Lq, sms, want):
    assert flash.persistent_grid(B, H, Lq, sms) == want


def test_key_tile_follows_the_padded_width():
    assert [flash.key_tile(hd) for hd in (32, 80, 100, 128, 129, 256)] == \
        [128, 128, 128, 128, 64, 64]


def test_length_refusal_past_the_order_table():
    """The bf16 walk's order table holds MAX_QUERY_TILES query tiles of a
    (head, row): longer prompts are refused by name, f32 takes any."""
    top = flash.MAX_QUERY_TILES * flash.BQ
    assert flash.length_refusal(top, torch.bfloat16) is None
    assert "Lq up to 1048576" in flash.length_refusal(top + 1, torch.bfloat16)
    assert flash.length_refusal(top + 1, torch.float32) is None
