"""The port's temperature sampler (repro_torch.serving.sampling) against
the reference's `jax.random.categorical` by distribution, never token for
token (the two random streams differ), and the server's sampling
invariants: a K-step megastep draws exactly what K single steps draw, one
seed repeats, another differs, and temperature <= 0 is argmax."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
stats = pytest.importorskip("scipy.stats")

from repro.serving.sampling import sample as jsample  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.engine import InferenceServer  # noqa: E402
from repro_torch.core.lora import AdapterSpec  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.sampling import sample  # noqa: E402

DRAWS = 20_000
P_MIN = 1e-3
LOGITS = np.random.default_rng(0).normal(size=16).astype(np.float32) * 2.0


def _softmax(x):
    x = np.asarray(x, np.float64)
    e = np.exp(x - x.max())
    return e / e.sum()


@pytest.mark.parametrize("temperature", [0.7, 1.5])
@pytest.mark.parametrize("side", ["port", "reference"])
def test_sampler_matches_softmax_distribution(side, temperature):
    """20,000 draws over a fixed 16-way logits vector pass a chi-square
    test against softmax(logits / T) at p > 1e-3 (fixed seeds)."""
    if side == "port":
        gen = torch.Generator().manual_seed(1)
        rows = torch.from_numpy(np.tile(LOGITS, (DRAWS, 1)))
        toks = sample(rows, temperature=temperature, generator=gen).numpy()
    else:
        rows = jax.numpy.asarray(np.tile(LOGITS, (DRAWS, 1)))
        toks = np.asarray(jsample(rows, temperature=temperature,
                                  rng=jax.random.PRNGKey(1)))
    assert toks.dtype == np.int32
    counts = np.bincount(toks, minlength=16)
    want = _softmax(LOGITS / temperature) * DRAWS
    p = stats.chisquare(counts, want).pvalue
    assert p > P_MIN, (side, temperature, p)


@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_nonpositive_temperature_is_argmax(temperature):
    logits = torch.from_numpy(
        np.random.default_rng(3).normal(size=(5, 40)).astype(np.float32))
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0   # a tie: first
    got = sample(logits, temperature=temperature)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.argmax(logits, -1).to(torch.int32))
    assert int(got[2]) == 7


def test_temperature_needs_a_generator():
    with pytest.raises(ValueError):
        sample(torch.zeros(2, 4), temperature=0.5)


def _serve(seed=0, megastep=4, temperature=0.8, **kw):
    cfg = get_config("llama2-7b").smoke()
    srv = InferenceServer(cfg, mode="cached", max_batch=4, cache_slots=64,
                          seed=seed, device="cpu", megastep=megastep,
                          temperature=temperature, **kw)
    rng = np.random.default_rng(11)
    reqs = []
    for i, n in enumerate((9, 5, 7, 12)):
        srv.register_adapter(AdapterSpec(f"ad{i}", 8, cfg.name))
        prompt = rng.integers(0, cfg.vocab, 5 + i).astype(np.int32)
        reqs.append(Request(i, f"ad{i}", prompt, n, float(i)))
    srv.run(reqs)
    return srv


def _tokens(srv):
    return {s.req.rid: s.generated for s in srv.states}


@pytest.mark.parametrize("memory", ["paged", "dense"])
def test_megastep_draws_equal_single_step_draws(memory):
    """At T = 0.8 a K = 4 megastep gives bitwise the tokens of 4 single
    steps on the same seed: each step draws one (rows, vocab) block
    whatever rows are active."""
    mega = _serve(megastep=4, memory=memory)
    single = _serve(megastep=0, memory=memory)
    assert mega.backend.transfer_stats["megasteps"] > 0
    assert single.backend.transfer_stats["megasteps"] == 0
    assert _tokens(mega) == _tokens(single)
    assert all(len(s.generated) == s.req.max_new_tokens
               for s in mega.states)


def test_seed_repeats_and_another_seed_differs():
    """The weights are held fixed (the server's seed also seeds its
    init), so only the sampling generator's seed differs."""
    a = _serve(seed=0)
    b = _serve(seed=0, params=a.params)
    c = _serve(seed=1, params=a.params)
    greedy = _serve(seed=0, params=a.params, temperature=0.0)
    assert _tokens(a) == _tokens(b)
    assert _tokens(a) != _tokens(c)
    assert _tokens(greedy) != _tokens(a)
