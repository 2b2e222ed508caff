"""Each metric's arithmetic on synthetic stamps and spans: a stall makes
the tail and the rate worse; the live-rank LoRA roofline and the step's
FLOPs against hand-computed counts; the trace reader's busy time, idle
gaps and attribution."""
import math
import types

import pytest

from servebench import roofline, stats, trace
from servebench.model_config import spec_from_dict

from conftest import tiny_config


def req(submitted, stamps, rid=0, max_new=None):
    r = stats.Tracked(rid, "a00", 8, 10, max_new or len(stamps), submitted)
    r.stamps = list(stamps)
    return r


def steady(n_req=20, gap=0.01, tokens=10, stall=0.0):
    """Requests submitted 0.1 s apart, a token every `gap` after a 0.05 s
    first token; `stall` seconds added before every token of the last
    three."""
    out = []
    for i in range(n_req):
        t = 0.1 * i
        extra = stall if i >= n_req - 3 else 0.0
        out.append(req(t, [t + 0.05 + extra + k * (gap + extra)
                           for k in range(tokens)], rid=i))
    return out


def test_percentile_nearest_rank_and_infinity():
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90) == 9
    assert stats.percentile([5], 90) == 5
    assert stats.percentile([1, 2, math.inf], 90) == math.inf
    assert math.isnan(stats.percentile([], 90))


def test_rates_and_tails():
    base = steady()
    t1 = 10.0
    assert stats.tokens_per_s(base, 0.0, t1) == pytest.approx(200 / t1)
    assert stats.tpot_p90_ms(base, 0.0, t1) == pytest.approx(10.0)


def test_a_stall_makes_the_tail_and_the_rate_worse():
    base, slow = steady(), steady(stall=0.5)
    t1 = 2.5
    assert stats.tpot_p90_ms(slow, 0, 100) > stats.tpot_p90_ms(base, 0, 100)
    assert stats.tokens_per_s(slow, 0, t1) < stats.tokens_per_s(base, 0, t1)


def test_tpot_only_requests_finished_in_the_window():
    r_in = req(0.0, [0.1, 0.2, 0.3])
    r_out = req(0.0, [0.1, 5.0, 9.9])
    r_open = req(0.0, [0.1, 0.2], max_new=5)
    assert stats.tpot_p90_ms([r_in, r_out, r_open], 0, 1) == \
        pytest.approx(100.0)


SPEC = spec_from_dict(tiny_config())        # d 64, H 4 / KV 2, hd 16, L 2
PK = {"flops": 1e12, "bytes": 1e9}


def test_lora_least_time_by_hand():
    # one decode step: 3 rows, two of adapter x (rank 2), one of y (rank 8)
    rows = [(1, 2, "x"), (1, 2, "x"), (1, 8, "y")]
    # q: d_in 64, d_out 64; k, v: 64 -> 32
    by_hand = 0.0
    for d_in, d_out in ((64, 64), (64, 32), (64, 32)):
        nbytes = 2 * (3 * (d_in + d_out) + (2 + 8) * (d_in + d_out))
        ops = 2 * (2 + 2 + 8) * (d_in + d_out)
        by_hand += max(nbytes / PK["bytes"], ops / PK["flops"])
    assert roofline.lora_least_s(SPEC, rows, PK) == pytest.approx(2 * by_hand)


def test_megastep_least_time_counts_rows_still_producing():
    call = trace.Call("decode", 0, 1, None, [(10, 2, 2), (20, 8, 1)],
                      ["x", "y"], 2)
    both = roofline.lora_least_s(SPEC, [(1, 2, "x"), (1, 8, "y")], PK)
    one = roofline.lora_least_s(SPEC, [(1, 2, "x")], PK)
    assert roofline.call_lora_least_s(SPEC, call, PK) == \
        pytest.approx(both + one)


def test_flops_by_hand():
    d, f, H, KV, hd, V, L = 64, 128, 4, 2, 16, 256, 2
    per_layer = d * (H + 2 * KV) * hd + H * hd * d + 3 * d * f
    assert SPEC.matmul_params_a_layer() == per_layer
    lw = (64 + 64) + 2 * (64 + 32)
    tok = 2 * per_layer * L + 4 * H * hd * 5 * L + 2 * 4 * lw * L + 2 * d * V
    assert roofline.token_flops(SPEC, 5, 4, True) == tok
    n = 6
    pre = 2 * per_layer * L * n + 4 * H * hd * L * n * (n + 1) / 2 \
        + 2 * 4 * lw * L * n + 2 * d * V
    assert roofline.prefill_flops(SPEC, n, 4) == pytest.approx(pre)
    call = trace.Call("prefill", 0, 1, None, [(n, 4)], ["x"], 0)
    assert roofline.call_flops(SPEC, call) == pytest.approx(pre)


def synthetic_trace():
    """A span 0-100 us: a decode call (host 10-20) launching a graph
    (correlation 7) whose two kernels run 30-40 and 45-50; a prefill
    (host 50-60, correlation 8) whose kernel runs 60-90; the host in
    sb.step 0-60 and sb.sleep 60-100."""
    X = "X"
    return {"traceEvents": [
        {"ph": X, "cat": "user_annotation", "name": "sb.profile", "ts": 0,
         "dur": 100},
        {"ph": X, "cat": "user_annotation", "name": "sb.step", "ts": 0,
         "dur": 60},
        {"ph": X, "cat": "user_annotation", "name": "sb.decode", "ts": 10,
         "dur": 10},
        {"ph": X, "cat": "user_annotation", "name": "sb.prefill", "ts": 50,
         "dur": 10},
        {"ph": X, "cat": "user_annotation", "name": "sb.sleep", "ts": 60,
         "dur": 40},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 12, "dur": 2, "args": {"correlation": 7}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 55, "dur": 1, "args": {"correlation": 8}},
        {"ph": X, "cat": "kernel", "name": "void lora_shrink_decode_kernel",
         "ts": 30, "dur": 10, "args": {"correlation": 7}},
        {"ph": X, "cat": "kernel", "name": "paged_group_kernel", "ts": 45,
         "dur": 5, "args": {"correlation": 7}},
        {"ph": X, "cat": "kernel", "name": "sm90_xmma_gemm", "ts": 60,
         "dur": 30, "args": {"correlation": 8}},
    ]}


def test_trace_reader():
    p = trace.read_trace(synthetic_trace())
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx(45e-6)
    assert {k.name: k.call for k in p.kernels} == {
        "void lora_shrink_decode_kernel": "decode",
        "paged_group_kernel": "decode", "sm90_xmma_gemm": "prefill"}
    # idle 0-30 and 40-45 in sb.step (0-10 outside a call: sb.step is
    # innermost at 0), 50-60 in sb.prefill, 90-100 in sb.sleep
    assert p.gaps["sb.step"] == pytest.approx(35e-6)
    assert p.gaps["sb.prefill"] == pytest.approx(10e-6)
    assert p.gaps["sb.sleep"] == pytest.approx(10e-6)


def test_families_from_files():
    fams = trace.load_families()
    assert trace.family_of("void lora_shrink_decode_kernel<bf16>", fams) \
        == "lora"
    assert trace.family_of("paged_group_kernel<8>", fams) == \
        "paged_attention"
    assert trace.family_of("flash_bf16_kernel", fams) == "flash"
    assert trace.family_of("sm90_xmma_gemm_bf16bf16", fams) == "gemm"
    assert trace.family_of("void at::native::vectorized_elementwise_kernel",
                           fams) == "elementwise"
    assert trace.family_of("Memcpy HtoD (Pinned -> Device)", fams) == "copy"


def test_readers_on_a_synthetic_context():
    from servebench.harness import load_reader
    prof = trace.read_trace(synthetic_trace())
    dec = trace.Call("decode", 0.5, 0.6, None, [(10, 8, 1)], ["x"], 1,
                     in_profile=True)
    rec = types.SimpleNamespace(calls=[dec], steps=[(0.5, 0.7)])
    ctx = types.SimpleNamespace(
        spec=SPEC, recorder=rec, profile=prof, reqs=[], t0=0.0, t1=1.0,
        t_prof=0.4, families=trace.load_families(), peaks=PK)
    idle = load_reader("device.idle_share.backlog")(ctx)
    assert idle == pytest.approx(55.0)
    least = roofline.call_lora_least_s(SPEC, dec, PK)
    assert load_reader("lora_decode_roofline")(ctx) == \
        pytest.approx(100 * least / 10e-6)
    assert load_reader("lora_prefill_roofline")(ctx) is None
    mfu = load_reader("step_mfu.backlog")(ctx)
    assert mfu == pytest.approx(100 * roofline.call_flops(SPEC, dec)
                                / (100e-6 * PK["flops"]))
