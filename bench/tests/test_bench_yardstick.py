"""The roofline and mfu arithmetic, and the reduction of a device trace."""
from __future__ import annotations

import numpy as np
import pytest

from bench import devtrace, yardstick
from bench.model import BENCH, desc_from_file, load_json
from bench.readers import load_reader
from bench.serve import RunData, program_config
from bench.window import Sent, window_metrics
from tiny import config_file


def test_vmm_bound_compute_and_memory_sides():
    # decode: weights dominate (memory bound)
    t = yardstick.vmm_bound_s([4, 4096], [4096, 12288])
    assert t == pytest.approx((4 * 4096 * 4 + 4096 * 12288 + 4 * 12288 * 4) / 3.35e12)
    # a 1024-row prefill: compute bound at the int8 peak
    t = yardstick.vmm_bound_s([1024, 4096], [4096, 16384])
    assert t == pytest.approx(2 * 1024 * 4096 * 16384 / 1979e12)
    # the experts' entry: E times one expert's product
    one = yardstick.vmm_bound_s([64, 2048], [2048, 1408])
    assert yardstick.vmm_bound_s([64, 64, 2048], [64, 2048, 1408]) == pytest.approx(64 * one)


def test_attention_bound():
    # one decode row over 1000 cached positions, 8 KV heads of 128, bf16
    t = yardstick.attention_bound_s([(1, 1000)], 32, 8, 128)
    assert t == pytest.approx((2 * 1000 * 8 * 128 * 2 + 2 * 32 * 128 * 2) / 3.35e12)


@pytest.mark.parametrize("name", ["minitron-8b", "qwen2-moe-a2.7b"])
def test_matmul_params_against_the_programs_count(name):
    """The body and head parameters are the port's active parameters less
    the embedding table and the norms and biases."""
    from repro_torch.models.model import count_active_params

    raw = load_json(BENCH / config_file(name))
    d, cfg = desc_from_file(raw), program_config(raw)
    p = yardstick.matmul_params(d)
    vectors = d.n_layers * (2 * d.d_model * (2 if d.norm_type == "layernorm" else 1)
                            + (d.q_dim + 2 * d.kv_dim if d.attn_bias else 0))
    vectors += d.d_model * (2 if d.norm_type == "layernorm" else 1)
    assert p["body"] + p["head"] + d.vocab * d.d_model + vectors == count_active_params(cfg)


def _data(sent, t0, t1, desc, sl=None, calls=()):
    return RunData(desc=desc, mix={"serve": {"batch_size": 4}}, sent=sent, t0=t0, t1=t1,
                   window=window_metrics(sent, t0, t1), tick_hist={"sum": 1.0, "count": 4},
                   tick_spans=[{"decode_lanes": 3}, {"decode_lanes": 4}], slice=sl,
                   attention_calls=list(calls))


def test_mfu_reader_counts_prompts_at_their_first_token():
    desc = desc_from_file(load_json(BENCH / "configs" / "minitron-8b.json"))
    r = Sent(0, 0, np.zeros(3, np.int32), 3, submit_t=0.0, times=[1.0, 2.0, 3.0], tokens=[1, 2, 3])
    data = _data([r], 0.5, 2.5, desc)
    # in the window: the prompt's 3 tokens (contexts 1, 2, 3) and the decode
    # of token 0 at position 3 (context 4); two sampled tokens
    ops = yardstick.window_ops(desc, 4, 1 + 2 + 3 + 4, 2)
    assert load_reader("mfu")(data) == pytest.approx(100 * ops / (2.0 * 1979e12))
    assert load_reader("tick_ms")(data) == pytest.approx(250.0)
    assert load_reader("decode_occupancy")(data) == pytest.approx(87.5)
    assert load_reader("plain_ops_share")(data) is None


def _trace():
    """A Chrome trace of two ticks: a VMM op launching a memset and its
    kernel, an attention op, a plain kernel, and an idle stretch."""
    ev = []

    def x(cat, name, ts, dur, tid=1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
                   "args": args})

    x("user_annotation", devtrace.TICK, 0, 100)
    x("user_annotation", devtrace.TICK, 100, 100)
    x("user_annotation", "paged_step[4x1]", 5, 40)
    x("cpu_op", "repro_torch::bitplane_vmm", 10, 5, **{"Input Dims": [[4, 64], [64, 128], [], [], []]})
    x("cuda_runtime", "cudaMemsetAsync", 11, 1, correlation=1)
    x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2)
    x("cpu_op", "repro_torch::paged_attention", 20, 5, **{"Input Dims": [[4, 1, 4, 16]]})
    x("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=3)
    x("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=4)
    x("gpu_memset", "Memset (Device)", 20, 2, tid=7, correlation=1)
    x("kernel", "bitplane_vmm_kernel<4,4,true>", 22, 8, tid=7, correlation=2)
    x("kernel", "paged_attn_kernel<bf16,128,0>", 30, 10, tid=7, correlation=3)
    x("kernel", "elementwise_kernel", 40, 20, tid=7, correlation=4)
    return {"traceEvents": ev}


def test_trace_reduction():
    sl = devtrace.reduce_trace(_trace())
    assert (sl.start, sl.end, sl.ticks) == (0, 200, 2)
    assert sl.busy_s == pytest.approx(40e-6)
    assert sl.wall_s == pytest.approx(200e-6)
    assert sl.time_s(op="repro_torch::bitplane_vmm") == pytest.approx(10e-6)
    assert sl.time_s(op="repro_torch::paged_attention") == pytest.approx(10e-6)
    assert sl.time_s(op="") == pytest.approx(20e-6)
    assert ("repro_torch::bitplane_vmm", [[4, 64], [64, 128], [], [], []]) in sl.ops
    labels = dict(sl.gaps)
    assert labels["paged_step[4x1]"] == pytest.approx(20)      # 0-20, inside the step
    assert labels[devtrace.TICK] == pytest.approx(140)         # 60-200
    b = devtrace.breakdown(sl)
    assert b["device_ops"][0] == ["elementwise_kernel", pytest.approx(20e-6)]
    assert len(b["idle_gaps"]) <= 10


def test_layer_readers_on_a_trace():
    desc = desc_from_file(load_json(BENCH / "configs" / "minitron-8b.json"))
    sl = devtrace.reduce_trace(_trace())
    data = _data([], 0.0, 1.0, desc, sl=sl, calls=[[(1, 10)] * 4])
    vmm = load_reader("bitplane_vmm_roofline")(data)
    assert vmm == pytest.approx(100 * yardstick.vmm_bound_s([4, 64], [64, 128]) / 10e-6)
    attn = load_reader("paged_attention_roofline")(data)
    want = desc.n_layers * yardstick.attention_bound_s([(1, 10)] * 4, 48, 8, 128)
    assert attn == pytest.approx(100 * want / 10e-6)
    assert load_reader("plain_ops_share")(data) == pytest.approx(50.0)
    assert load_reader("device_idle_share")(data) == pytest.approx(80.0)
