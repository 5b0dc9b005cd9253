"""The plain reference against the port's own arithmetic at reduced
widths: the same weight codes, the same DA products, the port's weight
layout, and the whole forward within the rounding of the port's bfloat16
activations."""
from __future__ import annotations

import pytest
import torch

from bench import reference
from bench.model import desc_from_file
from bench.serve import _freezer, program_config
from bench.weights import layer_weights, make_params
from tiny import tiny_config

CONFIGS = ["minitron-8b", "qwen2-moe-a2.7b"]


def _tree_shapes(t, path=()):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_tree_shapes(v, path + (k,)))
        return out
    if isinstance(t, list):
        out = {}
        for i, v in enumerate(t):
            out.update(_tree_shapes(v, path + (str(i),)))
        return out
    return {"/".join(path): (tuple(t.shape), t.dtype)}


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_in_the_ports_layout(name):
    from repro_torch.models.model import abstract_params

    raw = tiny_config(name)
    got = make_params(desc_from_file(raw), 7, torch.device("cpu"))
    assert _tree_shapes(got) == _tree_shapes(abstract_params(program_config(raw)))


def test_weights_are_the_seeds():
    d = desc_from_file(tiny_config("qwen2-moe-a2.7b"))
    a, b = layer_weights(d, 2**31 + 3, 1, "cpu"), layer_weights(d, 2**31 + 3, 1, "cpu")
    c = layer_weights(d, 2**31 + 4, 1, "cpu")
    assert torch.equal(a["mixer"]["wq"], b["mixer"]["wq"])
    assert not torch.equal(a["mixer"]["wq"], c["mixer"]["wq"])
    assert not a["ffn"]["w_up"][d.n_experts:].any()          # padded experts zero
    assert a["ffn"]["router"].dtype == torch.float32


@pytest.mark.parametrize("shape", [(64, 96), (5, 64, 32)])
def test_codes_and_scales_equal_the_ports_packing(shape):
    from repro_torch.core.engine import pack_weights

    w = (torch.randn(shape, generator=torch.Generator().manual_seed(0)) * 0.05).to(torch.bfloat16)
    packed = pack_weights(w, mode="pallas_bitplane")
    for e in range(shape[0] if len(shape) == 3 else 1):
        lin = reference.Linear(w[e] if len(shape) == 3 else w)
        want_q = packed.wq[e] if len(shape) == 3 else packed.wq
        want_s = packed.w_scale[e] if len(shape) == 3 else packed.w_scale
        assert torch.equal(lin.codes, want_q) and torch.equal(lin.scale, want_s)


def test_product_equals_the_ports_da_matmul():
    from repro_torch.core.engine import da_matmul, pack_weights

    g = torch.Generator().manual_seed(1)
    w = (torch.randn((64, 96), generator=g) * 0.1).to(torch.bfloat16)
    x = torch.randn((7, 64), generator=g)
    assert torch.equal(reference.Linear(w)(x), da_matmul(x, pack_weights(w, mode="pallas_bitplane")))


def test_moe_layer_equals_the_ports_on_one_input():
    """One MoE layer on the same bfloat16 input: the routing, the
    renormalised top-k weights, the padded experts and the shared experts'
    sum agree within the port's bfloat16 expert outputs."""
    from repro_torch.models.moe import moe_forward

    raw = tiny_config("qwen2-moe-a2.7b")
    d, cfg = desc_from_file(raw), program_config(raw)
    p = layer_weights(d, 5, 0, "cpu")
    frozen = _freezer(raw, cfg, torch.device("cpu"))({"blocks": [p]})["blocks"][0]
    x = torch.randn((1, 24, d.d_model), generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    with torch.inference_mode():
        got = moe_forward(frozen["ffn"], x, cfg)[0].float()
    want = reference.moe(x[0].float(), p["ffn"], d, 8)
    assert (got - want).abs().max() <= 0.02 * want.abs().max()


#: widest |port − reference| over the logits (standard deviation about
#: 1), and the least share of positions whose argmax agrees: the port
#: rounds every activation to bfloat16 (the reference keeps float32), and
#: in the MoE a token near a routing tie takes another expert (measured on
#: three seeds: dense 0.12-0.15 and 96 %, MoE 0.59-1.25 and 88-95 %)
TOLERANCE = {"minitron-8b": (0.3, 0.9), "qwen2-moe-a2.7b": (2.0, 0.8)}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_matches_the_port(name, seed):
    from repro_torch.models.model import forward

    raw = tiny_config(name)
    d, cfg = desc_from_file(raw), program_config(raw)
    params = make_params(d, seed, torch.device("cpu"), _freezer(raw, cfg, torch.device("cpu")))
    g = torch.Generator().manual_seed(seed)
    seqs = [torch.randint(0, d.vocab, (n,), generator=g).tolist() for n in (17, 40)]
    ref = dict(reference.logits_at(d, seed, seqs, [0, 0], "cpu"))
    worst, agree = 0.0, 0
    for i, s in enumerate(seqs):
        with torch.inference_mode():
            got = forward(params, torch.tensor([s]), cfg)[0][0].float()
        worst = max(worst, float((got - ref[i]).abs().max()))
        agree += int((got.argmax(-1) == ref[i].argmax(-1)).sum())
    tol, share = TOLERANCE[name]
    assert worst <= tol and agree >= share * sum(map(len, seqs))


def test_control_drops_the_low_planes():
    g = torch.Generator().manual_seed(3)
    w = (torch.randn((64, 32), generator=g) * 0.1).to(torch.bfloat16)
    x = torch.randn((5, 64), generator=g)
    lin = reference.Linear(w)
    full, low = lin(x), lin(x, x_bits=4)
    assert not torch.equal(full, low)
    # the truncated codes are multiples of 16: their product is too
    xs = torch.clamp(torch.amax(x.abs(), -1, keepdim=True), min=1e-8) / 127
    acc = low / (xs * lin.scale)
    assert torch.allclose(acc / 16, torch.round(acc / 16), atol=1e-2)
