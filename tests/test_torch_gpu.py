"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (a CUDA
kernel has no CPU mode).  The file imports only torch, numpy and the port,
so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the bit-plane and LUT-readout kernels equal their plain versions
exactly (int32); the paged read, over fp, int8 and int4 pages, is within one
bf16 ulp at magnitude 1 (2^-7) in bfloat16 and 1e-5 in float32, since both
round at the same points (the dequantized elements are equal) and differ
only in float32 summation order and the few-ulp rounding of the per-chunk
rescale inside the softmax sum.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.da import DAConfig, build_luts
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import kv_quant

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _queued(plan_splits: int) -> int:
    """CUDA launches of one VMM call: the kernel, and the zeroing of the
    output when its reduction is split across blocks."""
    return 1 + (plan_splits > 1)


@pytest.mark.parametrize("m,k,n,x_bits,signed", [
    (4, 4096, 6144, 8, True), (64, 4096, 4096, 8, True), (3, 37, 20, 8, True),
    (5, 300, 70, 4, True), (9, 129, 65, 8, False), (1, 45, 6, 8, True),
    (4, 45, 6, 8, True), (8, 45, 6, 8, False), (64, 45, 6, 8, True),
    (300, 45, 6, 8, True), (300, 1000, 200, 8, True)])
def test_bitplane_kernel_equals_plain(card, m, k, n, x_bits, signed):
    from repro_torch.kernels import build
    from repro_torch.kernels.bitplane_vmm import bitplane_plan, bitplane_vmm_cuda
    from repro_torch.kernels.ref import bitplane_vmm_ref

    g = torch.Generator(device=card).manual_seed(m + k + n)
    lo, hi = (-(1 << (x_bits - 1)), 1 << (x_bits - 1)) if signed else (0, 1 << x_bits)
    xq = torch.randint(lo, hi, (m, k), generator=g, device=card, dtype=torch.int32)
    wq = torch.randint(-128, 128, (k, n), generator=g, device=card, dtype=torch.int8)
    cfg = DAConfig(x_bits=x_bits, x_signed=signed)
    plan = bitplane_plan(m, k, n, build.sms(card.index or 0))
    before = bitplane_vmm_cuda.launches, bitplane_vmm_cuda.cuda_launches
    y = bitplane_vmm_cuda(xq, wq, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, bitplane_vmm_ref(xq, wq, cfg))
    assert (bitplane_vmm_cuda.launches, bitplane_vmm_cuda.cuda_launches) == (
        before[0] + 1, before[1] + _queued(plan.splits))
    # split K adds with atomics: any order, the same bits
    assert torch.equal(bitplane_vmm_cuda(xq, wq, cfg), y)
    # a column slice of a wider buffer (the fused q|k|v layout): 16-byte
    # aligned rows (the serve's) and misaligned ones
    for width, off in ((n + 48, 16), (n + 40, 24)):
        wide = torch.randint(-128, 128, (k, width), generator=g, device=card,
                             dtype=torch.int8)
        view = wide[:, off:off + n]
        assert view.stride(0) > n
        assert torch.equal(bitplane_vmm_cuda(xq, view, cfg),
                           bitplane_vmm_ref(xq, view, cfg))
    with pytest.raises(TypeError, match="int8"):
        bitplane_vmm_cuda(xq, wq.to(torch.int32), cfg)


@pytest.mark.parametrize("m,k,n,x_bits,signed,group", [
    (4, 256, 8000, 8, True, 8), (64, 256, 768, 8, True, 8),
    (4, 768, 256, 8, True, 8), (4, 25, 6, 8, False, 8),
    (33, 100, 17, 4, True, 4), (5, 37, 20, 2, False, 4),
    (3, 40, 12, 8, True, 16),
    # prefill widths, ragged N and K among them
    (64, 256, 256, 8, True, 8), (64, 768, 256, 8, False, 8),
    (300, 256, 8000, 8, True, 8), (300, 130, 70, 8, True, 8),
    (64, 37, 17, 4, False, 4), (128, 256, 8000, 8, False, 8),
    (300, 100, 17, 8, True, 16)])
def test_lut_kernel_equals_plain(card, m, k, n, x_bits, signed, group):
    from repro_torch.kernels import build
    from repro_torch.kernels.da_vmm import da_vmm_cuda, lut_plan
    from repro_torch.kernels.ref import da_vmm_ref

    g = torch.Generator(device=card).manual_seed(m + k + n)
    lo, hi = (-(1 << (x_bits - 1)), 1 << (x_bits - 1)) if signed else (0, 1 << x_bits)
    xq = torch.randint(lo, hi, (m, k), generator=g, device=card, dtype=torch.int32)
    wq = torch.randint(-128, 128, (k, n), generator=g, device=card, dtype=torch.int32)
    cfg = DAConfig(group_size=group, x_bits=x_bits, x_signed=signed)
    luts = build_luts(wq, group)
    plan = lut_plan(m, n, luts.shape[0], build.sms(card.index or 0))
    before = da_vmm_cuda.launches, da_vmm_cuda.cuda_launches
    y = da_vmm_cuda(xq, luts, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, da_vmm_ref(xq, luts, cfg))
    splits = -(-luts.shape[0] // plan.gpb)
    assert (da_vmm_cuda.launches, da_vmm_cuda.cuda_launches) == (
        before[0] + 1, before[1] + _queued(splits))
    # split groups add with atomics: any order, the same bits
    assert torch.equal(da_vmm_cuda(xq, luts, cfg), y)
    with pytest.raises(ValueError, match="group_size"):
        da_vmm_cuda(xq, luts, DAConfig(group_size=group // 2, x_bits=x_bits))
    with pytest.raises(TypeError, match="int32"):
        da_vmm_cuda(xq, luts.to(torch.int64), cfg)


def test_pallas_lut_pack_launches_the_kernel(card):
    from repro_torch.core.engine import da_matmul, pack_weights
    from repro_torch.kernels.da_vmm import da_vmm_cuda

    w = torch.randn(256, 768, device=card)
    p = pack_weights(w, mode="pallas_lut")
    assert p.luts.device.type == "cuda" and tuple(p.luts.shape) == (32, 256, 768)
    x = torch.randn(4, 256, device=card)
    before = da_vmm_cuda.launches
    y = p(x)
    assert da_vmm_cuda.launches == before + 1
    assert torch.equal(y, da_matmul(x, p, mode="lut"))


def _paged_case(gen, dev, dtype, t, lens, hd=64, ps=4, n_pages=12, h=4, kv=2):
    """Permuted physical pages, ragged tpos, a pad lane at the garbage
    position."""
    b = len(lens)
    w = max(-(-n // ps) for n in lens) + 1
    q = torch.randn(b, t, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(n_pages, ps, kv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(n_pages, ps, kv, hd, generator=gen, device=dev).to(dtype)
    perm = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).tolist()
    table = torch.zeros((b, w), dtype=torch.int32)
    tpos = torch.zeros((b, t), dtype=torch.int32)
    for i, n in enumerate(lens):
        need = -(-n // ps)
        table[i, :need] = torch.tensor(perm[:need])
        perm = perm[need:]
        tpos[i] = torch.arange(n - t, n).clamp(min=0)
    tpos[0, 0] = (w - 1) * ps
    return q, k, v, table.to(dev), tpos.to(dev)


#: (T, row lengths, page size, pages in the pool, all-masked row): a short
#: table; a long one (W = 300, split into many chunks) at decode and at a
#: prefill width; a row whose every query is masked (uniform over all S)
PAGED_CASES = {"short": (3, [5, 11, 8], 4, 12, None),
               "long_t1": (1, [4780, 2000], 16, 430, None),
               "long_t16": (16, [4780, 2000], 16, 430, None),
               "all_masked": (3, [5, 11, 8], 4, 12, 1)}


def _paged_args(gen, dev, dtype, case):
    t, lens, ps, n_pages, masked = PAGED_CASES[case]
    q, k, v, table, tpos = _paged_case(gen, dev, dtype, t, lens, ps=ps,
                                       n_pages=n_pages)
    if masked is not None:
        tpos[masked] = -1
    return q, k, v, table, tpos


@pytest.mark.parametrize("case", list(PAGED_CASES))
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2.0 ** -7),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("mask_mode", ["where", "additive"])
def test_paged_kernel_matches_plain(card, dtype, atol, mask_mode, case):
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.attention import paged_gather_read

    gen = torch.Generator(device=card).manual_seed(5)
    args = _paged_args(gen, card, dtype, case)
    before = paged_attention_cuda.launches, paged_attention_cuda.cuda_launches
    out = paged_attention(*args, mask_mode=mask_mode)
    ref = paged_gather_read(*args, mask_mode=mask_mode)
    assert (out.float() - ref.float()).abs().max().item() <= atol
    assert (paged_attention_cuda.launches, paged_attention_cuda.cuda_launches) == (
        before[0] + 1, before[1] + 2)
    # the PV launch's last block sums the chunks in a fixed order: same bits
    assert torch.equal(paged_attention(*args, mask_mode=mask_mode), out)


@pytest.mark.parametrize("case", list(PAGED_CASES))
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2.0 ** -7),
                                        (torch.float32, 1e-5)])
def test_paged_kernel_reads_quantized_pools(card, kv_dtype, dtype, atol, case):
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.attention import paged_gather_read

    gen = torch.Generator(device=card).manual_seed(6)
    q, k, v, table, tpos = _paged_args(gen, card, dtype, case)
    (kc, ks), (vc, vs) = (kv_quant.quantize_kv(x, kv_dtype) for x in (k, v))
    before = paged_attention_cuda.launches_by_format[kv_dtype]
    out = paged_attention(q, kc, vc, table, tpos, k_scale=ks, v_scale=vs)
    ref = paged_gather_read(q, kc, vc, table, tpos, k_scale=ks, v_scale=vs)
    assert (out.float() - ref.float()).abs().max().item() <= atol
    assert paged_attention_cuda.launches_by_format[kv_dtype] == before + 1
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(*_paged_case(gen, card, torch.float32, 1, [5], hd=16))
    if kv_dtype == "int4":  # a lane's codes would split a byte
        q, k, v, table, tpos = _paged_case(gen, card, dtype, 1, [5], hd=32)
        (kc, ks), (vc, vs) = (kv_quant.quantize_kv(x, kv_dtype) for x in (k, v))
        with pytest.raises(ValueError, match="head_dim"):
            paged_attention(q, kc, vc, table, tpos, k_scale=ks, v_scale=vs)


def test_entry_points_run_on_the_card(card):
    """Without device=, init_model / freeze_model land on CUDA and the
    frozen DA linear runs through the kernel."""
    from repro_torch.configs.registry import get, reduce_for_smoke
    from repro_torch.core.freeze import freeze_model
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.models.model import init_model

    params = freeze_model(init_model(reduce_for_smoke(get("qwen3-8b"))))
    p = params["blocks"][0]["ffn"]["w_up"]
    assert p.wq.device.type == "cuda" and p.mode == "pallas_bitplane"
    before = bitplane_vmm_cuda.launches
    x = torch.randn(3, 64, device=card)
    y = p(x)
    assert y.shape == (3, 128) and bitplane_vmm_cuda.launches == before + 1
    assert np.isfinite(y.cpu().numpy()).all()
