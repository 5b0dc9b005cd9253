"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (a CUDA
kernel has no CPU mode).  The file imports only torch, numpy and the port,
so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the bit-plane and LUT-readout kernels equal their plain versions
exactly (int32); the paged read, over fp, int8 and int4 pages, is EQUAL to
the plain read (both sum in float64 and round at the same points; the
dequantized elements are equal), and is also held within one bf16 ulp at
magnitude 1 (2^-7) in bfloat16 and 1e-5 in float32.
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
    # verify at batch 4: 4 lanes x pow2(gamma + 1) rows
    (16, 4096, 6144, 8, True), (16, 12288, 4096, 8, True),
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
    (16, 256, 8000, 8, True, 8), (16, 768, 256, 8, True, 8),  # verify
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
#: table; verify's read (T = 4, its last column a pad query at the garbage
#: position); a long one (W = 300, split into many chunks) at decode and at
#: a prefill width; a row whose every query is masked (uniform over all S)
PAGED_CASES = {"short": (3, [5, 11, 8], 4, 12, None),
               "verify": (4, [40, 90, 17, 200], 16, 32, None),
               "long_t1": (1, [4780, 2000], 16, 430, None),
               "long_t16": (16, [4780, 2000], 16, 430, None),
               "all_masked": (3, [5, 11, 8], 4, 12, 1)}


def _paged_args(gen, dev, dtype, case, hd=64):
    t, lens, ps, n_pages, masked = PAGED_CASES[case]
    q, k, v, table, tpos = _paged_case(gen, dev, dtype, t, lens, hd=hd, ps=ps,
                                       n_pages=n_pages)
    if masked is not None:
        tpos[masked] = -1
    if case == "verify":
        tpos[:, -1] = (table.shape[1] - 1) * ps
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
    # both sum in float64 and round at the same points: the same bits
    assert torch.equal(out, ref)
    # one cluster launch a read
    assert (paged_attention_cuda.launches, paged_attention_cuda.cuda_launches) == (
        before[0] + 1, before[1] + 1)
    # the cluster sums the chunks in a fixed order: same bits
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
    assert torch.equal(out, ref)
    assert paged_attention_cuda.launches_by_format[kv_dtype] == before + 1
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(*_paged_case(gen, card, torch.float32, 1, [5], hd=48))
    if kv_dtype == "int4":  # a packed row of 8 bytes: less than one copy
        q, k, v, table, tpos = _paged_case(gen, card, dtype, 1, [5], hd=16)
        (kc, ks), (vc, vs) = (kv_quant.quantize_kv(x, kv_dtype) for x in (k, v))
        with pytest.raises(ValueError, match="head_dim"):
            paged_attention(q, kc, vc, table, tpos, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("case", ["short", "verify", "long_t1", "all_masked"])
@pytest.mark.parametrize("hd,kv_dtype", [(16, "fp16"), (16, "int8"), (32, "fp16"),
                                         (32, "int8"), (32, "int4")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
def test_paged_kernel_reads_the_reduced_head_widths(card, dtype, hd, kv_dtype,
                                                    case, softmax):
    """The reduced configs' head widths (16; 32 under M-RoPE), which the
    launcher's ``--smoke`` serves: EQUAL to the plain read, one launch."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.attention import paged_gather_read

    gen = torch.Generator(device=card).manual_seed(8)
    q, k, v, table, tpos = _paged_args(gen, card, dtype, case, hd=hd)
    scales = {}
    if kv_dtype != "fp16":
        (k, ks), (v, vs) = (kv_quant.quantize_kv(x, kv_dtype) for x in (k, v))
        scales = {"k_scale": ks, "v_scale": vs}
    before = paged_attention_cuda.cuda_launches
    out = paged_attention(q, k, v, table, tpos, softmax_dtype=softmax, **scales)
    ref = paged_gather_read(q, k, v, table, tpos, softmax_dtype=softmax, **scales)
    assert torch.equal(out, ref)
    assert paged_attention_cuda.cuda_launches == before + 1


@pytest.mark.parametrize("case", ["short", "verify", "long_t1", "all_masked"])
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_bf16_softmax_matches_plain(card, dtype, kv_dtype, case):
    """The bfloat16 score pipeline (softmax_dtype="bfloat16") over fp, int8
    and int4 pages, at decode and at verify (T = 4, the pad column), within
    2e-2 of the plain read (the reference's tolerance for its kernel: one
    bf16 ulp per reduction of the softmax), and EQUAL to it, since both sum
    in float64 and round at the same points."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.attention import paged_gather_read

    gen = torch.Generator(device=card).manual_seed(8)
    q, k, v, table, tpos = _paged_args(gen, card, dtype, case)
    scales = {}
    if kv_dtype != "fp16":
        (k, ks), (v, vs) = (kv_quant.quantize_kv(x, kv_dtype) for x in (k, v))
        scales = {"k_scale": ks, "v_scale": vs}
    before = paged_attention_cuda.launches_by_softmax["bfloat16"]
    for mode in ("where", "additive"):
        out = paged_attention(q, k, v, table, tpos, softmax_dtype="bfloat16",
                              mask_mode=mode, **scales)
        ref = paged_gather_read(q, k, v, table, tpos, softmax_dtype="bfloat16",
                                mask_mode=mode, **scales)
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
        assert torch.equal(out, ref)
    assert paged_attention_cuda.launches_by_softmax["bfloat16"] == before + 2
    with pytest.raises(ValueError, match="softmax_dtype"):
        paged_attention(q, k, v, table, tpos, softmax_dtype="float16", **scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("t", [1, 4, 16])
def test_paged_kernel_qwen3_reads_match_plain(card, t, kv_dtype, softmax, dtype):
    """qwen3-8b's serve reads (32 query heads over 8 KV heads of 128, page
    16, batch 4, W = 17 at max_len 256) in its serving dtype, bfloat16, and
    in float32 (where sqrt(128) is no power of two, so the plain read's
    divide must be the quotient): decode, verify (its last column a pad
    query at the garbage position) and a prefill chunk of 16 rows, over fp,
    int8 and int4 pages, both mask forms and both score pipelines: EQUAL to
    the plain read, one CUDA launch a read."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.attention import paged_gather_read

    gen = torch.Generator(device=card).manual_seed(9 + t)
    q, k, v, table, tpos = _paged_case(gen, card, dtype, t, [200, 150, 90, 250],
                                       ps=16, n_pages=80, h=32, kv=8, hd=128)
    if t == 4:
        tpos[:, -1] = (table.shape[1] - 1) * 16
    scales = {}
    if kv_dtype != "fp":
        (k, ks), (v, vs) = (kv_quant.quantize_kv(x, kv_dtype) for x in (k, v))
        scales = {"k_scale": ks, "v_scale": vs}
    before = paged_attention_cuda.launches, paged_attention_cuda.cuda_launches
    for mode in ("where", "additive"):
        out = paged_attention(q, k, v, table, tpos, mask_mode=mode,
                              softmax_dtype=softmax, **scales)
        ref = paged_gather_read(q, k, v, table, tpos, mask_mode=mode,
                                softmax_dtype=softmax, **scales)
        assert torch.equal(out, ref)
    assert (paged_attention_cuda.launches, paged_attention_cuda.cuda_launches) == (
        before[0] + 2, before[1] + 2)


def test_slot_runtime_serves_on_the_card(card, monkeypatch):
    """runtime="slots" on the card: the dense cache lives there, every
    matrix runs the bit-plane kernel, no attention kernel is launched, and
    the tokens EQUAL the same serve with the kernel swapped for its plain
    version (exact int32 either way)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.serve.engine import Request, ServeEngine

    cfg, params = _tiny_frozen_engine_params()
    rng = np.random.default_rng(3)
    prompts = {u: rng.integers(0, cfg.vocab, n).astype(np.int32)
               for u, n in enumerate((5, 19, 33, 12))}

    def serve(runtime):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64, runtime=runtime)
        for u, p in prompts.items():
            eng.submit(Request(uid=u, prompt=p, max_new_tokens=8))
        done = eng.run()
        return eng, {u: done[u].generated for u in done}

    bp, pa = bitplane_vmm_cuda.launches, paged_attention_cuda.launches
    eng, slots = serve("slots")
    assert eng.caches["pos_0"].k.device.type == "cuda"
    assert bitplane_vmm_cuda.launches > bp
    assert paged_attention_cuda.launches == pa
    assert eng.metrics()["prefill_compiles"] == 4   # buckets 8, 16, 32, 64
    monkeypatch.setattr(ops, "bitplane_vmm", ref.bitplane_vmm_ref)
    bp = bitplane_vmm_cuda.launches
    assert serve("slots")[1] == slots
    assert bitplane_vmm_cuda.launches == bp


def test_entry_points_run_on_the_card(card):
    """Without device=, init_model / freeze_model land on CUDA and the
    frozen DA linear runs through the kernel."""
    from repro_torch.configs.registry import get, reduce_for_smoke
    from repro_torch.core.freeze import freeze_model_da
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.models.model import init_model

    params = freeze_model_da(init_model(reduce_for_smoke(get("qwen3-8b"))),
                             mode="pallas_bitplane")
    p = params["blocks"][0]["ffn"]["w_up"]
    assert p.wq.device.type == "cuda" and p.mode == "pallas_bitplane"
    before = bitplane_vmm_cuda.launches
    x = torch.randn(3, 64, device=card)
    y = p(x)
    assert y.shape == (3, 128) and bitplane_vmm_cuda.launches == before + 1
    assert np.isfinite(y.cpu().numpy()).all()


@pytest.mark.parametrize("mode", ["pallas_bitplane", "bitplane", "bitplane_stacked",
                                  "pallas_lut"])
@pytest.mark.parametrize("eff", [8, 4, 1])
def test_truncated_bits_run_the_kernels(card, mode, eff):
    """``x_bits_eff`` on CUDA is one kernel launch at x_bits = eff, EQUAL to
    the plain version's truncated evaluation on the CPU; ``bitplane`` and
    ``bitplane_stacked`` run the bit-plane kernel too."""
    import dataclasses

    from repro_torch.core.engine import da_vmm, pack_weights
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.da_vmm import da_vmm_cuda

    g = torch.Generator(device=card).manual_seed(eff)
    w = torch.randn(300, 70, generator=g, device=card)
    p = pack_weights(w, mode=mode)
    xq = torch.randint(-128, 128, (5, 300), generator=g, device=card,
                       dtype=torch.int32)
    counter = da_vmm_cuda if mode == "pallas_lut" else bitplane_vmm_cuda
    before = counter.launches, counter.launches_by_bits.get(eff, 0)
    y = da_vmm(xq, p, x_bits_eff=eff)
    assert (counter.launches, counter.launches_by_bits.get(eff, 0)) == (
        before[0] + 1, before[1] + 1)
    cpu = dataclasses.replace(p, wq=p.wq.cpu(), w_scale=p.w_scale.cpu(),
                              luts=None if p.luts is None else p.luts.cpu())
    assert torch.equal(y.cpu(), da_vmm(xq.cpu(), cpu, x_bits_eff=eff))


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128), (torch.float32, 64)])
def test_verify_rows_equal_decode_rows(card, dtype, hd, kv_dtype):
    """A verify read (3 window rows and a pad column at the garbage
    position) gives each query the bits of the T = 1 read of its row at its
    position, at batch 4 and alone: spec tokens rest on it."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    gen = torch.Generator(device=card).manual_seed(7)
    b, t, w, ps, kv, h = 4, 4, 17, 16, 2, 8
    q = torch.randn(b, t, h, hd, generator=gen, device=card).to(dtype)
    k = torch.randn(b * w + 1, ps, kv, hd, generator=gen, device=card).to(dtype)
    v = torch.randn(b * w + 1, ps, kv, hd, generator=gen, device=card).to(dtype)
    scales = {}
    if kv_dtype == "int8":
        (k, ks), (v, vs) = (kv_quant.quantize_kv(x, "int8") for x in (k, v))
        scales = dict(k_scale=ks, v_scale=vs)
    table = torch.cat([torch.arange(1, b * (w - 1) + 1, device=card).reshape(
        b, w - 1), torch.zeros(b, 1, device=card, dtype=torch.long)], 1).int()
    start = torch.tensor([0, 37, 100, 250], device=card)
    tpos = (start[:, None] + torch.arange(t, device=card)[None]).int()
    tpos[:, -1] = (w - 1) * ps

    def read(qq, tp, tb=table):
        return paged_attention_cuda(qq.contiguous(), k, v, tb.contiguous(),
                                    tp.contiguous(), **scales)

    full, three = read(q, tpos), read(q[:, :3], tpos[:, :3])
    for j in range(t - 1):
        one = read(q[:, j:j + 1], tpos[:, j:j + 1])
        assert torch.equal(full[:, j], one[:, 0])
        assert torch.equal(three[:, j], one[:, 0])
        assert torch.equal(read(q[:1, j:j + 1], tpos[:1, j:j + 1], table[:1])[0, 0],
                           one[0, 0])


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "int4"])
def test_copy_page_and_defrag_on_cuda_pools(card, kv_dtype):
    """COW copies and defrag move codes and in-page scales on the card
    exactly as on the CPU."""
    from repro_torch.configs.registry import get, reduce_for_smoke
    from repro_torch.serve import kvcache

    cfg = reduce_for_smoke(get("qwen3-8b"))
    caches = kvcache.init_paged_caches(cfg, 9, 4, torch.float32,
                                       kv_dtypes=kv_dtype)
    gen = torch.Generator(device=card).manual_seed(3)
    for leaf in kvcache._leaves(caches):
        leaf.copy_(torch.randint(-7, 8, leaf.shape, generator=gen,
                                 device=card).to(leaf.dtype))
    cpu = {k: type(c)(**{f: None if getattr(c, f) is None else getattr(c, f).cpu()
                         for f in ("k", "v", "k_scale", "v_scale")})
           for k, c in caches.items()}
    for tree in (caches, cpu):
        kvcache.copy_page(tree, 3, 7)
    pools = []
    for tree in (caches, cpu):
        pool = kvcache.PagePool(9)
        pages = pool.alloc(8)
        pool.free([p for p in pages if p not in (5, 2, 7)])
        tables = [[5, 2], [7]]
        kvcache.defrag(tree, pool, tables)
        pools.append((tables, list(pool._ref)))
    assert pools[0] == pools[1]
    for a, b in zip(kvcache._leaves(caches), kvcache._leaves(cpu)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


def test_spec_and_prefix_serve_on_the_card(card):
    """The CI smoke's model (hd 64, float32) frozen with bitplane_stacked:
    spec and prefix-cache tokens on the card EQUAL its plain serve's, through
    the bit-plane kernel at 4 bits and the attention kernel at T = 4."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.spec import SpecConfig

    cfg = dataclasses.replace(get("qwen3-8b"), name="qwen3-20m", n_layers=4,
                              d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                              d_ff=768, vocab=8000, param_dtype="float32",
                              compute_dtype="float32")
    params = ServeEngine(cfg, init_model(cfg, seed=0), batch_size=2, max_len=96,
                         da_mode="bitplane_stacked").params
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 6 + u)])
               for u in range(4)]

    def serve(**kw):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=96, **kw)
        for u, p in enumerate(prompts):
            eng.submit(Request(uid=u, prompt=p.astype(np.int32), max_new_tokens=12))
        done = eng.run()
        assert eng.metrics()["pool"]["used_pages"] == (
            eng.metrics()["prefix_cache"]["trie_pages"] if kw.get("prefix_cache")
            else 0)
        return {u: done[u].generated for u in done}

    plain = serve()
    bits4, t4 = bitplane_vmm_cuda.launches_by_bits.get(4, 0), \
        paged_attention_cuda.launches_by_t.get(4, 0)
    assert serve(spec=SpecConfig("bitplane", gamma=2, draft_x_bits=4,
                                 disable_below=0.0)) == plain
    assert bitplane_vmm_cuda.launches_by_bits[4] > bits4
    assert paged_attention_cuda.launches_by_t[4] > t4
    assert serve(prefix_cache=True) == plain


@pytest.mark.parametrize("dtype,hd,w", [(torch.bfloat16, 128, 17),
                                        (torch.bfloat16, 128, 300),
                                        (torch.float32, 64, 9)])
def test_decode_rows_do_not_depend_on_the_batch(card, dtype, hd, w):
    """A row's decode read gives the same bits at batch 1-4: the split's
    chunk follows the table width, never the batch."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    gen = torch.Generator(device=card).manual_seed(11)
    ps, kv, h = 16, 2, 8
    k = torch.randn(4 * w + 1, ps, kv, hd, generator=gen, device=card).to(dtype)
    v = torch.randn(4 * w + 1, ps, kv, hd, generator=gen, device=card).to(dtype)
    table = torch.cat([torch.randperm(4 * w, generator=gen, device=card)[
        :4 * (w - 1)].reshape(4, w - 1) + 1,
        torch.zeros(4, 1, device=card, dtype=torch.long)], 1).int()
    for _ in range(20):
        q = torch.randn(4, 1, h, hd, generator=gen, device=card).to(dtype)
        tpos = torch.randint(0, (w - 1) * ps, (4, 1), generator=gen,
                             device=card).int()
        alone = [paged_attention_cuda(q[r:r + 1], k, v, table[r:r + 1].contiguous(),
                                      tpos[r:r + 1]) for r in range(4)]
        for b in (2, 3, 4):
            out = paged_attention_cuda(q[:b], k, v, table[:b].contiguous(),
                                       tpos[:b].contiguous())
            for r in range(b):
                assert torch.equal(out[r], alone[r][0])


def test_norm_rows_do_not_depend_on_the_row_count(card):
    from repro_torch.models.layers import _mean_square

    x = torch.randn(64, 4096, device=card)
    full = _mean_square(x)
    for r in (1, 2, 3, 4, 8, 16):
        assert torch.equal(_mean_square(x[:r]), full[:r])


def _tiny_frozen_engine_params():
    """The CI smoke's model (hd 64, float32: a head shape the attention
    kernel has an instance for), frozen for the bit-plane kernel."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.core.freeze import freeze_model_da
    from repro_torch.models.model import init_model

    cfg = dataclasses.replace(get("qwen3-8b"), name="qwen3-20m", n_layers=4,
                              d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                              d_ff=768, vocab=8000, param_dtype="float32",
                              compute_dtype="float32")
    return cfg, freeze_model_da(init_model(cfg, seed=0), mode="pallas_bitplane")


def _traced_serve(cfg, params, trace, **kw):
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, batch_size=2, max_len=32, page_size=8,
                      paged_attn="fused", trace=trace, **kw)
    rng = np.random.default_rng(7)
    for u in range(4):
        eng.submit(Request(uid=u, prompt=rng.integers(0, cfg.vocab, 3 + u)
                           .astype(np.int32), max_new_tokens=4))
    done = eng.run()
    return eng, {u: done[u].generated for u in done}


def test_traced_serve_on_the_card_changes_nothing(card):
    """The recorder on the card: tokens, every counter and observation
    count and the hw block equal the untraced serve's; spans balance and the
    exported trace validates."""
    from repro_torch.obs import chrome_trace, validate_chrome_trace
    from repro_torch.spec import SpecConfig

    cfg, params = _tiny_frozen_engine_params()
    spec = SpecConfig("bitplane", gamma=2, draft_x_bits=4, disable_below=0.0)

    def view(eng):
        return {k: (v["count"] if isinstance(v, dict) else v)
                for k, v in eng.metrics_snapshot().items()}

    off, toks_off = _traced_serve(cfg, params, False, spec=spec)
    on, toks_on = _traced_serve(cfg, params, True, spec=spec)
    assert toks_on == toks_off
    assert view(on) == view(off)
    assert on.metrics()["hw"] == off.metrics()["hw"]
    assert on.obs.tracer.span_balance() == {}
    assert validate_chrome_trace(chrome_trace(on.obs.tracer)) == []


@pytest.mark.parametrize("trace", [True, False])
def test_device_span_brackets_the_serve_kernels(card, trace):
    """With the recorder on, every bit-plane and attention kernel of a
    decode step runs inside its ``paged_step[...]`` annotation on the
    profiler's timeline; off, there is no annotation."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import kernels_in_spans

    cfg, params = _tiny_frozen_engine_params()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _traced_serve(cfg, params, trace)
        torch.cuda.synchronize()
    by_name = kernels_in_spans(prof)
    ours = {k: v for k, v in by_name.items()
            if "bitplane_vmm_kernel" in k or "paged_attn_" in k}
    assert any("bitplane_vmm_kernel" in k for k in ours)
    assert any("paged_attn_" in k for k in ours)
    inside = sum(v[0] for v in ours.values())
    outside = sum(v[1] for v in ours.values())
    if trace:
        assert inside > 0 and outside == 0
    else:
        assert inside == 0 and outside > 0


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64])
@pytest.mark.parametrize("k,n", [(37, 20), (64, 24), (64, 128), (300, 70),
                                 (4096, 6144)])
def test_int8_baseline_on_the_card(card, m, k, n):
    """The int8 baseline on CUDA: ``torch._int_mm`` on zero-padded operands
    (M > 16, K and N multiples of 8; the weights column-major, laid out
    once per pack) sliced back,
    EQUAL to the exact int64 product, at M <= 16 and ragged K, N too."""
    from repro_torch.core.engine import da_vmm, pack_weights

    g = torch.Generator(device=card).manual_seed(m * 7 + k)
    p = pack_weights(torch.randn(k, n, generator=g, device=card), mode="int8")
    xq = torch.randint(-128, 128, (m, k), generator=g, device=card,
                       dtype=torch.int32)
    y = da_vmm(xq, p)
    assert y.dtype == torch.int32 and y.device.type == "cuda"
    want = (xq.cpu().long() @ p.wq.cpu().long()).to(torch.int32)
    assert torch.equal(y.cpu(), want)
    # the weight operand is laid out once per pack and kept
    w8 = p.int8_operand
    assert w8 is not None and w8.shape[0] % 8 == 0 and w8.shape[1] % 8 == 0
    assert torch.equal(da_vmm(xq, p), y) and p.int8_operand is w8


@pytest.mark.parametrize("mode", ["lut", "onehot"])
@pytest.mark.parametrize("m", [1, 4, 16, 64])
def test_lut_modes_launch_the_lut_kernel(card, mode, m):
    """``lut`` and ``onehot`` on a CUDA tensor run the LUT-readout kernel
    (one call each) and EQUAL their plain forms on the same codes."""
    from repro_torch.core import da as core_da
    from repro_torch.core.engine import da_vmm, pack_weights
    from repro_torch.kernels.da_vmm import da_vmm_cuda

    g = torch.Generator(device=card).manual_seed(m)
    p = pack_weights(torch.randn(300, 70, generator=g, device=card), mode=mode)
    xq = torch.randint(-128, 128, (m, 300), generator=g, device=card,
                       dtype=torch.int32)
    before = da_vmm_cuda.launches
    y = da_vmm(xq, p)
    assert da_vmm_cuda.launches == before + 1
    plain = {"lut": core_da.da_vmm_lut, "onehot": core_da.da_vmm_onehot}[mode]
    assert torch.equal(y, plain(xq, p.luts, p.cfg))


def test_planned_serve_on_the_card(card, monkeypatch):
    """``ServeEngine(da_mode="auto")`` on the CI smoke's model plans the PMAs
    for every block matrix and stacked bit-planes for the LM head; its serve
    launches both VMM kernels, and its tokens EQUAL a serve of the same
    weights with both kernels swapped for their plain versions."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.core import engine
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.da_vmm import da_vmm_cuda
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get("qwen3-8b"), name="qwen3-20m", n_layers=4,
                              d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                              d_ff=768, vocab=8000, param_dtype="float32",
                              compute_dtype="float32")
    monkeypatch.setenv(engine.AUTOTUNE_ENV, "/nonexistent/engine_autotune.json")
    engine.set_cost_table(None)
    try:
        eng = ServeEngine(cfg, init_model(cfg, seed=0), batch_size=4, max_len=64,
                          da_mode="auto", paged_attn="fused")
    finally:
        engine.set_cost_table(None)
    plan = eng.artifact.plan
    assert {k: p.mode for k, p in plan.items()} == {
        k: ("bitplane_stacked" if k == "lm_head/w" else "lut") for k in plan}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 5 + 3 * u).astype(np.int32)
               for u in range(4)]

    def serve(params):
        e = ServeEngine(cfg, params, batch_size=4, max_len=64, paged_attn="fused")
        for u, pr in enumerate(prompts):
            e.submit(Request(uid=u, prompt=pr, max_new_tokens=8))
        before = bitplane_vmm_cuda.launches, da_vmm_cuda.launches
        done = e.run()
        return ({u: done[u].generated for u in done},
                (bitplane_vmm_cuda.launches - before[0],
                 da_vmm_cuda.launches - before[1]))

    kernels, launched = serve(eng.params)
    assert min(launched) > 0
    monkeypatch.setattr(ops, "da_vmm", ref.da_vmm_ref)
    monkeypatch.setattr(ops, "bitplane_vmm", ref.bitplane_vmm_ref)
    plain, none = serve(eng.params)
    assert none == (0, 0) and plain == kernels


@pytest.mark.parametrize("mode,e,c,k,n", [
    ("pallas_bitplane", 8, 4, 2048, 1408), ("bitplane_stacked", 8, 16, 1408, 2048),
    ("bitplane", 4, 4, 4096, 256), ("pallas_lut", 6, 4, 256, 512),
    ("lut", 6, 16, 256, 512), ("onehot", 5, 3, 100, 70)])
def test_stacked_expert_pack_equals_the_plain_loop(card, monkeypatch, mode, e, c,
                                                   k, n):
    """A stacked-expert pack [E, K, N] applied by ``dense`` to [G, E, C, K]
    activations: one call of the kernel's batched entry per pack (its
    groups' rows together) and none of the 2-D entry, the result EQUAL to
    the same call with the kernels swapped for their plain versions, and to
    a loop over the experts' 2-D packs."""
    from repro_torch.core.engine import dense, pack_weights
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitplane_vmm import (
        bitplane_vmm_cuda,
        bitplane_vmm_experts_cuda,
    )
    from repro_torch.kernels.da_vmm import da_vmm_cuda, da_vmm_experts_cuda

    g = torch.Generator(device=card).manual_seed(e + c + k)
    w = torch.randn((e, k, n), generator=g, device=card).to(torch.bfloat16)
    lut = mode in ("pallas_lut", "lut", "onehot")
    packed = pack_weights(w, mode=mode, with_luts=lut)
    x = torch.randn((2, e, c, k), generator=g, device=card).to(torch.bfloat16)
    batched, single = ((da_vmm_experts_cuda, da_vmm_cuda) if lut
                       else (bitplane_vmm_experts_cuda, bitplane_vmm_cuda))
    before = batched.launches, single.launches
    y = dense(x, packed)
    torch.cuda.synchronize()
    assert (batched.launches, single.launches) == (before[0] + 1, before[1])
    loop = torch.stack([dense(x[:, i], pe) for i, pe in
                        enumerate(packed.experts())], dim=1)
    assert torch.equal(y, loop)
    monkeypatch.setattr(ops, "da_vmm", ref.da_vmm_ref)
    monkeypatch.setattr(ops, "bitplane_vmm", ref.bitplane_vmm_ref)
    monkeypatch.setattr(ops, "da_vmm_experts", ref.da_vmm_experts_ref)
    monkeypatch.setattr(ops, "bitplane_vmm_experts", ref.bitplane_vmm_experts_ref)
    before = batched.launches, single.launches
    assert torch.equal(dense(x, packed), y)
    assert (batched.launches, single.launches) == before


@pytest.mark.parametrize("kernel,e,c,k,n", [
    ("bitplane", 64, 4, 2048, 1408), ("bitplane", 64, 16, 2048, 1408),
    ("bitplane", 64, 4, 1408, 2048), ("bitplane", 2, 4, 4096, 256),
    ("bitplane", 3, 33, 300, 70), ("lut", 6, 4, 256, 512), ("lut", 6, 16, 256, 512),
    ("lut", 5, 3, 100, 70), ("lut", 64, 4, 64, 1408)])
def test_batched_kernels_equal_the_e_launch_form(card, kernel, e, c, k, n):
    """The one-launch form of each VMM kernel over E experts EQUAL to E
    launches of its 2-D form and to the plain versions' loop: qwen2-moe's
    expert packs at C = 4 and 16 (no K split at decode, so one CUDA launch),
    a split stack (its memset zeroes every expert's output), ragged
    shapes, and N = 70 tables (the LUT kernel's one-column branch)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.bitplane_vmm import (
        bitplane_plan,
        bitplane_vmm_cuda,
        bitplane_vmm_experts_cuda,
    )
    from repro_torch.kernels.da_vmm import da_vmm_cuda, da_vmm_experts_cuda, lut_plan
    from repro_torch.kernels.ref import bitplane_vmm_experts_ref, da_vmm_experts_ref

    gen = torch.Generator(device=card).manual_seed(e * c + k + n)
    cfg = DAConfig(x_bits=8, x_signed=True)
    xq = torch.randint(-128, 128, (e, c, k), generator=gen, device=card,
                       dtype=torch.int32)
    wq = torch.randint(-127, 128, (e, k, n), generator=gen, device=card,
                       dtype=torch.int8)
    sms = build.sms(card.index or 0)
    if kernel == "lut":
        table = torch.stack([build_luts(wq[i], cfg.group_size) for i in range(e)])
        batched, single, plain = da_vmm_experts_cuda, da_vmm_cuda, da_vmm_experts_ref
        plan = lut_plan(c, n, table.shape[1], sms, e)
        splits = -(-table.shape[1] // plan.gpb)
    else:
        table = wq
        batched, single, plain = (bitplane_vmm_experts_cuda, bitplane_vmm_cuda,
                                  bitplane_vmm_experts_ref)
        splits = bitplane_plan(c, k, n, sms, e).splits
    if (kernel, e) == ("bitplane", 64):
        assert splits == 1  # the decode stack fills the card unsplit
    if (kernel, e, k) == ("bitplane", 2, 4096):
        assert splits > 1
    before = batched.launches, batched.cuda_launches
    got = batched(xq, table, cfg)
    torch.cuda.synchronize()
    assert (batched.launches, batched.cuda_launches) == (
        before[0] + 1, before[1] + _queued(splits))
    assert got.shape == (e, c, n) and got.dtype == torch.int32
    assert torch.equal(got, torch.stack([single(xq[i], table[i], cfg)
                                         for i in range(e)]))
    assert torch.equal(got, plain(xq, table, cfg))
    assert torch.equal(batched(xq, table, cfg), got)  # atomics: the same bits


def test_batched_bitplane_kernel_reads_an_expert_past_2_31(card):
    """An expert that starts 2^31 + 2^20 bytes into its stack (the weight
    stride as a strided view over one buffer): its offset does not fit
    int32, and the kernel reads it right.  A strided stack it cannot read
    (a column stride) raises rather than being copied."""
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_experts_cuda
    from repro_torch.kernels.ref import bitplane_vmm_experts_ref

    e, c, k, n, stride = 2, 4, 64, 128, (1 << 31) + (1 << 20)
    gen = torch.Generator(device=card).manual_seed(31)
    buf = torch.zeros(stride + k * n, dtype=torch.int8, device=card)
    wq = buf.as_strided((e, k, n), (stride, n, 1))
    wq.copy_(torch.randint(-127, 128, (e, k, n), generator=gen, device=card,
                           dtype=torch.int8))
    xq = torch.randint(-128, 128, (e, c, k), generator=gen, device=card,
                       dtype=torch.int32)
    cfg = DAConfig(x_bits=8, x_signed=True)
    got = bitplane_vmm_experts_cuda(xq, wq, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, bitplane_vmm_experts_ref(xq, wq, cfg))
    assert not torch.equal(got[0], got[1])
    with pytest.raises(ValueError, match="weight strides"):
        bitplane_vmm_experts_cuda(xq, buf[: e * k * n * 2].as_strided(
            (e, k, n), (2 * k * n, 2 * n, 2)), cfg)
    del buf, wq
    torch.cuda.empty_cache()


def test_mamba_slot_serve_on_the_card(card, monkeypatch):
    """A reduced mamba2-780m on the slot runtime, frozen on the card: each
    prompt prefills at its exact length, in_proj / out_proj / the LM head
    run the bit-plane kernel, no attention kernel is launched, and the
    tokens EQUAL the same serve with the kernel swapped for its plain
    version."""
    from repro_torch.configs.registry import get, reduce_for_smoke
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.mamba2 import MambaCache
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduce_for_smoke(get("mamba2-780m"))
    eng = ServeEngine(cfg, init_model(cfg, seed=0), batch_size=2, max_len=64,
                      da_mode="bitplane_stacked")
    params = eng.params
    rng = np.random.default_rng(4)
    prompts = {u: rng.integers(0, cfg.vocab, n).astype(np.int32)
               for u, n in enumerate((5, 19, 33, 12))}

    def serve():
        e = ServeEngine(cfg, params, batch_size=2, max_len=64)
        assert e.runtime == "slots" and isinstance(e.caches["pos_0"], MambaCache)
        for u, p in prompts.items():
            e.submit(Request(uid=u, prompt=p, max_new_tokens=8))
        before = bitplane_vmm_cuda.launches, paged_attention_cuda.launches
        done = e.run()
        assert e.metrics()["prefill_compiles"] == 4   # one per exact length
        return ({u: done[u].generated for u in done},
                (bitplane_vmm_cuda.launches - before[0],
                 paged_attention_cuda.launches - before[1]))

    kernels, launched = serve()
    assert launched[0] > 0 and launched[1] == 0
    monkeypatch.setattr(ops, "bitplane_vmm", ref.bitplane_vmm_ref)
    plain, none = serve()
    assert none == (0, 0) and plain == kernels


# ---------------------------------------------------------------------------
# the kernels as custom ops (kernels/ops.py), and a traced step on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["bitplane_vmm", "bitplane_vmm_experts", "da_vmm",
                                  "da_vmm_experts"])
def test_vmm_custom_op_equals_the_direct_kernel_call(card, name):
    """Each VMM op on CUDA is the kernel's launch: the same bits as the
    ``ctypes`` wrapper called directly, one launch counted per call."""
    from repro_torch.kernels import bitplane_vmm as bp
    from repro_torch.kernels import da_vmm as dv
    from repro_torch.kernels import ops

    g = torch.Generator(device=card).manual_seed(5)
    cfg = DAConfig(x_signed=True)
    lead = (3,) if name.endswith("experts") else ()
    xq = torch.randint(-128, 128, lead + (4, 300), generator=g, device=card,
                       dtype=torch.int32)
    wq = torch.randint(-128, 128, lead + (300, 264), generator=g, device=card,
                       dtype=torch.int8)
    if name.startswith("da_vmm"):
        w = (torch.stack([build_luts(x, 8) for x in wq]) if lead
             else build_luts(wq, 8)).contiguous()
    else:
        w = wq
    direct = {"bitplane_vmm": bp.bitplane_vmm_cuda,
              "bitplane_vmm_experts": bp.bitplane_vmm_experts_cuda,
              "da_vmm": dv.da_vmm_cuda, "da_vmm_experts": dv.da_vmm_experts_cuda}[name]
    want = direct(xq, w, cfg)
    before = direct.launches
    got = getattr(ops, name)(xq, w, cfg)
    torch.cuda.synchronize()
    assert direct.launches == before + 1
    assert torch.equal(got, want) and got.dtype == torch.int32
    with pytest.raises((TypeError, RuntimeError)):
        getattr(ops, name)(xq, w.to(torch.int16), cfg)


@pytest.mark.parametrize("fmt", ["fp", "int8", "int4"])
@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
def test_attention_custom_op_equals_the_direct_kernel_call(card, fmt, softmax):
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    g = torch.Generator(device=card).manual_seed(6)
    b, t, h, kv, hd, ps, w = 4, 1, 32, 8, 128, 16, 17
    q = torch.randn(b, t, h, hd, generator=g, device=card).to(torch.bfloat16)
    kp = torch.randn(1 + b * w, ps, kv, hd, generator=g, device=card).to(torch.bfloat16)
    vp = torch.randn(1 + b * w, ps, kv, hd, generator=g, device=card).to(torch.bfloat16)
    scales = {}
    if fmt != "fp":
        kp, scales["k_scale"] = kv_quant.quantize_kv(kp, fmt)
        vp, scales["v_scale"] = kv_quant.quantize_kv(vp, fmt)
    table = torch.arange(1, 1 + b * w, dtype=torch.int32, device=card).reshape(b, w)
    tpos = torch.tensor([[40], [3], [200], [255]], dtype=torch.int32, device=card)
    kw = dict(softmax_dtype=softmax, mask_mode="where", **scales)
    want = paged_attention_cuda(q, kp, vp, table, tpos, **kw)
    before = paged_attention_cuda.launches
    got = ops.paged_attention(q, kp, vp, table, tpos, **kw)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(paged_attention(q, kp, vp, table, tpos, **kw), want)


def test_traced_decode_step_holds_one_node_per_kernel_call(card):
    """qwen3-8b at full width and 2 layers, frozen with the bit-plane
    kernel: the decode step traced on the card holds one op node per kernel
    launch of a real decode step (5 VMMs a layer and the LM head; one
    attention read a layer), and the passes find nothing."""
    import dataclasses

    from repro_torch.analysis.graph import trace_serving_steps
    from repro_torch.analysis.passes import run_passes
    from repro_torch.configs.registry import get
    from repro_torch.core.freeze import freeze_model_da
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.model import init_model
    from repro_torch.serve.kvcache import init_paged_caches
    from repro_torch.spec.decode import make_paged_step

    cfg = dataclasses.replace(get("qwen3-8b"), n_layers=2, paged_attn="fused")
    frozen = freeze_model_da(init_model(cfg, seed=0, device=card),
                             mode="pallas_bitplane", device=card)
    steps = trace_serving_steps(frozen, cfg, batch_size=4, max_len=256, page_size=16,
                                prefill_chunk=1, backends=("fused",))
    caches = init_paged_caches(cfg, 1 + 4 * 16, 16, cfg.dtype(), device=card)
    z = torch.zeros((4, 1), dtype=torch.int32, device=card)
    before = bitplane_vmm_cuda.launches, paged_attention_cuda.launches
    with torch.inference_mode():
        make_paged_step(cfg)(frozen, caches, z, z,
                             torch.zeros((4, 17), dtype=torch.int32, device=card),
                             torch.zeros((4,), dtype=torch.int32, device=card))
    torch.cuda.synchronize()
    launched = {"bitplane_vmm": bitplane_vmm_cuda.launches - before[0],
                "paged_attention": paged_attention_cuda.launches - before[1]}
    assert launched == {"bitplane_vmm": 5 * cfg.n_layers + 1,
                        "paged_attention": cfg.n_layers}
    assert steps[0].name == "decode[fused]" and steps[0].op_counts() == launched
    assert run_passes(steps) == []


# the quickstart's CONV1 call and the LeNet layers' VMM shapes (M, K, N):
# unsigned 8-bit codes, K not a multiple of the group (25 = 3 * 8 + 1)
LENET_SHAPES = [(1, 25, 6), (784, 25, 6), (100, 150, 16), (1, 400, 120),
                (1, 120, 84), (1, 84, 10)]


@pytest.mark.parametrize("m,k,n", LENET_SHAPES)
def test_unsigned_codes_at_the_examples_shapes(card, m, k, n):
    """Both VMM kernels on unsigned codes at the examples' shapes, against
    their plain versions; and every eligible engine backend on a
    ``pack_quantized`` pack of int32 codes (the quickstart's), which the
    storage-free modes hand the bit-plane kernel as int8."""
    from repro_torch.core.engine import da_vmm, pack_quantized, registered_backends
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.da_vmm import da_vmm_cuda
    from repro_torch.kernels.ref import bitplane_vmm_ref, da_vmm_ref

    g = torch.Generator(device=card).manual_seed(m * k + n)
    xq = torch.randint(0, 256, (m, k), generator=g, device=card, dtype=torch.int32)
    w32 = torch.randint(-128, 128, (k, n), generator=g, device=card, dtype=torch.int32)
    cfg = DAConfig(group_size=8, x_bits=8, x_signed=False)
    exact = (xq.double() @ w32.double()).to(torch.int32)
    assert torch.equal(bitplane_vmm_cuda(xq, w32.to(torch.int8), cfg),
                       bitplane_vmm_ref(xq, w32, cfg))
    luts = build_luts(w32, 8)
    assert torch.equal(da_vmm_cuda(xq, luts, cfg), da_vmm_ref(xq, luts, cfg))
    packed = pack_quantized(w32, cfg=cfg)
    assert packed.wq.dtype == torch.int32
    seen = []
    for name, spec in sorted(registered_backends().items()):
        if spec.supports(cfg, packed.has_luts):
            before = bitplane_vmm_cuda.launches + da_vmm_cuda.launches
            assert torch.equal(da_vmm(xq, packed, mode=name), exact), name
            assert bitplane_vmm_cuda.launches + da_vmm_cuda.launches == before + 1
            seen.append(name)
    assert {"pallas_bitplane", "pallas_lut", "bitplane", "lut"} <= set(seen)


def test_train_step_on_the_card_matches_the_cpu(card):
    """Three train steps of a tiny float32 model at two microbatches on the
    card and on the CPU from the same params: loss and grad norm within
    1e-4 relative (TF32 off: float32 products on both)."""
    import dataclasses

    from repro_torch.configs.registry import get, reduce_for_smoke
    from repro_torch.data.pipeline import batch_at, for_model
    from repro_torch.train.trainer import (TrainConfig, init_state,
                                           make_train_step, state_from_params)
    from repro_torch.tree import tree_map

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(reduce_for_smoke(get("qwen3-8b")), remat=True)
        cpu = init_state(cfg, seed=0, device="cpu")
        dev = state_from_params(tree_map(lambda t: t.to(card, copy=True), cpu.params))
        step = make_train_step(cfg, TrainConfig(warmup_steps=1, total_steps=10,
                                                microbatches=2))
        dc = for_model(cfg, seq_len=32, global_batch=4, packed=True)
        for s in range(3):
            cpu, mc = step(cpu, batch_at(dc, s))
            dev, md = step(dev, batch_at(dc, s))
            for k in ("loss", "grad_norm", "lr"):
                a, b = float(mc[k]), float(md[k])
                assert abs(a - b) <= 1e-4 * abs(a), (s, k, a, b)
            assert float(md["skipped"]) == 0.0 and int(dev.step) == s + 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
