"""Card-only checks of the port's CUDA kernels against their plain versions.

Every test here needs an NVIDIA card (marker ``gpu``) and skips elsewhere;
the decision is made inside the ``cuda`` fixture. The file imports no JAX,
so it also runs on a machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.

Tolerances: O is held to the repo's forward gates (atol 5e-3, mean_atol
2e-4, mean_rtol 1e-2) and LSE to ``tests/test_flash_fwd.py``'s LSE gates,
comparing the kernel with the fp32 plain version on the same bf16/fp16
inputs, both cast to the input dtype. The attention kernels run at head dims
64, 128 and 256 (Gemma-2-9B's), whose instances tile differently: at d 256
the forward takes 64-row kv tiles, dq 64-row query blocks, dkv 64-key blocks
split between its consumers, and paged decode Q from shared memory. bf16 O takes the repo's bf16 gates
(``tests/test_flash_fwd.py:117``: 3 fewer mantissa bits than fp16); the
kernel rounds P to bf16 before P.V, as the TPU kernel did. The kv write must
match exactly. The backward kernels take the repo's backward gates: fp16
those of ``tests/test_flash_bwd.py:19`` (atol 5e-3, mean_atol 2e-4,
mean_rtol 1e-2), bf16 those of ``tests/test_flash_bwd.py:127`` (atol 4e-2,
mean_atol 2e-3, mean_rtol 2e-1); where a row attends to one key, dq and dk
must be exactly 0. The grouped-matmul kernels (gmm, gmm_dw) round one fp32
sum to the output dtype, as their plain versions do: fp16 takes the forward
gates and bf16 the bf16 backward gates, with outputs of unit scale; dead
blocks and experts with no rows must be exactly 0. The quantized matmul
(qmm) also rounds one fp32 sum, scaled per channel, once: the same gates,
with outputs of unit scale; repeats must be bit-identical.
"""

import math

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.ops import flash_bwd as bwd_mod
from flash_attention_tpu_torch.ops import flash_fwd as fwd_mod
from flash_attention_tpu_torch.ops import kv_update, moe as moe_mod
from flash_attention_tpu_torch.ops import paged_attention as pa_mod
from flash_attention_tpu_torch.ops import quant
from flash_attention_tpu_torch.ops.attention import bwd, flash_attention, fwd
from flash_attention_tpu_torch.ops.reference import reference_attention
from flash_attention_tpu_torch.utils.metrics import assert_metrics

FWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
BF16_TOLS = {"atol": 4e-2, "mean_atol": 2e-3, "mean_rtol": 5e-2}
LSE_TOLS = {"atol": 1e-2, "mean_atol": 1e-3, "mean_rtol": 1e-2}
BWD_TOLS = FWD_TOLS
BWD_BF16_TOLS = {"atol": 4e-2, "mean_atol": 2e-3, "mean_rtol": 2e-1}
# (b, sq, sk, h, hk). The forward kernel works in 128-row q and kv tiles:
# sq and sk on both sides of 128 and 256, lower-right offsets sk - sq that
# are not multiples of 128 (171, 2, -2), sq > sk with whole q tiles of dead
# rows (400 / 100), sq = 1 against several kv tiles (b 4, h 16: enough
# outputs that one element near 0 does not decide the mean-relative gate),
# GQA groups 1, 2, 4, 8.
FWD_SHAPES = [
    (1, 1, 1, 4, 4), (2, 64, 64, 4, 2), (2, 97, 130, 4, 1),
    (2, 130, 97, 4, 4), (1, 257, 513, 8, 2), (2, 1000, 1000, 8, 8),
    (1, 127, 127, 8, 1), (2, 128, 128, 4, 1), (1, 129, 129, 2, 1),
    (1, 255, 257, 4, 2), (2, 257, 255, 4, 4), (1, 129, 300, 8, 4),
    (1, 400, 100, 4, 2), (4, 1, 300, 16, 2), (2, 4096, 4096, 4, 2),
]
# The backward works in 64-row kv tiles under 128-row q blocks (dq) and in
# 64-row q tiles under 128-row key blocks (dkv): FWD_SHAPES, and sq and sk on
# both sides of 64 and of 192 (the second tile of a block), a kv block
# wholly past sq and one q tile of dead rows, GQA groups 1, 2, 4 and 8.
BWD_SHAPES = FWD_SHAPES + [
    (1, 63, 65, 8, 1), (2, 65, 63, 8, 2), (1, 191, 193, 4, 1),
    (1, 193, 191, 8, 8), (2, 64, 320, 4, 1), (1, 320, 64, 8, 2),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,hk", FWD_SHAPES)
def test_flash_fwd_matches_plain(cuda, dtype, d, causal, b, sq, sk, h, hk):
    rng = np.random.default_rng(sq * 7 + sk)
    q = _randn(rng, (b, sq, h, d), dtype, cuda)
    k = _randn(rng, (b, sk, hk, d), dtype, cuda)
    v = _randn(rng, (b, sk, hk, d), dtype, cuda)
    o, lse = fwd(q, k, v, causal)
    o_ref, lse_ref = reference_attention(q, k, v, causal=causal)
    tag = f"fwd[{dtype},{d},{causal},{b},{sq},{sk},{h},{hk}]"
    assert_metrics(tag, o, o_ref,
                   BF16_TOLS if dtype == torch.bfloat16 else FWD_TOLS)
    assert_metrics(tag + "lse", lse, lse_ref, LSE_TOLS)


@pytest.mark.gpu
def test_flash_fwd_strided_and_empty_rows(cuda):
    """q/k/v as views of one packed (b, s, 3, h, d) buffer, and causal with
    sq > sk: rows with no live key give O = 0 and LSE = empty_lse."""
    rng = np.random.default_rng(5)
    qkv = _randn(rng, (2, 150, 3, 4, 128), torch.bfloat16, cuda)
    q, k, v = qkv.unbind(2)
    o, lse = fwd(q, k[:, :100], v[:, :100], True, empty_lse=-3.0)
    o_ref, lse_ref = reference_attention(q, k[:, :100], v[:, :100],
                                         causal=True, empty_lse=-3.0)
    assert_metrics("fwd[strided]", o, o_ref, BF16_TOLS)
    assert_metrics("fwd[strided]lse", lse, lse_ref, LSE_TOLS)
    assert torch.all(o[:, :50] == 0) and torch.all(lse[:, :, :50] == -3.0)


@pytest.mark.gpu
def test_flash_fwd_head_major_views(cuda):
    """q/k/v as (b, s, h, d) views of (b, h, s, d) buffers: the head
    stride exceeds the sequence stride, and the kernel still reads through
    the strides."""
    rng = np.random.default_rng(6)
    q = _randn(rng, (2, 8, 300, 64), torch.float16, cuda).transpose(1, 2)
    k = _randn(rng, (2, 2, 300, 64), torch.float16, cuda).transpose(1, 2)
    v = _randn(rng, (2, 2, 300, 64), torch.float16, cuda).transpose(1, 2)
    o, lse = fwd(q, k, v, True)
    o_ref, lse_ref = reference_attention(q, k, v, causal=True)
    assert_metrics("fwd[head-major]", o, o_ref, FWD_TOLS)
    assert_metrics("fwd[head-major]lse", lse, lse_ref, LSE_TOLS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_fwd_repeats_bit_identical(cuda, dtype, d):
    """Two runs give the same bits: each row's sums run in a fixed order."""
    rng = np.random.default_rng(d)
    q = _randn(rng, (2, 700, 8, d), dtype, cuda)
    k = _randn(rng, (2, 900, 2, d), dtype, cuda)
    v = _randn(rng, (2, 900, 2, d), dtype, cuda)
    for causal in (False, True):
        first = fwd(q, k, v, causal)
        second = fwd(q, k, v, causal)
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1], second[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq,sk", [(300, 300), (300, 170), (1, 1), (200, 1)])
def test_flash_fwd_one_key_rows_equal_v(cuda, dtype, d, sq, sk):
    """A row that sees one key gets exactly that V row (p = exp2(0) = 1,
    l = 1), which the backward's dP - D = 0 relies on: causal row
    sq - sk sees only key 0; with sk = 1, every row non-causal."""
    rng = np.random.default_rng(sq + sk + d)
    h, hk = 8, 2
    q = _randn(rng, (2, sq, h, d), dtype, cuda)
    k = _randn(rng, (2, sk, hk, d), dtype, cuda)
    v = _randn(rng, (2, sk, hk, d), dtype, cuda)
    v0 = v[:, 0].repeat_interleave(h // hk, dim=1)  # (b, h, d)
    o, _ = fwd(q, k, v, True)
    assert torch.equal(o[:, sq - sk], v0)
    if sk == 1:
        o, _ = fwd(q, k, v, False)
        assert torch.equal(o, v0[:, None].expand_as(o))


@pytest.mark.gpu
def test_flash_fwd_counts_and_rejects(cuda):
    q = torch.zeros((1, 16, 2, 128), dtype=torch.bfloat16, device=cuda)
    before = fwd_mod.KERNEL.launches
    fwd(q, q, q, True)
    assert fwd_mod.KERNEL.launches == before + 1
    with pytest.raises(ValueError):
        fwd(q.float(), q.float(), q.float())
    q256 = torch.zeros((1, 16, 2, 256), dtype=torch.bfloat16, device=cuda)
    fwd(q256, q256, q256, softcap=30.0)  # d 256 launches as it is
    assert fwd_mod.KERNEL.launches == before + 2
    q512 = torch.zeros((1, 16, 2, 512), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="512"):
        fwd(q512, q512, q512, softcap=30.0)


def _paged_setup(rng, b, h, hk, d, ps, pps, total, L, dtype, device):
    q = _randn(rng, (b, h, d), dtype, device)
    kp = _randn(rng, (L, hk, total, ps, d), dtype, device)
    vp = _randn(rng, (L, hk, total, ps, d), dtype, device)
    tab = torch.from_numpy(rng.permutation(total)[:b * pps].reshape(b, pps)
                           .astype(np.int32)).to(device)
    return q, kp, vp, tab


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("ps", [16, 64])
def test_paged_attention_matches_plain(cuda, dtype, d, group, ps):
    rng = np.random.default_rng(group * 100 + ps)
    hk, pps, L = 2, 8, 3
    b = 5
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps,
                                  b * pps + 3, L, dtype, cuda)
    lens = torch.tensor([1, ps * pps, ps + 1, 0, 37], dtype=torch.int32,
                        device=cuda)
    o = pa_mod.paged_attention(q, kp, vp, lens, tab, layer=2)
    o_ref = pa_mod.paged_attention_reference(q, kp, vp, lens, tab, layer=2)
    assert_metrics(f"paged[{dtype},{d},{group},{ps}]", o, o_ref,
                   BF16_TOLS if dtype == torch.bfloat16 else FWD_TOLS)
    assert torch.all(o[3] == 0)


@pytest.mark.gpu
def test_paged_attention_long_rows(cuda):
    """Rows up to 4096 tokens in 64-token pages, table padded past need."""
    rng = np.random.default_rng(11)
    b, hk, group, d, ps, pps = 8, 8, 4, 128, 64, 72
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps, b * pps,
                                  2, torch.bfloat16, cuda)
    lens = torch.tensor([1, 63, 64, 65, 1000, 2048, 4095, 4096],
                        dtype=torch.int32, device=cuda)
    o = pa_mod.paged_attention(q, kp, vp, lens, tab, layer=1)
    o_ref = pa_mod.paged_attention_reference(q, kp, vp, lens, tab, layer=1)
    assert_metrics("paged[long]", o, o_ref, BF16_TOLS)


def _paged_check(label, q, kp, vp, lens, tab, layer):
    o = pa_mod.paged_attention(q, kp, vp, lens, tab, layer=layer)
    o_ref = pa_mod.paged_attention_reference(q, kp, vp, lens, tab,
                                             layer=layer)
    assert_metrics(label, o, o_ref,
                   BF16_TOLS if q.dtype == torch.bfloat16 else FWD_TOLS)
    return o


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("ps", [8, 32, 128])
def test_paged_attention_page_sizes(cuda, dtype, d, ps):
    """Pages of 8, 32 and 128 tokens: a tile of several pages, and a page
    of two tiles; rows of one token, a page edge, a tile edge, several
    chunks and a full table."""
    rng = np.random.default_rng(20 + ps)
    b, hk, group = 8, 4, 4
    pps = 2048 // ps
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps,
                                  b * pps + 5, 2, dtype, cuda)
    lens = torch.tensor([1, ps, ps + 1, 63, 64, 65, 1000, 2048],
                        dtype=torch.int32, device=cuda)
    o = _paged_check(f"paged[ps{ps},{dtype},{d}]", q, kp, vp, lens, tab, 1)
    assert torch.equal(o[0], vp[1][:, tab[0, 0].long(), 0]
                       .repeat_interleave(group, dim=0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_attention_full_rows(cuda, dtype, d):
    """Every row 4096 tokens long: every chunk of every pair is live and
    merged."""
    rng = np.random.default_rng(21)
    b, hk, group, ps, pps = 4, 4, 4, 64, 64
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps, b * pps,
                                  1, dtype, cuda)
    lens = torch.full((b,), ps * pps, dtype=torch.int32, device=cuda)
    _paged_check(f"paged[full,{dtype},{d}]", q, kp, vp, lens, tab, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("ps", [8, 64])
def test_paged_attention_length_one_rows_equal_v(cuda, dtype, d, ps):
    """Every row of length 1: O is the first token's V, bit for bit."""
    rng = np.random.default_rng(22)
    b, hk, group, pps = 6, 2, 4, 16
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps,
                                  b * pps, 2, dtype, cuda)
    lens = torch.ones((b,), dtype=torch.int32, device=cuda)
    o = pa_mod.paged_attention(q, kp, vp, lens, tab, layer=1)
    v0 = vp[1][:, tab[:, 0].long(), 0]  # (hk, b, d)
    want = v0.permute(1, 0, 2).repeat_interleave(group, dim=1)
    assert torch.equal(o, want)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [16, 64, 128])
def test_paged_attention_chunk_boundaries(cuda, ps):
    """Lengths on a chunk boundary of the wrapper's plan, one before and one
    past it, and on a tile boundary inside a chunk."""
    rng = np.random.default_rng(23)
    b, hk, group, d = 7, 2, 4, 128
    pps = 4096 // ps
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk_tiles, n_chunks = pa_mod.plan(pps, ps, b, hk, n_sms)
    assert n_chunks > 2
    c = chunk_tiles * pa_mod.TILE
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps,
                                  b * pps, 1, torch.bfloat16, cuda)
    lens = torch.tensor([c, c + 1, c - 1, 2 * c, 2 * c + 1, 65, 64],
                        dtype=torch.int32, device=cuda)
    _paged_check(f"paged[chunks,{ps}]", q, kp, vp, lens, tab, 0)


@pytest.mark.gpu
def test_paged_attention_wide_table_and_clamped_lengths(cuda):
    """A table wider than the rows need (padded with valid pages), and
    lengths past its width, which count as the full width."""
    rng = np.random.default_rng(24)
    b, hk, group, d, ps, pps = 4, 2, 4, 128, 16, 40
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps,
                                  b * pps, 1, torch.bfloat16, cuda)
    lens = torch.tensor([100, ps * pps + 1, 10**6, 33], dtype=torch.int32,
                        device=cuda)
    o = _paged_check("paged[wide]", q, kp, vp, lens, tab, 0)
    full = torch.full_like(lens, ps * pps)
    assert torch.equal(o[1:3], pa_mod.paged_attention(
        q, kp, vp, full, tab, layer=0)[1:3])


@pytest.mark.gpu
def test_paged_attention_rows_share_the_trash_page(cuda):
    """Padding rows whose whole table is the trash page, beside live rows
    that also end on it, and a zero-length row."""
    rng = np.random.default_rng(25)
    b, hk, group, d, ps, pps, total = 6, 2, 4, 128, 64, 8, 64
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps, total,
                                  1, torch.bfloat16, cuda)
    trash = total - 1
    tab[3:] = trash
    tab[0, 5:] = trash
    lens = torch.tensor([300, 512, 77, 1, 64, 0], dtype=torch.int32,
                        device=cuda)
    o = _paged_check("paged[trash]", q, kp, vp, lens, tab, 0)
    assert torch.all(o[5] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [24, 12])
def test_paged_attention_page_sizes_not_powers_of_two(cuda, ps):
    """Pages loaded in boxes of the largest power of two dividing the page
    size (8 and 4 rows)."""
    rng = np.random.default_rng(26)
    b, hk, group, d, pps = 4, 2, 4, 128, 80
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps, b * pps,
                                  2, torch.bfloat16, cuda)
    lens = torch.tensor([ps * pps, 1000, ps + 5, 3], dtype=torch.int32,
                        device=cuda)
    _paged_check(f"paged[ps{ps}]", q, kp, vp, lens, tab, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_attention_repeats_bit_identical(cuda, dtype, d):
    rng = np.random.default_rng(27)
    b, hk, group, ps, pps = 8, 8, 4, 64, 64
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps, b * pps,
                                  1, dtype, cuda)
    lens = torch.from_numpy(np.linspace(1, 4096, b).astype(np.int32)).to(cuda)
    o = pa_mod.paged_attention(q, kp, vp, lens, tab, layer=0)
    for _ in range(5):
        assert torch.equal(o, pa_mod.paged_attention(q, kp, vp, lens, tab,
                                                     layer=0))


@pytest.mark.gpu
def test_paged_attention_in_cuda_graph_with_new_lengths(cuda):
    """A call captured in a CUDA graph and replayed after new lengths (and
    a new query) are copied in equals the eager call bit for bit."""
    rng = np.random.default_rng(28)
    b, hk, group, d, ps, pps = 8, 8, 4, 128, 64, 64
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps, b * pps,
                                  2, torch.bfloat16, cuda)
    lens = torch.from_numpy(np.linspace(1, 4096, b).astype(np.int32)).to(cuda)
    pa_mod.paged_attention(q, kp, vp, lens, tab, layer=1)  # outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o = pa_mod.paged_attention(q, kp, vp, lens, tab, layer=1)
    for new in ([1778, 1367, 1125, 662, 735, 222, 288, 175],
                [4096, 0, 1, 63, 64, 65, 2000, 3000]):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        q.copy_(_randn(rng, q.shape, q.dtype, cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(o, pa_mod.paged_attention(q, kp, vp, lens, tab,
                                                     layer=1))
        assert_metrics("paged[graph]", o, pa_mod.paged_attention_reference(
            q, kp, vp, lens, tab, layer=1), BF16_TOLS)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_paged_attention_misaligned_q_is_copied(cuda, d):
    """A contiguous q whose data is not 16-byte aligned (a view at an odd
    element offset) gives the same output as an aligned copy."""
    rng = np.random.default_rng(d)
    q, kp, vp, tab = _paged_setup(rng, 2, 8, 2, d, 16, 4, 8, 1,
                                  torch.bfloat16, cuda)
    lens = torch.tensor([40, 64], dtype=torch.int32, device=cuda)
    base = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = base[1:].view(q.shape).copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    want = pa_mod.paged_attention(q, kp, vp, lens, tab, layer=0)
    got = pa_mod.paged_attention(shifted, kp, vp, lens, tab, layer=0)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_paged_attention_counts_one_launch_per_call(cuda):
    rng = np.random.default_rng(29)
    q, kp, vp, tab = _paged_setup(rng, 2, 8, 2, 128, 64, 64, 128, 1,
                                  torch.bfloat16, cuda)
    for lens in ([4096, 4096], [1, 0], [0, 0]):
        before = pa_mod.KERNEL.launches
        pa_mod.paged_attention(q, kp, vp, torch.tensor(
            lens, dtype=torch.int32, device=cuda), tab, layer=0)
        assert pa_mod.KERNEL.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_write_matches_plain(cuda, dtype):
    """Exact match everywhere but the trash page (rows 3 and 4 share it)."""
    rng = np.random.default_rng(3)
    L, hk, total, ps, d, b = 4, 2, 16, 16, 128, 5
    kp = _randn(rng, (L, hk, total, ps, d), dtype, cuda)
    vp = _randn(rng, (L, hk, total, ps, d), dtype, cuda)
    kval = _randn(rng, (b, hk, d), dtype, cuda)
    vval = _randn(rng, (b, hk, d), dtype, cuda)
    trash = 15
    wpage = torch.tensor([2, 7, 2, trash, trash], dtype=torch.int32, device=cuda)
    woff = torch.tensor([0, 15, 9, 0, 0], dtype=torch.int32, device=cuda)
    kref, vref = kp.clone(), vp.clone()
    kv_update.write_token_kv_reference(kref, vref, kval, vval, wpage, woff,
                                       layer=3)
    before = kv_update.KERNEL.launches
    out = kv_update.write_token_kv(kp, vp, None, None, kval, vval, None, None,
                                   wpage, woff, layer=3)
    assert out[0] is kp and out[1] is vp
    assert kv_update.KERNEL.launches == before + 1
    keep = torch.ones(total, dtype=torch.bool, device=cuda)
    keep[trash] = False
    assert torch.equal(kp[:, :, keep], kref[:, :, keep])
    assert torch.equal(vp[:, :, keep], vref[:, :, keep])
    assert torch.equal(kp[3, :, 2, 9], kval[2])


@pytest.mark.gpu
def test_paged_scale_matches_kernel_contract(cuda):
    """The wrapper passes scale * log2(e); a custom sm_scale must agree."""
    rng = np.random.default_rng(2)
    q, kp, vp, tab = _paged_setup(rng, 2, 8, 2, 128, 16, 4, 8, 1,
                                  torch.bfloat16, cuda)
    lens = torch.tensor([40, 64], dtype=torch.int32, device=cuda)
    scale = 0.3 / math.sqrt(128)
    o = pa_mod.paged_attention(q, kp, vp, lens, tab, layer=0, sm_scale=scale)
    o_ref = pa_mod.paged_attention_reference(q, kp, vp, lens, tab, layer=0,
                                             sm_scale=scale)
    assert_metrics("paged[scale]", o, o_ref, BF16_TOLS)


def _bwd_inputs(seed, b, sq, sk, h, hk, d, dtype, device, causal):
    """q, k, v, do from a numpy seed; o and lse from the forward kernel."""
    rng = np.random.default_rng(seed)
    q = _randn(rng, (b, sq, h, d), dtype, device)
    k = _randn(rng, (b, sk, hk, d), dtype, device)
    v = _randn(rng, (b, sk, hk, d), dtype, device)
    do = _randn(rng, (b, sq, h, d), dtype, device)
    o, lse = fwd(q, k, v, causal)
    return q, k, v, o, lse, do


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,hk", BWD_SHAPES)
def test_flash_bwd_matches_plain(cuda, dtype, d, causal, b, sq, sk, h, hk):
    """Each backward kernel against its plain version on the same inputs:
    D, then dq and dk/dv, each from its own chain's D (the kernels' fp32 D
    summed as dP is, the plain versions' float64 D)."""
    q, k, v, o, lse, do = _bwd_inputs(sq * 7 + sk + 1, b, sq, sk, h, hk, d,
                                      dtype, cuda, causal)
    scale = d**-0.5
    tols = BWD_BF16_TOLS if dtype == torch.bfloat16 else BWD_TOLS
    tag = f"[{dtype},{d},{causal},{b},{sq},{sk},{h},{hk}]"
    di = bwd_mod.flash_bwd_di(o, do)
    di_r = bwd_mod.di_reference(o, do)
    assert_metrics("di" + tag, di, di_r, LSE_TOLS)
    kw = dict(causal=causal, sm_scale=scale)
    dq = bwd_mod.flash_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = bwd_mod.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    dq_r = bwd_mod.dq_reference(q, k, v, do, lse, di_r, **kw)
    dk_r, dv_r = bwd_mod.dkv_reference(q, k, v, do, lse, di_r, **kw)
    assert_metrics("dq" + tag, dq, dq_r, tols)
    assert_metrics("dk" + tag, dk, dk_r, tols)
    assert_metrics("dv" + tag, dv, dv_r, tols)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,hk", BWD_SHAPES)
def test_flash_bwd_d256_matches_plain(cuda, dtype, causal, b, sq, sk, h, hk):
    """test_flash_bwd_matches_plain at d 256 (the split dkv, the
    one-consumer dq), with the gates' atol no tighter than one ulp of each
    output at its largest magnitude (_ulp_tols, as the band cases): under
    causal GQA the first keys sum dV over every row of the group with
    weights near 1 and reach 8 to 16, where kernel and plain version, each
    rounding one sum to the output dtype, may differ by that ulp."""
    d = 256
    q, k, v, o, lse, do = _bwd_inputs(sq * 7 + sk + 1, b, sq, sk, h, hk, d,
                                      dtype, cuda, causal)
    tols = BWD_BF16_TOLS if dtype == torch.bfloat16 else BWD_TOLS
    tag = f"[{dtype},{d},{causal},{b},{sq},{sk},{h},{hk}]"
    di = bwd_mod.flash_bwd_di(o, do)
    di_r = bwd_mod.di_reference(o, do)
    assert_metrics("di" + tag, di, di_r, LSE_TOLS)
    kw = dict(causal=causal, sm_scale=d**-0.5)
    dq = bwd_mod.flash_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = bwd_mod.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    dq_r = bwd_mod.dq_reference(q, k, v, do, lse, di_r, **kw)
    dk_r, dv_r = bwd_mod.dkv_reference(q, k, v, do, lse, di_r, **kw)
    for name, x, ref in (("dq", dq, dq_r), ("dk", dk, dk_r), ("dv", dv, dv_r)):
        assert_metrics(name + tag, x, ref, _ulp_tols(tols, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq", [1, 64, 130])
def test_flash_bwd_single_key_is_exactly_zero(cuda, dtype, d, causal, sq):
    """sk = 1: every live row attends to its one key, so O equals that V row
    and dP - D must cancel bit for bit; dq and dk are exactly 0 (dead rows
    of causal sq > sk too), and dv is the plain version's."""
    q, k, v, o, lse, do = _bwd_inputs(sq, 2, sq, 1, 8, 2, d, dtype, cuda,
                                      causal)
    dq, dk, dv = bwd(q, k, v, o, lse, do, causal)
    assert torch.all(dq == 0) and torch.all(dk == 0)
    _, _, dv_r = bwd_mod.flash_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal,
                                             sm_scale=d**-0.5)
    assert_metrics("dv[sk=1]", dv, dv_r,
                   BWD_BF16_TOLS if dtype == torch.bfloat16 else BWD_TOLS)


@pytest.mark.gpu
def test_flash_bwd_deterministic_and_dead_rows(cuda):
    """Two runs are bit-identical (no atomics), and causal sq > sk rows with
    no live key get dq = 0."""
    q, k, v, o, lse, do = _bwd_inputs(4, 1, 200, 64, 4, 2, 64,
                                      torch.bfloat16, cuda, True)
    first = bwd(q, k, v, o, lse, do, True)
    second = bwd(q, k, v, o, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.all(first[0][:, :136] == 0)
    want = bwd_mod.flash_bwd_reference(q, k, v, o, lse, do, causal=True,
                                       sm_scale=64**-0.5)
    for name, got, ref in zip(("dq", "dk", "dv"), first, want):
        assert_metrics(f"{name}[dead rows]", got, ref, BWD_BF16_TOLS)


@pytest.mark.gpu
def test_flash_bwd_strided_inputs(cuda):
    """q/k/v as views of one packed (b, s, 3, h, d) buffer and a strided
    do: the kernels read through the strides."""
    rng = np.random.default_rng(8)
    qkv = _randn(rng, (2, 150, 3, 4, 128), torch.bfloat16, cuda)
    q, k, v = qkv.unbind(2)
    do = _randn(rng, (2, 4, 150, 128), torch.bfloat16, cuda).transpose(1, 2)
    o, lse = fwd(q, k, v, True)
    got = bwd(q, k, v, o, lse, do, True)
    want = bwd_mod.flash_bwd_reference(q, k, v, o, lse, do, causal=True,
                                       sm_scale=128**-0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_metrics(f"{name}[strided]", a, b, BWD_BF16_TOLS)


def _offset_by_one(x):
    """A copy of x whose data starts one element into its storage: 2 bytes
    past a 16-byte boundary, which TMA cannot read in place."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape).copy_(x)
    assert y.data_ptr() % 16
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["fwd", "bwd"])
def test_misaligned_inputs_are_copied(cuda, what):
    """Inputs one element into their storage, and a sequence stride that is
    not a multiple of 8 (a d-64 slice of d-65 rows), run: the wrappers copy
    them into fresh tensors (counted launches) and match the plain
    versions."""
    q, k, v, o, lse, do = _bwd_inputs(31, 2, 150, 170, 4, 2, 64,
                                      torch.bfloat16, cuda, True)
    rng = np.random.default_rng(32)
    wide = _randn(rng, (2, 170, 2, 65), torch.bfloat16, cuda)
    wide[..., :64] = k
    k_odd = wide[..., :64]  # seq stride 130, head stride 65
    assert k_odd.stride(1) % 8 and torch.equal(k_odd, k)
    q1, v1, do1 = map(_offset_by_one, (q, v, do))
    if what == "fwd":
        before = fwd_mod.KERNEL.launches
        got = fwd(q1, k_odd, v1, True)
        assert fwd_mod.KERNEL.launches == before + 1
        want = reference_attention(q, k, v, causal=True)
        assert_metrics("o[misaligned]", got[0], want[0], BF16_TOLS)
        assert_metrics("lse[misaligned]", got[1], want[1], LSE_TOLS)
        return
    o1 = _offset_by_one(o)
    before = [kern.launches for kern in bwd_mod.KERNELS]
    got = bwd(q1, k_odd, v1, o1, lse, do1, True)
    assert [kern.launches for kern in bwd_mod.KERNELS] == [
        n + 1 for n in before]
    want = bwd_mod.flash_bwd_reference(q, k, v, o, lse, do, causal=True,
                                       sm_scale=64**-0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_metrics(f"{name}[misaligned]", a, b, BWD_BF16_TOLS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_96_runs_padded(cuda, dtype, causal):
    """d 96 runs the d-128 kernels on zero-padded copies: O, LSE and the
    gradients match the plain versions at d 96 (scale 96^-0.5)."""
    q, k, v, _, _, do = _bwd_inputs(96, 2, 200, 180, 8, 2, 128, dtype, cuda,
                                    causal)
    q, k, v, do = (x[..., :96].contiguous() for x in (q, k, v, do))
    o, lse = fwd(q, k, v, causal)
    o_ref, lse_ref = reference_attention(q, k, v, causal=causal)
    assert o.shape == q.shape
    tols = BWD_BF16_TOLS if dtype == torch.bfloat16 else BWD_TOLS
    assert_metrics("o[d96]", o, o_ref,
                   BF16_TOLS if dtype == torch.bfloat16 else FWD_TOLS)
    assert_metrics("lse[d96]", lse, lse_ref, LSE_TOLS)
    got = bwd(q, k, v, o, lse, do, causal)
    want = bwd_mod.flash_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                       sm_scale=96**-0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        assert_metrics(f"{name}[d96]", a, b, tols)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_cuda_match_cpu(cuda, causal):
    """Autograd through flash_attention: the kernels (bf16, card) against
    the plain versions (fp32, CPU) on the same bf16-rounded inputs."""
    rng = np.random.default_rng(21)
    q, k, v, do = (_randn(rng, shape, torch.bfloat16, cuda) for shape in (
        (2, 300, 8, 128), (2, 300, 2, 128), (2, 300, 2, 128),
        (2, 300, 8, 128)))
    grads = []
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.float32)):
        leaves = [x.detach().to(dev, dtype).requires_grad_()
                  for x in (q, k, v)]
        o = flash_attention(*leaves, causal=causal)
        o.backward(do.to(dev, dtype))
        grads.append([x.grad for x in leaves])
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        assert a.dtype == torch.bfloat16 and a.is_cuda
        assert_metrics(f"{name}[autograd]", a, b, BWD_BF16_TOLS)


@pytest.mark.gpu
def test_flash_bwd_counts_and_rejects(cuda):
    q = torch.zeros((1, 16, 2, 128), dtype=torch.bfloat16, device=cuda)
    o, lse = fwd(q, q, q, True)
    before = [kern.launches for kern in bwd_mod.KERNELS]
    bwd(q, q, q, o, lse, q, True)
    assert [kern.launches for kern in bwd_mod.KERNELS] == [
        n + 1 for n in before]
    assert bwd(q, q, q, o, lse, q, True, parts="di").shape == (1, 2, 16)
    assert bwd(q, q, q, o, lse, q, True, parts="dq").shape == q.shape
    q256 = torch.zeros((1, 16, 2, 256), dtype=torch.bfloat16, device=cuda)
    o256 = torch.zeros_like(q256)
    before = [kern.launches for kern in bwd_mod.KERNELS]
    bwd(q256, q256, q256, o256, lse, q256, True, softcap=30.0)
    bwd(q256, q256, q256, o256, lse, q256, True, window_size=(8, 0))
    assert [kern.launches for kern in bwd_mod.KERNELS] == [
        n + 2 for n in before]  # d 256 launches as it is
    q512 = torch.zeros((1, 16, 2, 512), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="512"):
        bwd(q512, q512, q512, q512, lse, q512, True, softcap=30.0)
    with pytest.raises(ValueError):
        bwd_mod.flash_bwd_di(o.cpu(), q.cpu())


# --------------------------------------------------- window and softcap
# The band of relative offsets (left, right) and the softcap in the forward
# and both backward kernels, against the plain versions under the same gates:
# a left edge only (causal and not), a right edge only, two-sided
# non-causal bands with sq != sk, rows the band leaves without a key (O = 0,
# LSE = empty_lse, dq = 0), the softcap alone and with a band. The inputs
# and dO are unit normal, so the scores scale * q.k are about N(0, 1): the
# caps (2 to 5) are small enough to bind there (at Gemma-2's 50 a kernel
# without the cap would pass every gate), and each softcap case checks that
# the gates catch the no-softcap instances and a backward without the
# factor 1 - t^2. The gradients' atol is at least one ulp of the output at
# its largest magnitude (_ulp_tols): a key near the start of a causal band
# sums dV over rows with weights near 1, and reaches 8 to 16, where one
# fp16 ulp (2^-7) exceeds the fp16 atol.
BAND_CASES = {
    "left-causal": (True, (63, 0), None, 2, 300, 300, 4, 2),
    "left-causal-long": (True, (255, 0), None, 1, 1000, 1000, 8, 2),
    "left-causal-sq>sk": (True, (100, 0), None, 1, 400, 250, 4, 1),
    "left-only": (False, (50, -1), None, 2, 260, 330, 4, 2),
    "right-only": (False, (-1, 30), None, 1, 330, 260, 8, 8),
    "two-sided": (False, (128, 64), None, 2, 700, 500, 8, 2),
    "two-sided-sq<sk": (False, (70, 10), None, 1, 190, 420, 4, 4),
    "empty-rows": (False, (20, 5), None, 1, 300, 100, 4, 2),
    "softcap-causal": (True, None, 2.0, 2, 500, 500, 8, 2),
    "softcap-dense": (False, None, 5.0, 2, 257, 300, 4, 4),
    "softcap-left-causal": (True, (127, 0), 3.0, 2, 600, 600, 8, 2),
    "softcap-two-sided": (False, (64, 200), 2.0, 1, 300, 450, 4, 1),
}


def _ulp_tols(tols, ref):
    """``tols`` with atol no tighter than one ulp of ``ref``'s dtype at its
    largest magnitude: kernel and plain version each round an fp32 sum to
    that dtype once, so they may differ by one ulp there."""
    top = float(ref.abs().max())
    if top == 0:
        return tols
    ulp = torch.finfo(ref.dtype).eps * 2.0 ** math.floor(math.log2(top))
    return {**tols, "atol": max(tols["atol"], ulp)}


def _straight_through_grads(q, k, v, do, *, causal, sm_scale, window,
                            softcap):
    """fp32 dq, dk, dv of the capped attention without the softcap's
    chain-rule factor 1 - t^2, as a backward that drops it would give:
    autograd through the plain forward with the tanh passed straight
    through."""
    from flash_attention_tpu_torch.ops.reference import _build_mask
    g = q.shape[2] // k.shape[2]
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    with torch.enable_grad():
        kt = kf.repeat_interleave(g, 2).transpose(1, 2)
        vt = vf.repeat_interleave(g, 2).transpose(1, 2)
        s = qf.transpose(1, 2) @ kt.transpose(-1, -2) * sm_scale
        s = s + (softcap * torch.tanh(s / softcap) - s).detach()
        mask = _build_mask(q.shape[1], k.shape[1], causal, window,
                           device=q.device)
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        o = (torch.softmax(s, -1) @ vt).transpose(1, 2)
        return torch.autograd.grad(o, (qf, kf, vf), do.float())


def _band_empty_rows(sq, sk, causal, window):
    """Rows the band gives no live key (the plain version's mask)."""
    from flash_attention_tpu_torch.ops.reference import _build_mask
    mask = _build_mask(sq, sk, causal, window)
    return ~mask.any(-1) if mask is not None else torch.zeros(sq, dtype=bool)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_flash_band_and_softcap_match_plain(cuda, dtype, d, case):
    causal, window, cap, b, sq, sk, h, hk = BAND_CASES[case]
    rng = np.random.default_rng(sq + sk + d)
    q = _randn(rng, (b, sq, h, d), dtype, cuda)
    k = _randn(rng, (b, sk, hk, d), dtype, cuda)
    v = _randn(rng, (b, sk, hk, d), dtype, cuda)
    do = _randn(rng, (b, sq, h, d), dtype, cuda)
    kw = dict(window_size=window, softcap=cap)
    o, lse = fwd(q, k, v, causal, empty_lse=-2.0, **kw)
    o_ref, lse_ref = reference_attention(q, k, v, causal=causal,
                                         window=window, softcap=cap,
                                         empty_lse=-2.0)
    tag = f"[{case},{dtype},{d}]"
    assert_metrics("fwd" + tag, o, o_ref,
                   BF16_TOLS if dtype == torch.bfloat16 else FWD_TOLS)
    assert_metrics("fwd lse" + tag, lse, lse_ref, LSE_TOLS)
    empty = _band_empty_rows(sq, sk, causal, window).to(cuda)
    assert bool(empty.any()) or case != "empty-rows"
    assert torch.all(o[:, empty] == 0) and torch.all(lse[:, :, empty] == -2.0)

    scale = d**-0.5
    bkw = dict(causal=causal, sm_scale=scale, window=window, softcap=cap)
    di = bwd_mod.flash_bwd_di(o, do)
    di_r = bwd_mod.di_reference(o, do)
    dq = bwd_mod.flash_bwd_dq(q, k, v, do, lse, di, **bkw)
    dk, dv = bwd_mod.flash_bwd_dkv(q, k, v, do, lse, di, **bkw)
    dq_r = bwd_mod.dq_reference(q, k, v, do, lse, di_r, **bkw)
    dk_r, dv_r = bwd_mod.dkv_reference(q, k, v, do, lse, di_r, **bkw)
    tols = BWD_BF16_TOLS if dtype == torch.bfloat16 else BWD_TOLS
    assert_metrics("dq" + tag, dq, dq_r, _ulp_tols(tols, dq_r))
    assert_metrics("dk" + tag, dk, dk_r, _ulp_tols(tols, dk_r))
    assert_metrics("dv" + tag, dv, dv_r, _ulp_tols(tols, dv_r))
    assert torch.all(dq[:, empty] == 0)
    again = bwd(q, k, v, o, lse, do, causal, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, (dq, dk, dv)))
    if cap is None:
        return
    # the same gates catch the no-softcap instances and a backward that
    # drops the factor 1 - t^2 (dV does not depend on it)
    nocap = {**bkw, "softcap": None}
    o0, lse0 = fwd(q, k, v, causal, empty_lse=-2.0, window_size=window)
    di0 = bwd_mod.flash_bwd_di(o0, do)
    dk0, dv0 = bwd_mod.flash_bwd_dkv(q, k, v, do, lse0, di0, **nocap)
    st = _straight_through_grads(q, k, v, do, **bkw)
    wrong = [("no-cap lse", lse0, lse_ref, LSE_TOLS),
             ("no-cap dq", bwd_mod.flash_bwd_dq(q, k, v, do, lse0, di0,
                                                **nocap), dq_r, None),
             ("no-cap dk", dk0, dk_r, None), ("no-cap dv", dv0, dv_r, None),
             ("no-factor dq", st[0].to(dtype), dq_r, None),
             ("no-factor dk", st[1].to(dtype), dk_r, None)]
    for name, x, ref, t in wrong:
        with pytest.raises(AssertionError):
            assert_metrics(name + tag, x, ref, t or _ulp_tols(tols, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_band_covering_every_key_is_bit_identical(cuda, dtype, causal):
    """A band wider than the sequences loads the same tiles and masks the
    same entries as no band: the forward's and the backward's outputs are
    the same bits as the call without a window."""
    q, k, v, o, lse, do = _bwd_inputs(3, 2, 700, 600, 8, 2, 128, dtype,
                                      cuda, causal)
    wide = (2000, 0 if causal else 2000)
    o2, lse2 = fwd(q, k, v, causal, window_size=wide)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    plain = bwd(q, k, v, o, lse, do, causal)
    banded = bwd(q, k, v, o, lse, do, causal, window_size=wide)
    assert all(torch.equal(a, b_) for a, b_ in zip(plain, banded))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("ps", [8, 64, 128])
@pytest.mark.parametrize("window,cap", [(100, None), (1000, None),
                                        (1000, 5.0), (None, 5.0)])
def test_paged_window_softcap_and_holes(cuda, dtype, d, ps, window, cap):
    """The window and the softcap against the plain version on the real
    pages. In the kernel's table, the entries of pages wholly behind a row's
    window are holes (-1), and every page no row reads is NaN: the kernel
    must never read them (a hole is never turned into a TMA coordinate).
    The cap binds at these unit-scale scores: the no-softcap instance fails
    the gate."""
    rng = np.random.default_rng(ps + (window or 0))
    b, hk, group = 8, 4, 4
    pps = 4096 // ps
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps,
                                  b * pps + 5, 2, dtype, cuda)
    w = window or 10**9
    lens = [1, 99, 100, 101, 1000, 2049, 3000, 4096]
    o_ref = pa_mod.paged_attention_reference(
        q, kp, vp, torch.tensor(lens, dtype=torch.int32, device=cuda), tab,
        window=window, softcap=cap, layer=1)
    holed = tab.clone()
    read = torch.zeros(kp.shape[2], dtype=torch.bool, device=cuda)
    for i, n in enumerate(lens):
        first = max(n - w, 0) // ps  # the first page the window reads
        holed[i, :first] = -1
        read[tab[i, first:-(-n // ps)].long()] = True
    assert bool((holed < 0).any()) == (window is not None)
    kp[:, :, ~read] = float("nan")
    vp[:, :, ~read] = float("nan")
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    o = pa_mod.paged_attention(q, kp, vp, lengths, holed, window=window,
                               softcap=cap, layer=1)
    assert_metrics(f"paged[w{window},cap{cap},ps{ps},{dtype}]", o, o_ref,
                   BF16_TOLS if dtype == torch.bfloat16 else FWD_TOLS)
    again = pa_mod.paged_attention(q, kp, vp, lengths, holed, window=window,
                                   softcap=cap, layer=1)
    assert torch.equal(o, again)
    if cap is not None:
        o0 = pa_mod.paged_attention(q, kp, vp, lengths, holed, window=window,
                                    layer=1)
        with pytest.raises(AssertionError):
            assert_metrics("no-cap paged", o0, o_ref,
                           BF16_TOLS if dtype == torch.bfloat16 else FWD_TOLS)


@pytest.mark.gpu
def test_paged_window_covering_every_key_is_bit_identical(cuda):
    """A window as long as the table reads what no window reads, in the
    same chunks: the same bits."""
    rng = np.random.default_rng(3)
    b, hk, group, d, ps, pps = 8, 4, 4, 128, 64, 64
    q, kp, vp, tab = _paged_setup(rng, b, hk * group, hk, d, ps, pps,
                                  b * pps, 2, torch.bfloat16, cuda)
    lengths = torch.tensor([1, 63, 64, 65, 1000, 2048, 3000, 4096],
                           dtype=torch.int32, device=cuda)
    o = pa_mod.paged_attention(q, kp, vp, lengths, tab, layer=0)
    o2 = pa_mod.paged_attention(q, kp, vp, lengths, tab, window=4096,
                                layer=0)
    assert torch.equal(o, o2)


# ------------------------------------------------------ the quantized cache
# int8 and fp8 e4m3 pages of 128 tokens with per-token scales in (L, hk, P,
# 8, 128) fp32 tiles (ops.quant.quantize_kv_pages): the kv write's two
# quantized instances must equal their plain versions bit for bit; the paged
# kernel's quantized instances take the bf16 gates against the plain version
# on the same quantized cache, which dequantizes K and V in fp32 where the
# kernel scales the scores and rounds P times vscale to bf16, as the TPU
# kernel does.

KV_QUANT = [torch.int8, torch.float8_e4m3fn]


def _quant_rows(rng, b, hk, d, dtype, device):
    """bf16 rows (b, hk, d) of unit scale, with the cases a quantizer gets
    wrong: a zero row (scale 1e-8), rows whose amax makes the scale exactly
    1 (int8: amax 127; fp8: amax 448) holding values halfway between two
    representable ones (int8: n + 0.5; e4m3: odd integers in [17, 31],
    between steps of 2), and an amax element at either sign."""
    x = rng.standard_normal((b, hk, d)).astype(np.float32)
    x[0, 0] = 0.0
    ties = (np.arange(d) % 20 - 9.5 if dtype == torch.int8
            else (17 + 2 * (np.arange(d) % 8)) * (-1.0) ** np.arange(d))
    x[0, -1] = ties
    x[0, -1, 0] = 127.0 if dtype == torch.int8 else 448.0
    x[-1, 0, d // 2] = -40.0
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


def _quant_cache(rng, L, hk, total, d, dtype, device):
    """A quantized cache: (k pages, v pages, k scales, v scales), each page
    quantized per token. K's rows vary in magnitude from token to token by
    a log-normal factor (as real caches' do), so that a scale read for the
    wrong token moves the scores; V's are unit normals, so the output stays
    at the unit scale the bf16 gates are set for."""
    out = []
    for spread in (True, False):
        rows = rng.standard_normal((L * hk, total, 128, d), dtype=np.float32)
        if spread:
            rows *= np.exp(rng.standard_normal((L * hk, total, 128, 1),
                                               dtype=np.float32))
        pages = torch.from_numpy(rows).to(device)
        q, s = quant.quantize_kv_pages(pages, dtype)
        out.append((q.view(L, hk, total, 128, d),
                    s.view(L, hk, total, 8, 128)))
    (kp, ks), (vp, vs) = out
    return kp, vp, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", KV_QUANT)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mode", ["store", "quantize"])
def test_kv_write_quant_matches_plain(cuda, dtype, d, mode):
    """Both quantized instances (a row already quantized with its scale;
    the bf16 row quantized in the kernel) equal the plain versions bit for
    bit, pools and scale tiles, everywhere but the trash page (rows 3 and 4
    share it)."""
    rng = np.random.default_rng(d)
    L, hk, total, b = 3, 2, 8, 5
    kp, vp, ks, vs = _quant_cache(rng, L, hk, total, d, dtype, cuda)
    k = _quant_rows(rng, b, hk, d, dtype, cuda)
    v = _quant_rows(rng, b, hk, d, dtype, cuda)
    trash = total - 1
    wpage = torch.tensor([2, 5, 2, trash, trash], dtype=torch.int32,
                         device=cuda)
    woff = torch.tensor([0, 127, 64, 0, 0], dtype=torch.int32, device=cuda)
    ref = [x.clone() for x in (kp, vp, ks, vs)]
    kq, ksc = quant._quantize_token(k, dtype)
    vq, vsc = quant._quantize_token(v, dtype)
    kv_update.write_token_kv_reference(ref[0], ref[1], kq, vq, wpage, woff,
                                       layer=1)
    kv_update._write_scales_reference(ref[2], ksc, wpage, woff, 1)
    kv_update._write_scales_reference(ref[3], vsc, wpage, woff, 1)
    before = kv_update.KERNEL.launches
    if mode == "store":
        out = kv_update.write_token_kv(kp, vp, ks, vs, kq, vq, ksc, vsc,
                                       wpage, woff, layer=1)
    else:
        out = kv_update.quantize_write_token_kv(kp, vp, ks, vs, k, v, wpage,
                                                woff, layer=1)
    assert kv_update.KERNEL.launches == before + 1
    assert all(a is b_ for a, b_ in zip(out, (kp, vp, ks, vs)))
    keep = torch.ones(total, dtype=torch.bool, device=cuda)
    keep[trash] = False
    for got, want in zip(out, ref):
        assert torch.equal(got[:, :, keep].view(torch.uint8)
                           if got.element_size() == 1 else got[:, :, keep],
                           want[:, :, keep].view(torch.uint8)
                           if want.element_size() == 1 else want[:, :, keep])
    # the zero row's scale, 1e-8, in all 8 rows of its tile's lane
    assert float(ksc[0, 0]) == float(torch.tensor(1e-8))
    assert torch.all(ks[1, 0, 2, :, 0] == ksc[0, 0])


def _paged_quant_inputs(rng, dtype, d, b=8, hk=2, group=4, pps=8, L=2):
    total = b * pps + 3
    kp, vp, ks, vs = _quant_cache(rng, L, hk, total, d, dtype, "cuda")
    q = _randn(rng, (b, hk * group, d), torch.bfloat16, "cuda")
    tab = torch.from_numpy(rng.permutation(total)[:b * pps].reshape(b, pps)
                           .astype(np.int32)).cuda()
    return q, kp, vp, ks, vs, tab


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", KV_QUANT)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("window,cap", [(None, None), (300, None),
                                        (None, 5.0), (300, 5.0)])
def test_paged_quant_matches_plain(cuda, dtype, d, window, cap):
    """The quantized instances against the plain version on the same
    quantized cache, with the window and the softcap; lengths 1, a page
    edge, past one page and the table's width, and 0. Repeats are
    bit-identical; with the scales ignored (all ones) or read one token
    off, the gate fails."""
    rng = np.random.default_rng(d + (window or 0))
    q, kp, vp, ks, vs, tab = _paged_quant_inputs(rng, dtype, d)
    lens = torch.tensor([1, 128, 129, 1024, 0, 700, 255, 64],
                        dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=cap, layer=1)
    before = pa_mod.KERNEL.launches
    o = pa_mod.paged_attention(q, kp, vp, lens, tab, k_scales=ks,
                               v_scales=vs, **kw)
    assert pa_mod.KERNEL.launches == before + 1
    o_ref = pa_mod.paged_attention_reference(q, kp, vp, lens, tab,
                                             k_scales=ks, v_scales=vs, **kw)
    label = f"paged[{dtype},{d},w{window},cap{cap}]"
    assert_metrics(label, o, o_ref, BF16_TOLS)
    assert torch.all(o[4] == 0)
    assert torch.equal(o, pa_mod.paged_attention(
        q, kp, vp, lens, tab, k_scales=ks, v_scales=vs, **kw))
    # the scales carry a factor of about 1/64: ignored, the gate fails
    ones = torch.ones_like(ks)
    for name, (ks_c, vs_c) in {"ignored": (ones, ones),
                               "one token off": (ks.roll(1, -1),
                                                 vs.roll(1, -1))}.items():
        bad = pa_mod.paged_attention(q, kp, vp, lens, tab, k_scales=ks_c,
                                     v_scales=vs_c, **kw)
        with pytest.raises(AssertionError):
            assert_metrics(f"{label} scales {name}", bad, o_ref, BF16_TOLS)


@pytest.mark.gpu
def test_paged_quant_in_cuda_graph_and_rejects(cuda):
    """The quantized instance replays in a CUDA graph with new lengths, and
    the wrapper raises on what the kernel does not take."""
    rng = np.random.default_rng(5)
    q, kp, vp, ks, vs, tab = _paged_quant_inputs(rng, torch.int8, 128)
    lens = torch.tensor([5, 128, 129, 1024, 1, 700, 255, 64],
                        dtype=torch.int32, device=cuda)
    kw = dict(k_scales=ks, v_scales=vs, layer=0)
    pa_mod.paged_attention(q, kp, vp, lens, tab, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o = pa_mod.paged_attention(q, kp, vp, lens, tab, **kw)
    lens.copy_(torch.tensor([1, 2, 300, 1000, 1024, 9, 640, 77]))
    graph.replay()
    torch.cuda.synchronize()
    assert_metrics("paged[graph,int8]", o, pa_mod.paged_attention_reference(
        q, kp, vp, lens, tab, **kw), BF16_TOLS)
    with pytest.raises(ValueError, match="bf16 q"):
        pa_mod.paged_attention(q.half(), kp, vp, lens, tab, **kw)
    with pytest.raises(ValueError, match="k_scales"):
        pa_mod.paged_attention(q, kp, vp, lens, tab, k_scales=ks[:, :, :-1],
                               v_scales=vs, layer=0)
    with pytest.raises(ValueError, match="page_size"):
        pa_mod.paged_attention(q, kp[..., :64, :].contiguous(),
                               vp[..., :64, :].contiguous(), lens, tab, **kw)
    with pytest.raises(ValueError, match="come together"):
        pa_mod.paged_attention(q, kp, vp, lens, tab, k_scales=ks, layer=0)


# --------------------------------------------------------------- grouped mm
# gmm and gmm_dw round an fp32 sum once, as their plain versions do, so the
# two differ by the summation order only: the forward gates (fp16) and the
# bf16 gates hold with outputs of unit scale.

GMM_CASES = {
    # (block_expert, n_experts, K, N)
    "ragged": ([2, 0, 0, 3, -1, 1, 1, -1], 4, 256, 384),
    "all_dead": ([-1, -1, -1], 2, 128, 128),
    "one_expert": ([0, 0, 0, 0], 1, 512, 256),
    "ragged_edges": ([1, -1, 0, 1], 3, 200, 136),
    # K and N multiples of 8 but not of the 64-deep k step or the 256-wide
    # N tile; N past one tile with a last tile that has one weight box
    "odd_widths": ([0, 1, -1, 0, 1], 2, 72, 264),
    # each expert's blocks out of order and interleaved with the others'
    "interleaved": ([1, 0, 2, 1, -1, 0, 2, 1, 0], 3, 320, 520),
    # one live block; experts 0-2 get no rows (gmm_dw: exact zeros)
    "single_live": ([-1, -1, 3, -1], 4, 192, 320),
}


def _gmm_inputs(case, dtype, device, seed=0):
    return _gmm_tensors(*GMM_CASES[case], dtype, device, seed)


def _gmm_tensors(be, e, k, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    be = torch.tensor(be, dtype=torch.int32, device=device)
    x = _randn(rng, (len(be) * 128, k), dtype, device)
    w = (_randn(rng, (e, k, n), torch.float32, device) * k**-0.5).to(dtype)
    return x, w, be


def _gmm_tols(dtype):
    return BWD_BF16_TOLS if dtype == torch.bfloat16 else FWD_TOLS


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_matches_plain(cuda, dtype, transposed, case):
    """y = x . w[expert of the block], and with w given as the strided view
    w.transpose(1, 2) of an (E, N, K) stack; dead blocks exactly 0."""
    x, w, be = _gmm_inputs(case, dtype, cuda)
    if transposed:
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
        assert w.stride(1) == 1
    y = moe_mod.gmm(x, w, be)
    want = moe_mod.gmm_reference(x, w, be)
    assert_metrics(f"gmm[{case},{dtype},{transposed}]", y, want,
                   _gmm_tols(dtype))
    dead = (be < 0).repeat_interleave(128)
    assert torch.all(y[dead] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_dw_matches_plain(cuda, dtype, case):
    """dW[e] = x[rows of e]^T dy[rows of e]; experts with no rows exactly 0;
    two runs bit-identical."""
    x, w, be = _gmm_inputs(case, dtype, cuda, seed=1)
    e, k, n = w.shape
    rng = np.random.default_rng(2)
    rows = max(1, int((be >= 0).sum()) * 128 // e)
    dy = (_randn(rng, (x.shape[0], n), torch.float32, cuda)
          * rows**-0.5).to(dtype)
    dw = moe_mod.gmm_dw(x, dy, be, e)
    want = moe_mod.gmm_dw_reference(x, dy, be, e)
    assert dw.shape == (e, k, n)
    assert_metrics(f"gmm_dw[{case},{dtype}]", dw, want, _gmm_tols(dtype))
    for i in range(e):
        if not bool((be == i).any()):
            assert torch.all(dw[i] == 0)
    assert torch.equal(dw, moe_mod.gmm_dw(x, dy, be, e))


def _many_tiles(rng, nb, e, dead_share=0.2):
    """nb block ids over e experts in random order, some dead, expert 0
    given no block."""
    be = rng.integers(1, e, size=nb)
    be[rng.random(nb) < dead_share] = -1
    return be.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
def test_gmm_persistent_tiles(cuda, monkeypatch, transposed):
    """Three CTAs walk 40 blocks x 2 column tiles, each tile's ring stages
    following the last tile's; dead tiles interleaved."""
    monkeypatch.setattr(moe_mod, "_n_ctas", lambda device: 3)
    be = _many_tiles(np.random.default_rng(5), 40, 5)
    x, w, be = _gmm_tensors(be, 5, 200, 392, torch.bfloat16, cuda, seed=6)
    if transposed:
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    y = moe_mod.gmm(x, w, be)
    assert_metrics(f"gmm persistent[{transposed}]", y,
                   moe_mod.gmm_reference(x, w, be), BWD_BF16_TOLS)
    assert torch.all(y[(be < 0).repeat_interleave(128)] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gmm_dw_persistent_tiles(cuda, monkeypatch, dtype):
    """Three CTAs walk 5 experts x 5 K tiles x 3 N tiles of dW, expert 0
    with no rows; bit-identical repeats."""
    monkeypatch.setattr(moe_mod, "_n_ctas", lambda device: 3)
    rng = np.random.default_rng(7)
    be = torch.tensor(_many_tiles(rng, 24, 5), dtype=torch.int32, device=cuda)
    x = _randn(rng, (24 * 128, 520), dtype, cuda)
    dy = (_randn(rng, (24 * 128, 600), torch.float32, cuda) * 0.05).to(dtype)
    dw = moe_mod.gmm_dw(x, dy, be, 5)
    assert_metrics(f"gmm_dw persistent[{dtype}]", dw,
                   moe_mod.gmm_dw_reference(x, dy, be, 5), _gmm_tols(dtype))
    assert torch.all(dw[0] == 0)
    assert torch.equal(dw, moe_mod.gmm_dw(x, dy, be, 5))


@pytest.mark.gpu
def test_gmm_and_gmm_dw_256_row_blocks(cuda):
    """Blocks of 256 rows: two gmm row tiles a block, four gmm_dw stages."""
    rng = np.random.default_rng(8)
    be = torch.tensor([1, -1, 0, 1], dtype=torch.int32, device=cuda)
    x = _randn(rng, (4 * 256, 136), torch.bfloat16, cuda)
    w = (_randn(rng, (2, 136, 264), torch.float32, cuda) * 0.1).to(
        torch.bfloat16)
    y = moe_mod.gmm(x, w, be)
    assert_metrics("gmm br 256", y, moe_mod.gmm_reference(x, w, be),
                   BWD_BF16_TOLS)
    assert torch.all(y[256:512] == 0)
    dy = (_randn(rng, (4 * 256, 264), torch.float32, cuda) * 0.05).to(
        torch.bfloat16)
    assert_metrics("gmm_dw br 256", moe_mod.gmm_dw(x, dy, be, 3),
                   moe_mod.gmm_dw_reference(x, dy, be, 3), BWD_BF16_TOLS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("transposed", [False, True])
def test_gmm_repeats_bit_identical(cuda, dtype, transposed):
    x, w, be = _gmm_inputs("interleaved", dtype, cuda, seed=9)
    if transposed:
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    y = moe_mod.gmm(x, w, be)
    for _ in range(3):
        assert torch.equal(y, moe_mod.gmm(x, w, be))


@pytest.mark.gpu
def test_gmm_in_cuda_graph_at_decode(cuda):
    """8 tokens routed top-2 over 8 experts (the dispatch's 10 blocks): gmm
    captured in a CUDA graph and replayed on new inputs equals the eager
    call bit for bit."""
    rng = np.random.default_rng(10)
    ids = torch.from_numpy(np.stack([rng.choice(8, 2, replace=False)
                                     for _ in range(8)])).to(cuda)
    _, _, be, n_pad = moe_mod.dispatch(ids, 8)
    x = _randn(rng, (n_pad, 256), torch.bfloat16, cuda)
    w = (_randn(rng, (8, 256, 520), torch.float32, cuda) * 0.0625).to(
        torch.bfloat16)
    moe_mod.gmm(x, w, be)  # builds and loads outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = moe_mod.gmm(x, w, be)
    x.copy_(_randn(rng, (n_pad, 256), torch.bfloat16, cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, moe_mod.gmm(x, w, be))
    assert_metrics("gmm graph decode", y, moe_mod.gmm_reference(x, w, be),
                   BWD_BF16_TOLS)


@pytest.mark.gpu
def test_grouped_matmul_autograd_cuda_matches_cpu(cuda):
    """dx through gmm on the strided w^T and dW through gmm_dw (bf16, card)
    against the plain versions (fp32, CPU) on the same inputs."""
    x, w, be = _gmm_inputs("ragged", torch.bfloat16, cuda, seed=3)
    rng = np.random.default_rng(4)
    dy = (_randn(rng, (x.shape[0], w.shape[2]), torch.float32, cuda)
          * 0.05).to(torch.bfloat16)
    grads = []
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.float32)):
        leaves = [t.detach().to(dev, dtype).requires_grad_() for t in (x, w)]
        moe_mod.grouped_matmul(*leaves, be.to(dev)).backward(dy.to(dev, dtype))
        grads.append([t.grad for t in leaves])
    for name, a, b in zip(("dx", "dw"), *grads):
        assert a.dtype == torch.bfloat16 and a.is_cuda
        assert_metrics(f"grouped_matmul {name}", a, b, BWD_BF16_TOLS)


@pytest.mark.gpu
def test_gmm_counts_and_rejects(cuda):
    x, w, be = _gmm_inputs("ragged", torch.bfloat16, cuda)
    before = [kern.launches for kern in moe_mod.KERNELS]
    moe_mod.gmm(x, w, be)
    moe_mod.gmm_dw(x, x[:, :128], be, 4)
    assert [kern.launches for kern in moe_mod.KERNELS] == [
        n + 1 for n in before]
    with pytest.raises(ValueError):  # fp32 on the card
        moe_mod.gmm(x.float(), w.float(), be)
    with pytest.raises(ValueError):  # 64-row blocks
        moe_mod.gmm(x, w, torch.zeros(16, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):  # int64 block ids
        moe_mod.gmm(x, w, be.long())
    with pytest.raises(ValueError):  # no unit stride in w
        moe_mod.gmm(x, w[:, :, ::2], be)
    with pytest.raises(ValueError):  # a CUDA x with CPU block ids
        moe_mod.gmm_dw(x, x, be.cpu(), 4)
    with pytest.raises(ValueError):  # more experts than gmm_dw's counts hold
        moe_mod.gmm_dw(x, x, be, 1000)


# --------------------------------------------------------- quantized matmul
# (m, k, n): one row; decode (the weight on the M side, k split 16 ways);
# ragged k (not a multiple of 8: x padded) with n not a multiple of 16
# (weight padded); ragged m, k and n tiles; the prefill tile split over k.
QMM_SHAPES = [(1, 64, 128), (8, 4096, 1024), (7, 202, 200), (100, 512, 512),
              (129, 264, 1040), (300, 1000, 384)]


def _qmm_inputs(seed, m, k, n, bits, dtype, device):
    rng = np.random.default_rng(seed)
    x = _randn(rng, (m, k), dtype, device)
    w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                         * k**-0.5)
    qt = (quant.quantize_int8 if bits == 8 else quant.quantize_int4)(w)
    return x, quant.QuantizedTensor(qt.values.to(device),
                                    qt.scales.to(device), bits)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_qmm_matches_plain(cuda, dtype, bits, m, k, n):
    x, w = _qmm_inputs(m + k + n, m, k, n, bits, dtype, cuda)
    y = quant.quantized_matmul(x, w)
    want = quant.quantized_matmul_reference(x, w)
    assert y.shape == (m, n) and y.dtype == dtype
    assert_metrics(f"qmm[{dtype},{bits},{m},{k},{n}]", y, want,
                   _gmm_tols(dtype))


def _every_value(bits, k, n):
    """(k, n) int8 values (packed (k / 2, n) for int4) in which every column
    holds every int8 value -128..127, or every int4 nibble -8..7 in both
    nibble positions."""
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    if bits == 8:
        return ((kk * 7 + nn) % 256 - 128).astype(np.int8)
    lo = (kk[: k // 2] + nn[: k // 2]) % 16 - 8
    hi = (kk[: k // 2] * 3 + nn[: k // 2] + 5) % 16 - 8
    return ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8).view(np.int8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [8, 16, 300])
def test_qmm_dequantisation_exact(cuda, dtype, bits, m):
    """One-hot rows of x pick single weight rows, so y = q s exactly before
    one rounding: the kernel's bit-level conversion must equal the plain
    version bit for bit, on the decode (m 8, 16; k split) and the prefill
    variant (m 300), for every int8 value and every int4 nibble."""
    k, n = 1024, 384
    rng = np.random.default_rng(bits + m)
    values = torch.from_numpy(_every_value(bits, k, n)).to(cuda)
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)
                              / 64).to(cuda)
    w = quant.QuantizedTensor(values, scales, bits)
    x = torch.zeros((m, k), dtype=dtype, device=cuda)
    x[torch.arange(m), torch.from_numpy(rng.integers(0, k, m))] = 1
    got = quant.quantized_matmul(x, w)
    assert torch.equal(got, quant.quantized_matmul_reference(x, w))
    if m <= quant.DECODE_M:
        assert quant.plan(m, k, n, torch.cuda.get_device_properties(cuda)
                          .multi_processor_count)[1] > 1


# m on both sides of the decode widths (8, 16), of 64 and of the prefill
# tile (256 rows of x); (k, n) ragged against the 64-deep k steps and the
# 128-column weight tiles (n = 392 is padded to 400)
QMM_EDGE_M = [1, 8, 16, 17, 64, 65, 255, 256, 257]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", [(200, 272), (1000, 392)])
@pytest.mark.parametrize("m", QMM_EDGE_M)
def test_qmm_tile_edges(cuda, dtype, bits, k, n, m):
    x, w = _qmm_inputs(m * 7 + k + n, m, k, n, bits, dtype, cuda)
    y = quant.quantized_matmul(x, w)
    assert y.shape == (m, n) and y.dtype == dtype
    assert_metrics(f"qmm edge[{dtype},{bits},{m},{k},{n}]", y,
                   quant.quantized_matmul_reference(x, w), _gmm_tols(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 16])
def test_qmm_decode_split_repeats_bit_identical(cuda, m):
    """The decode variant with its k split: partials summed in a fixed
    order, so repeats give the same bits."""
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for bits in (8, 4):
        x, w = _qmm_inputs(11 + m, m, 4096, 4096, bits, torch.bfloat16, cuda)
        assert quant.plan(m, 4096, 4096, n_sms)[1] > 1
        first = quant.quantized_matmul(x, w)
        for _ in range(3):
            assert torch.equal(first, quant.quantized_matmul(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 300])
def test_qmm_int4_nibble_order(cuda, m):
    """Every packed byte holds two different nibbles, so reading the high
    nibble as row 2i (or sign-extending wrongly) fails the gates."""
    rng = np.random.default_rng(m)
    k, n = 512, 256
    lo = rng.integers(-8, 8, (k // 2, n))
    hi = (lo + rng.integers(1, 16, (k // 2, n)) + 8) % 16 - 8
    assert np.all(lo != hi)
    values = torch.from_numpy(((lo & 0xF) | ((hi & 0xF) << 4)).astype(
        np.uint8).view(np.int8)).to(cuda)
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)
                              * (k * 30.0) ** -0.5).to(cuda)
    w = quant.QuantizedTensor(values, scales, 4)
    x = _randn(rng, (m, k), torch.bfloat16, cuda)
    assert_metrics(f"qmm[nibbles,{m}]", quant.quantized_matmul(x, w),
                   quant.quantized_matmul_reference(x, w), BWD_BF16_TOLS)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (300, 1000, 384),
                                   (256, 1024, 2048)])
def test_qmm_repeats_bit_identical_and_fp32_out(cuda, m, k, n):
    """No atomics: two launches give the same bits, with or without a k
    split; fp32 output is the same fp32 sum, scaled, left unrounded."""
    for bits in (8, 4):
        x, w = _qmm_inputs(5, m, k, n, bits, torch.bfloat16, cuda)
        first = quant.quantized_matmul(x, w)
        assert torch.equal(first, quant.quantized_matmul(x, w))
        y32 = quant.quantized_matmul(x, w, out_dtype=torch.float32)
        assert y32.dtype == torch.float32
        assert_metrics(f"qmm[fp32 out,{bits}]", y32,
                       quant.quantized_matmul_reference(
                           x, w, out_dtype=torch.float32), FWD_TOLS)


@pytest.mark.gpu
def test_qmm_strided_x(cuda):
    """x as a column slice of a wider buffer: read through its row stride."""
    x, w = _qmm_inputs(9, 40, 256, 384, 8, torch.bfloat16, cuda)
    wide = torch.zeros((40, 256 + 64), dtype=torch.bfloat16, device=cuda)
    wide[:, 8:264] = x
    got = quant.quantized_matmul(wide[:, 8:264], w)
    assert torch.equal(got, quant.quantized_matmul(x, w))


@pytest.mark.gpu
def test_qmm_misaligned_weight_is_copied(cuda):
    """values and scales at an offset TMA cannot read from (not 16-byte
    aligned) are copied, not refused."""
    x, w = _qmm_inputs(13, 8, 256, 384, 8, torch.bfloat16, cuda)
    vals = torch.empty(w.values.numel() + 1, dtype=torch.int8, device=cuda)
    vals[1:] = w.values.flatten()
    scs = torch.empty(w.scales.numel() + 1, device=cuda)
    scs[1:] = w.scales
    odd = quant.QuantizedTensor(vals[1:].view(w.values.shape), scs[1:], 8)
    assert odd.values.data_ptr() % 16 and odd.scales.data_ptr() % 16
    assert torch.equal(quant.quantized_matmul(x, odd),
                       quant.quantized_matmul(x, w))


@pytest.mark.gpu
def test_qmm_counts_and_rejects(cuda):
    x, w = _qmm_inputs(1, 8, 256, 128, 8, torch.bfloat16, cuda)
    before = quant.KERNEL.launches
    quant.quantized_matmul(x, w)
    assert quant.KERNEL.launches == before + 1
    with pytest.raises(NotImplementedError):  # fp32 activations on the card
        quant.quantized_matmul(x.float(), w)
    with pytest.raises(NotImplementedError):  # fp16 out of bf16 x
        quant.quantized_matmul(x, w, out_dtype=torch.float16)
    with pytest.raises(ValueError):  # k disagrees with the weight
        quant.quantized_matmul(x[:, :128], w)
    with pytest.raises(ValueError):  # scales on the CPU
        quant.quantized_matmul(x, w._replace(scales=w.scales.cpu()))
    with pytest.raises(ValueError):  # a strided weight
        quant.quantized_matmul(x, w._replace(values=w.values[:, ::2],
                                             scales=w.scales[::2]))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_prefill_cuda_matches_cpu(cuda, bits):
    """A tiny quantized Llama: prefill logits through the kernel (bf16,
    card) against the plain version (fp32, CPU) on the same
    QuantizedTensors; bf16 activations hold them to a few percent."""
    from flash_attention_tpu_torch.models import llama
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    qp = llama.quantize_params(params, bits=bits)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 50)))
    want, _, _ = llama.prefill(qp, toks, cfg, return_kv=False)

    def to_card(v):
        if isinstance(v, quant.QuantizedTensor):
            return quant.QuantizedTensor(v.values.to(cuda), v.scales.to(cuda),
                                         v.bits)
        return v.to(cuda, torch.bfloat16)
    before = quant.KERNEL.launches
    got, _, _ = llama.prefill({k: to_card(v) for k, v in qp.items()},
                              toks.to(cuda), cfg, return_kv=False)
    assert quant.KERNEL.launches == before + 7 * cfg.n_layers + 1
    rel = float((got.cpu() - want).norm() / want.norm())
    assert rel < 5e-2, rel


# Segmented (varlen) instances of the forward, dq and dkv kernels against
# the plain segmented versions (the mask from segment ids and positions),
# with the gates of the dense instances. Ragged sequences with cu_k >= cu_q
# per sequence, a length-1 sequence, sequences that cross the 64- and
# 128-row tiles, and tail tokens past cu[-1] in both packed buffers.
SEG_LENS = ([1, 70, 130, 200, 33], [1, 90, 130, 260, 33])
SEG_CASES = {  # causal, window, softcap
    "causal": (True, None, None), "non-causal": (False, None, None),
    "window": (True, (40, 0), None), "softcap": (True, None, 5.0)}


def _seg_inputs(rng, lens_q, lens_k, h, hk, d, dtype, device, tail=(7, 9)):
    from flash_attention_tpu_torch.ops.attention import _varlen_segs
    cu_q = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]))
    cu_k = torch.tensor(np.concatenate([[0], np.cumsum(lens_k)]))
    tq, tk = int(cu_q[-1]) + tail[0], int(cu_k[-1]) + tail[1]
    segs = tuple(x.to(device) for x in _varlen_segs(cu_q, cu_k, tq, tk))
    q, do = (_randn(rng, (1, tq, h, d), dtype, device) for _ in range(2))
    k, v = (_randn(rng, (1, tk, hk, d), dtype, device) for _ in range(2))
    return q, k, v, do, segs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_flash_segmented_matches_plain(cuda, dtype, d, case):
    """The segmented forward, dq and dkv against their plain versions; the
    query tail (pad id) gets O = 0, LSE = empty_lse and dq = 0, the key
    tail dK = dV = 0."""
    causal, window, cap = SEG_CASES[case]
    rng = np.random.default_rng(d + len(case))
    q, k, v, do, segs = _seg_inputs(rng, *SEG_LENS, 8, 2, d, dtype, cuda)
    kw = dict(causal=causal, sm_scale=d**-0.5, window=window, softcap=cap,
              segs=segs)
    before = fwd_mod.KERNEL.launches
    o, lse = fwd_mod.flash_fwd(q, k, v, empty_lse=-2.0, **kw)
    assert fwd_mod.KERNEL.launches == before + 1
    o_ref, lse_ref = fwd_mod.flash_fwd_segmented_reference(
        q, k, v, empty_lse=-2.0, **kw)
    tag = f"[{case},{dtype},{d}]"
    assert_metrics("fwd" + tag, o, o_ref,
                   BF16_TOLS if dtype == torch.bfloat16 else FWD_TOLS)
    assert_metrics("fwd lse" + tag, lse, lse_ref, LSE_TOLS)
    tail_q, tail_k = segs[0][0] < 0, segs[1][0] < 0
    assert torch.all(o[:, tail_q] == 0) and torch.all(lse[:, :, tail_q] == -2)
    di = bwd_mod.flash_bwd_di(o, do)
    di_r = bwd_mod.di_reference(o, do)
    dq = bwd_mod.flash_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = bwd_mod.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    dq_r = bwd_mod.dq_reference(q, k, v, do, lse, di_r, **kw)
    dk_r, dv_r = bwd_mod.dkv_reference(q, k, v, do, lse, di_r, **kw)
    tols = BWD_BF16_TOLS if dtype == torch.bfloat16 else BWD_TOLS
    for name, x, ref in (("dq", dq, dq_r), ("dk", dk, dk_r), ("dv", dv, dv_r)):
        assert_metrics(name + tag, x, ref, _ulp_tols(tols, ref))
    assert torch.all(dq[:, tail_q] == 0)
    assert torch.all(dk[:, tail_k] == 0) and torch.all(dv[:, tail_k] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_segmented_packed_equals_dense(cuda, d):
    """Four packed causal sequences of 256 tokens, whose boundaries fall on
    every kernel's tiles, take the same tiles in the same order as the
    dense kernels on (4, 256): O, LSE, dq, dk and dv equal them bit for
    bit."""
    rng = np.random.default_rng(d)
    b, s, h, hk = 4, 256, 8, 2
    q, k, v, do = (_randn(rng, (b, s, n, d), torch.bfloat16, cuda)
                   for n in (h, hk, hk, h))
    seg = torch.arange(b * s, device=cuda, dtype=torch.int32)[None] // s
    pos = torch.arange(b * s, device=cuda, dtype=torch.int32)[None] % s
    segs = (seg, seg, pos, pos)
    kw = dict(causal=True, sm_scale=d**-0.5)
    o, lse = fwd_mod.flash_fwd(q, k, v, **kw)
    packed = [x.reshape(1, b * s, *x.shape[2:]) for x in (q, k, v, do)]
    o_s, lse_s = fwd_mod.flash_fwd(*packed[:3], segs=segs, **kw)
    assert torch.equal(o_s.view(o.shape), o)
    assert torch.equal(lse_s.view(1, h, b, s).transpose(0, 2)[:, :, 0], lse)
    dense = bwd_mod.flash_bwd(q, k, v, o, lse, do, **kw)
    seg_out = bwd_mod.flash_bwd(*packed[:3], o_s, lse_s, packed[3],
                                segs=segs, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), seg_out, dense):
        assert torch.equal(x.view(y.shape), y), name


@pytest.mark.gpu
def test_flash_segmented_empty_ranges_and_unsorted_keys(cuda):
    """Query blocks with no key of their segment (empty ranges: nothing
    loaded, O = 0, LSE = empty_lse) and an unsorted kv key (the full-range
    fallback, a chunked-prefill layout) against the plain versions."""
    rng = np.random.default_rng(5)
    b, sq, pref, c, h, hk, d = 2, 256, 384, 256, 8, 2, 128
    q, do = (_randn(rng, (b, sq, h, d), torch.bfloat16, cuda)
             for _ in range(2))
    k, v = (_randn(rng, (b, pref + c, hk, d), torch.bfloat16, cuda)
            for _ in range(2))
    done = torch.tensor([300, 0], device=cuda)
    idx = torch.arange(c, device=cuda)
    positions = done[:, None] + idx
    kv_pos = torch.cat([torch.arange(pref, device=cuda).expand(b, pref),
                        positions], 1)
    kv_seg = torch.cat([torch.where(kv_pos[:, :pref] < done[:, None], 0, -1),
                        torch.zeros((b, c), device=cuda, dtype=torch.long)],
                       1)
    q_seg = torch.zeros((b, sq), device=cuda, dtype=torch.long)
    q_seg[1, 128:] = 7  # a segment with no key: an empty range
    segs = tuple(x.int() for x in (q_seg, kv_seg, positions, kv_pos))
    kw = dict(causal=True, sm_scale=d**-0.5, segs=segs)
    o, lse = fwd_mod.flash_fwd(q, k, v, empty_lse=-1.0, **kw)
    o_ref, lse_ref = fwd_mod.flash_fwd_segmented_reference(
        q, k, v, empty_lse=-1.0, **kw)
    assert_metrics("fwd[unsorted]", o, o_ref, BF16_TOLS)
    assert_metrics("fwd lse[unsorted]", lse, lse_ref, LSE_TOLS)
    assert torch.all(o[1, 128:] == 0) and torch.all(lse[1, :, 128:] == -1.0)
    di = bwd_mod.flash_bwd_di(o, do)
    di_r = bwd_mod.di_reference(o, do)
    dq = bwd_mod.flash_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = bwd_mod.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    dq_r = bwd_mod.dq_reference(q, k, v, do, lse, di_r, **kw)
    dk_r, dv_r = bwd_mod.dkv_reference(q, k, v, do, lse, di_r, **kw)
    for name, x, ref in (("dq", dq, dq_r), ("dk", dk, dk_r), ("dv", dv, dv_r)):
        assert_metrics(name + "[unsorted]", x, ref,
                       _ulp_tols(BWD_BF16_TOLS, ref))
