"""Head dims 384 and 512 (and d 320, run at 384) on the serving path,
against the JAX package on the CPU: DeepSeek-V4-Flash's attention geometry
cut to size (8 query heads on one kv head, d 512, a sliding window on every
second layer).

Inputs come from numpy seeds and go to both packages; the JAX side runs its
Pallas kernels in interpret mode (it pads d 320 to 384 itself), the port its
plain versions (the CUDA kernels' d-384 and 512 instances are held against
the same plain versions on the card, in ``test_torch_kernels.py``). fp32 on
both sides, so the repo's forward gates (atol 5e-3, mean_atol 2e-4,
mean_rtol 1e-2) hold for O and paged decode, the LSE gates of
``tests/test_flash_fwd.py:21`` for the LSE, and the engines' per-token
logprobs; paged decode over bf16 pages (bf16 q and output on both sides)
takes the repo's bf16 gates (``tests/test_flash_fwd.py:117``: atol 4e-2,
mean_atol 2e-3, mean_rtol 5e-2), each side rounding its fp32 O to bf16
once. The kv write is bit for bit. The engine's tokens must be JAX's
greedy tokens at every position (JAX's prefill over each prompt and the
tokens the engine emitted).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

import flash_attention_tpu as fat
from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.ops.kv_update import write_token_kv as jax_write
from flash_attention_tpu.ops.paged_attention import \
    paged_attention as jax_paged
from flash_attention_tpu.utils.metrics import assert_metrics
from flash_attention_tpu_torch import Engine, fwd, paged_attention, varlen_fwd
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.ops import kv_update
from flash_attention_tpu_torch.ops.attention import kernel_head_dim
from flash_attention_tpu_torch.ops.quant import quantize_kv_pages

torch.set_num_threads(2)

FWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
LSE_TOLS = {"atol": 1e-2, "mean_atol": 1e-3, "mean_rtol": 1e-2}
BF16_TOLS = {"atol": 4e-2, "mean_atol": 2e-3, "mean_rtol": 5e-2}
H, HK = 8, 1  # a GQA group of 8 on one kv head
# (causal, window_size, softcap): V4-Flash's window (128 there, 15 here so
# that it binds at these lengths) and a softcap of 5, which binds at
# unit-scale scores
CASES = {"causal": (True, None, None), "window": (True, (15, 0), None),
         "softcap": (True, None, 5.0)}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [320, 384, 512])
def test_fwd_wide_matches_jax(d, case):
    """fwd at b1 sq 48 sk 80 (the band lower-right aligned): O and LSE
    against JAX's."""
    causal, window, cap = CASES[case]
    q, k, v = _arrays(d + len(case), (1, 48, H, d), (1, 80, HK, d),
                      (1, 80, HK, d))
    kw = dict(window_size=window, softcap=cap)
    o, lse = fwd(*map(torch.from_numpy, (q, k, v)), causal, **kw)
    oj, lsej = fat.fwd(*map(jnp.asarray, (q, k, v)), is_causal=causal, **kw)
    assert o.shape == q.shape and lse.shape == (1, H, 48)
    assert_metrics(f"o[d{d},{case}]", o.numpy(), np.asarray(oj), FWD_TOLS)
    assert_metrics(f"lse[d{d},{case}]", lse.numpy(), np.asarray(lsej),
                   LSE_TOLS)


@pytest.mark.parametrize("d", [320, 384, 512])
def test_varlen_fwd_wide_matches_jax(d):
    """varlen_fwd over three packed sequences (len_k >= len_q in each, so
    causal is lower-right aligned per sequence), causal with the window and
    the softcap: O and the packed LSE."""
    causal, window, cap = True, (15, 0), 5.0
    cu_q = np.asarray([0, 20, 36, 70], np.int32)
    cu_k = np.asarray([0, 30, 46, 96], np.int32)
    q, k, v = _arrays(d + 7, (70, H, d), (96, HK, d), (96, HK, d))
    kw = dict(window_size=window, softcap=cap)
    o, lse = varlen_fwd(*map(torch.from_numpy, (q, k, v, cu_q, cu_k)),
                        is_causal=causal, **kw)
    oj, lsej = fat.varlen_fwd(*map(jnp.asarray, (q, k, v, cu_q, cu_k)),
                              is_causal=causal, **kw)
    assert o.shape == q.shape and lse.shape == (H, 70)
    assert_metrics(f"varlen o[d{d}]", o.numpy(), np.asarray(oj), FWD_TOLS)
    assert_metrics(f"varlen lse[d{d}]", lse.numpy(), np.asarray(lsej),
                   LSE_TOLS)


def _pad(x, width):
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, width - x.shape[-1])])


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("d", [320, 384, 512])
def test_paged_wide_matches_jax(d, pages):
    """Paged decode of 8 heads on one kv head (over bf16 pages as they are,
    over int8 pages with the window and the softcap): lengths 1, a page
    edge, past it and the table's width. The port's cache is
    kernel_head_dim(d) wide (d 320's zero-padded to 384, as the engine
    allocates it); JAX's is d wide. int8 pages of 128 tokens and their scale tiles come from the
    port's quantizer (bit-identical to JAX's: test_torch_kv_quant.py)."""
    ps = 16 if pages == "bf16" else 128
    L, b, pps = 2, 4, 2
    total = b * pps + 2
    rng = np.random.default_rng(d)
    q = rng.standard_normal((b, H, d), dtype=np.float32)
    kv = [rng.standard_normal((L, HK, total, ps, d), dtype=np.float32)
          for _ in range(2)]
    tab = rng.permutation(total)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = np.asarray([1, ps, ps + 1, pps * ps], np.int32)
    width = kernel_head_dim(d)
    kw = {} if pages == "bf16" else dict(window=ps + 3, softcap=5.0)
    if pages == "bf16":
        qj = jnp.asarray(q, jnp.bfloat16)
        kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in kv)
        oj = jax_paged(qj, kj, vj, jnp.asarray(lens), jnp.asarray(tab),
                       layer=1, **kw)
        kt, vt = (torch.from_numpy(_pad(x, width)).bfloat16() for x in kv)
        o = paged_attention(torch.from_numpy(q).bfloat16(), kt, vt,
                            torch.from_numpy(lens), torch.from_numpy(tab),
                            layer=1, **kw)
        assert o.dtype == torch.bfloat16
        tols, got, want = BF16_TOLS, o.float().numpy(), \
            np.asarray(oj.astype(jnp.float32))
    else:
        quant = [[quantize_kv_pages(torch.from_numpy(_pad(x[i], width)),
                                    torch.int8) for i in range(L)]
                 for x in kv]
        (kt, kst), (vt, vst) = ((torch.stack([p for p, _ in ps_]),
                                 torch.stack([s for _, s in ps_]))
                                for ps_ in quant)
        oj = jax_paged(jnp.asarray(q), jnp.asarray(kt[..., :d].numpy()),
                       jnp.asarray(vt[..., :d].numpy()),
                       jnp.asarray(lens), jnp.asarray(tab),
                       k_scales=jnp.asarray(kst.numpy()),
                       v_scales=jnp.asarray(vst.numpy()), layer=1, **kw)
        o = paged_attention(torch.from_numpy(q), kt, vt,
                            torch.from_numpy(lens), torch.from_numpy(tab),
                            k_scales=kst, v_scales=vst, layer=1, **kw)
        tols, got, want = FWD_TOLS, o.numpy(), np.asarray(oj)
    assert o.shape == (b, H, d)
    assert_metrics(f"paged[d{d},{pages},{kw}]", got, want, tols)


@pytest.mark.parametrize("mode", ["float", "int8"])
@pytest.mark.parametrize("d", [320, 384, 512])
def test_kv_write_wide_matches_jax(d, mode):
    """d-wide rows written into JAX's d-wide cache and the port's cache at
    kernel_head_dim(d) (384 for d 320): the written values (and scales) bit
    for bit, the columns past d zero."""
    rng = np.random.default_rng(d + 1)
    width, L, b, total, ps = kernel_head_dim(d), 2, 3, 12, 16
    wpage = np.asarray([3, 11, 7], np.int32)
    woff = np.asarray([0, 15, 9], np.int32)
    rows = [rng.standard_normal((b, HK, d), dtype=np.float32)
            for _ in range(2)]
    shape = (L, HK, total, ps, d)
    idx = dict(wpage=torch.from_numpy(wpage), woff=torch.from_numpy(woff),
               layer=1)
    if mode == "float":
        kj, vj, _, _ = jax_write(jnp.zeros(shape), jnp.zeros(shape), None,
                                 None, *map(jnp.asarray, rows), None, None,
                                 jnp.asarray(wpage), jnp.asarray(woff),
                                 layer=1)
        kp = torch.zeros(shape[:-1] + (width,))
        vp = torch.zeros_like(kp)
        kv_update.write_token_kv(kp, vp, None, None,
                                 *map(torch.from_numpy, rows), None, None,
                                 **idx)
        pairs = ((kp, kj), (vp, vj))
    else:
        (kq, ksc), (vq, vsc) = (jl._quantize_token(jnp.asarray(r), jnp.int8)
                                for r in rows)
        sshape = (L, HK, total, 8, 128)
        kj, vj, ksj, vsj = jax_write(
            jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
            jnp.ones(sshape), jnp.ones(sshape), kq, vq, ksc, vsc,
            jnp.asarray(wpage), jnp.asarray(woff), layer=1)
        kp = torch.zeros(shape[:-1] + (width,), dtype=torch.int8)
        vp = torch.zeros_like(kp)
        ks, vs = torch.ones(sshape), torch.ones(sshape)
        kv_update.quantize_write_token_kv(kp, vp, ks, vs,
                                          *map(torch.from_numpy, rows), **idx)
        np.testing.assert_array_equal(ks.numpy(), np.asarray(ksj))
        np.testing.assert_array_equal(vs.numpy(), np.asarray(vsj))
        pairs = ((kp, kj), (vp, vj))
    for got, want in pairs:
        np.testing.assert_array_equal(got[..., :d].numpy(), np.asarray(want))
        assert not got[..., d:].any()


# the d-512 engines: Llama's tiny config at V4-Flash's attention geometry
# (8 heads on 1 kv head here, d 512, a window on every second layer)
D512 = dict(n_heads=H, n_kv_heads=HK, head_dim=512, sliding_window=24,
            window_pattern=2)
PROMPTS = ((3, 30), (4, 21))
ENGINE = dict(total_pages=12, page_size=16, max_batch=2, max_seq_len=64)
NEW = 4


def _prompts():
    return [list(map(int, np.random.default_rng(s).integers(0, 255, n)))
            for s, n in PROMPTS]


def _serve(pt, **kw):
    """The port's Engine on the d-512 config: each request's tokens and
    their logprobs."""
    eng = Engine(tl.LlamaConfig.tiny(**D512), pt, **ENGINE, **kw)
    assert eng.k_pages.shape[-1] == kernel_head_dim(512) == 512
    reqs = [eng.add_request(p, NEW, logprobs=True) for p in _prompts()]
    eng.run()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.output for r in reqs], [r.token_logprobs for r in reqs]


@pytest.fixture(scope="module")
def d512():
    """The weights as the port's, and JAX's reference for the engine: its
    logits over each prompt followed by the tokens the port's engine
    emitted (one prefill of the right-padded batch), as greedy tokens and
    the log-softmax at each emitted token."""
    cfg = jl.LlamaConfig.tiny(**D512)
    pj = jl.init_params(jax.random.PRNGKey(5), cfg, dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    outputs, _ = _serve(pt)
    seqs = [p + o[:-1] for p, o in zip(_prompts(), outputs)]
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, sq in enumerate(seqs):
        toks[i, :len(sq)] = sq
    logits = jl.prefill(pj, jnp.asarray(toks), cfg)[0]
    lp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    want = []
    for i, (p, o) in enumerate(zip(_prompts(), outputs)):
        rows = lp[i, len(p) - 1:len(p) - 1 + NEW]
        want.append((rows.argmax(-1).tolist(), rows[np.arange(NEW), o]))
    return want, pt


@pytest.mark.parametrize("variant", ["default", "chunked"])
def test_engine_d512_matches_jax(d512, variant):
    """A d-512 model served by the port's Engine (its cache 512 wide; a
    24-token window on every second layer), plain and chunked: JAX's greedy
    tokens at every position, and the logprob of every emitted token
    (prefill's and each decode step's) within the forward gates."""
    want, pt = d512
    outputs, logprobs = _serve(
        pt, **(dict(chunk_size=16) if variant == "chunked" else {}))
    assert outputs == [w[0] for w in want]
    assert_metrics(f"engine logprobs[{variant}]", np.asarray(logprobs),
                   np.asarray([w[1] for w in want]), FWD_TOLS)
