#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's nine CUDA kernels from the sources in this checkout and
holds each against its plain PyTorch version at the shapes its path gives it
(timing kernel, plain version and, where one exists, a single PyTorch
library call as a yardstick), and the MoE feed-forward through the grouped
matmul kernels against the same call through their plain versions. Then it
drives the two paths on two models with random bf16 weights, full width:

* Llama-3-8B, 32 layers: serving (8 greedy requests through
  ``Engine.add_request`` / ``Engine.step``: flash forward, kv write, paged
  attention), prefill against decode logits, then training (``train_loss``
  with remat, ``.backward()`` and plain SGD for a few steps on a fixed
  2 x 2048 batch: flash forward and the three backward kernels), after a
  2-layer check of the card's bf16 loss and gradients against the CPU's
  fp32 plain versions;
* the same Llama-3-8B weights quantized by ``llama.quantize_params`` to
  int8 and then int4 (weight-only, per channel): the same serving, where
  every projection and the lm_head runs the quantized matmul (qmm), prefill
  against decode logits, the quality against the bf16 model on the served
  sequences (printed, not gated), and a 2-layer check of the card's logits
  against the CPU's plain versions on the same quantized weights;
* Mixtral-8x7B (8 experts, top-2), depth cut to fit the card: the same
  serving at 16 layers and training at 8, adding the grouped matmul (gmm)
  on both paths and its weight gradient (gmm_dw) in training, with the
  routing recorded where bf16 rounding may swap a token's experts;
* Mistral-7B-v0.1 (a 4096-token window on every layer), full width and
  depth: 8 requests of up to 7700 prompt tokens served with the window's
  page reclamation (the pages held checked against the JAX engine's rule
  after every step), then training on 1 x 8192; the attention kernels run
  their window mode on both paths;
* the window and softcap paths against the CPU's plain versions: Mistral
  at 2 layers with the window cut to 64, and a Gemma-2 config
  (``tiny_gemma2``, 4 layers, d 128: softcaps, GeGLU, sandwich norms, the
  embed scale) with its window on every second layer and on every layer,
  each prefill against decode and training, and the Gemma-2 config served;
* Gemma-2-9B (head dim 256; a 4096-token window on every second layer,
  softcaps 50/30), full width and depth: its consistency at 2 layers
  (card against CPU, with its logits at the served prompts' last
  positions gated), then served with Mistral's traffic (every page held
  under the global layers) and trained on 1 x 8192; every attention
  kernel runs its d-256 instances;
* chunked prefill: the Llama-3-8B weights served with Mistral's traffic
  through ``Engine(chunk_size=2048)`` (``llama.prefill_chunk``: the
  segmented forward over [prefix pages || chunk]) and through an
  unchunked engine, the last-position logits of the two held together,
  and a control (the last chunk with its prefix masked off) that must
  fail that gate; then the Gemma-2 config (window and softcaps) chunked
  against unchunked and against the CPU's plain versions.

Before the models, every attention kernel's d-256 instances are held
against their plain versions at Gemma-2-9B's widths (``check_head_dim_256``:
the d-128 phases again), and the window and softcap modes of the forward,
dq, dkv and paged kernels are held against their plain versions
(Mistral's window at b1 s8192, a two-sided band with sq != sk, rows with no
live key, softcap 5 at b8 s2048, both modes together, and paged decode at W
4096 with hole entries in the table), and the windowed kernels are timed
against the same kernels without the window, which they must beat by the
live area's margin. The segmented instances of the forward, dq and dkv
(packed batches, varlen, chunked prefill) are held against their plain
versions at Llama-3-8B's and Gemma-2-9B's widths (``check_segments``: 8
packed sequences against the dense call, bit for bit and in time, 12
ragged sequences causal, non-causal, windowed and softcapped, and the
chunked prefill's fallback layout), and ``varlen_fwd``/``varlen_bwd`` run
as the path "varlen".

Each path checks that every one of its kernels was launched on it, with the
counts set to 0 just before it. Exits non-zero if any phase fails or no card
is present; its last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_REQUESTS = 8
MAX_NEW = 32
PAGE_SIZE = 64
TOTAL_PAGES = 512
MAX_BATCH = 8
MAX_SEQ = 4096
# Dense bf16 FLOP/s and HBM bytes/s of each card this script knows, from
# NVIDIA's data sheets; the first entry whose name is in
# torch.cuda.get_device_name() is taken, and any other card fails the run.
PEAKS = (("H200", 989e12, 4.8e12), ("H100 NVL", 835e12, 3.9e12),
         ("H100 PCIe", 756e12, 2.0e12), ("H100 80GB HBM3", 989e12, 3.35e12),
         ("H100 SXM", 989e12, 3.35e12))
PEAK = {}  # "flops", "bytes": this card's, set by main()
# bf16 O gates: the repo's own (tests/test_flash_fwd.py:117, 8x the fp16
# gates for 3 fewer mantissa bits); the kernel rounds P to bf16 before P.V,
# as the TPU kernel did. LSE is fp32: tests/test_flash_fwd.py:21's gates.
O_TOLS = {"atol": 4e-2, "mean_atol": 2e-3, "mean_rtol": 5e-2}
LSE_TOLS = {"atol": 1e-2, "mean_atol": 1e-3, "mean_rtol": 1e-2}
# Prefill-vs-decode logits: both paths round activations to bf16 (8
# significant bits) at every projection of 32 layers, in different orders
# (one batched GEMM against a GEMV, flash against paged attention), so they
# agree to a few percent, not to fp32 precision.
CONSISTENCY_REL_L2 = 5e-2
# Backward kernels at the training shapes: the repo's bf16 backward gates
# (tests/test_flash_bwd.py:127). D is an fp32 sum of exact products, held to
# the fp32 statistics gates (tests/test_flash_fwd.py:21).
BWD_TOLS = {"atol": 4e-2, "mean_atol": 2e-3, "mean_rtol": 2e-1}
DI_TOLS = LSE_TOLS
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS = 3  # timed steps; one more runs under the profiler
# Plain SGD, p -= LR * g, in bf16. A weight near 2^-6 (the scale of a
# 4096-wide projection) moves only in steps of 2^-13 = 1.2e-4, so a smaller
# update is rounded away. An lm_head entry's gradient is about
# x_d / (2 * 2048) = 2.4e-4 for a target seen once in the batch, so LR = 1
# moves it by about two steps, and raises each target's logit by about
# |x|^2 / 4096 = 1 per step.
LR = 1.0
# Mixtral at 8 layers overshoots at LR = 1 (the loss after the 4th step,
# 11.71, lies above the first, 10.87: the router's update moves whole
# tokens between experts); at a quarter of it the loss falls every step.
MIX_LR = 0.25
# Train forward = inference forward: the same kernels in the same order.
TRAIN_FWD_REL = 1e-5
# 2-layer full-width card (bf16) vs CPU (fp32) training check: bf16 rounds
# activations, logits and every gradient to 8 significant bits, so the loss
# agrees to about 1e-3 and each gradient to a few percent in relative L2.
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
# Mixtral-8x7B at full width, depth cut to fit the 80 GB card: 32 layers of
# bf16 weights take 93 GB (2.90 GB a layer, 2.82 GB of it experts), so
# serving keeps 16 layers (47 GB of weights) and training 8 (24 GB of
# weights and 24 GB of gradients).
MIX_SERVE_LAYERS = 16
MIX_TRAIN_LAYERS = 8
# Grouped matmuls: kernel and plain version round one fp32 sum to bf16, so
# they differ by the summation order (1 ulp at most): the bf16 backward
# gates, with inputs scaled to outputs of about unit size.
GMM_TOLS = BWD_TOLS
# Card bf16 against CPU fp32 routing: a token whose top-2 set differs is
# masked out of the 1-layer loss check; more than this share fails.
MAX_FLIP_SHARE = 0.10
# prompts of the Mixtral prefill-vs-decode check
MIX_CONSISTENCY_PROMPTS = 4
# Weight-only quantized serving, in this order
QUANT_BITS = (8, 4)
# Mistral-7B-v0.1 (window 4096 on every layer), full width and depth: 8
# requests whose windows bind in prefill and decode (4600 frees a block of
# pages during decode, 4090 crosses the window during decode), and training
# on 1 x 8192, where the window binds for the second half of the rows.
MISTRAL_PROMPT_LENS = (7700, 6144, 4600, 4090, 2048, 1024, 512, 129)
MISTRAL_MAX_SEQ = 8192
MISTRAL_TRAIN = (1, 8192)
# Consistency configs: Mistral at 2 layers with its window cut to 64, and
# tiny_gemma2 at 4 layers (d 128, every Gemma-2 extra), window every layer
# and every second layer; prompts longer than the window. The Gemma-2
# config is also served, one prompt long enough for window page
# reclamation (8 pages of 64 tokens behind a window of 64).
WINDOW_CUT = 64
# Card greedy token = CPU greedy token wherever the CPU's top-2 gap exceeds
# this many times the largest card-vs-CPU logit error of the pass.
GREEDY_MARGIN = 4
CONSISTENCY_LENS = (300, 200)
GEMMA_LAYERS = 4
# Random weights give attention scores and logits of about unit scale,
# where Gemma-2's caps (50 and 30) move the logits by 2e-3 in rel L2, below
# the card-vs-CPU gate; at 5 and 3 each moves them by about 0.11, so a path
# without either cap fails that gate.
GEMMA_CAPS = dict(attn_softcap=5.0, final_softcap=3.0)
GEMMA_PROMPT_LENS = (700, 300, 129, 65)
GEMMA_MAX_SEQ = 1024
# Gemma-2-9B (head dim 256, a 4096-token window on every second layer,
# softcaps 50 and 30), full width and depth: served with Mistral's traffic
# (MISTRAL_PROMPT_LENS, max_seq_len 8192; the window binds in prefill on the
# local layers, and every page stays live for the global ones) and trained
# on 1 x 8192. Its consistency runs at its widths with 2 layers (one local,
# one global), the window cut to WINDOW_CUT and the binding GEMMA_CAPS; the
# card's logits at the served prompts' last positions are held to the CPU's
# there (rel L2 <= CONSISTENCY_REL_L2), a gate a wrong kernel fails where a
# greedy token on random weights may not.
GEMMA2_LAYERS_CHECK = 2
# 2-layer quantized Llama, card (bf16 activations through qmm) against CPU
# (fp32 activations through the plain version) on the same QuantizedTensors:
# the weights are identical, so the two differ by the bf16 rounding of the
# activations at every projection, as prefill and decode do (see
# CONSISTENCY_REL_L2): a few percent at most.
QUANT_CARD_CPU_REL_L2 = CONSISTENCY_REL_L2
# The quantized KV cache (int8 and fp8 e4m3 pages with per-token scales in
# (8, 128) fp32 tiles): Llama-3-8B served at full width and depth with bf16
# weights, the bf16 serve's traffic and its 32,768 token slots, in pages of
# 128 tokens (the scale tile's lanes). Its cache dtypes by name, set by
# main().
KV_QUANT_PAGE_SIZE = 128
KV_QUANT_PAGES = TOTAL_PAGES * PAGE_SIZE // KV_QUANT_PAGE_SIZE
KV_QUANT = {}
# layers of the d-256 (Gemma-2-9B's widths) and d-64 quantized paged pools
PAGED_QUANT_LAYERS = (16, 4)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class WindowPages:
    """Called after every engine step of a model with a window on every
    layer: each running request must hold exactly the pages the JAX
    engine's rule leaves it (``flash_attention_tpu/serving/engine.py``:
    whole blocks of 8 pages behind the window are holes or freed), counted
    here from its length alone."""

    PPB = 8  # the JAX paged kernel's pages_per_block

    def __init__(self, window: int | None, page_size: int):
        """``window`` None: a model with global layers, which holds every
        page of every running request (the JAX engine reclaims only when
        every layer slides)."""
        self.window, self.ps = window, page_size
        self.first = self.last = None
        self.freed_in_decode = 0

    def want(self, n: int) -> int:
        if self.window is None:
            return -(-n // self.ps)
        blk = self.PPB * self.ps
        return -(-n // self.ps) - max(n - self.window, 0) // blk * self.PPB

    def __call__(self, eng):
        held = {}
        for r in eng.sched.running:
            if r.slot < 0:
                continue
            n = eng.rt.seq_length(r.slot)
            pages = -(-n // self.ps)
            live = sum(p >= 0 for p in eng.rt.seq_page_table(r.slot, pages,
                                                             pad=-1))
            assert live == self.want(n), (r.uid, n, live, self.want(n))
            held[r.uid] = (n, live, pages)
        if self.last is not None:
            # held before + pages appended - held now
            self.freed_in_decode += sum(
                self.last[u][1] + held[u][2] - self.last[u][2] - held[u][1]
                for u in held if u in self.last)
        if held:
            self.first = self.first or held
            self.last = held

    def report(self, model: str) -> str:
        def line(h):
            return (f"{sum(v[1] for v in h.values())} pages held by "
                    f"{len(h)} requests (without reclamation "
                    f"{sum(v[2] for v in h.values())}; per request (length, "
                    f"held): {[v[:2] for v in h.values()]})")
        return (f"{model} window pages, JAX's rule held after every step: "
                f"after admission {line(self.first)}; at the last decode "
                f"step {line(self.last)}; pages freed during decode "
                f"{self.freed_in_decode}")


def _time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_graph_ms(torch, fn, iters: int) -> float:
    """Mean device ms per call, with ``iters`` calls captured in one CUDA
    graph: for a kernel shorter than its host-side launch, timing eager
    calls would measure the Python wrapper, not the card."""
    return _time_graph_calls_ms(torch, [fn] * iters)


# A decode step reads every weight once, so a decode-shaped product finds
# its weight cold: it is timed over a rotation of distinct copies whose
# bytes together exceed twice the card's 50 MB L2.
COLD_BYTES = 100e6


def _time_cold_ms(torch, fn, operands, min_calls: int = 20) -> float:
    """Mean device ms per call of ``fn(operand)``, the calls rotating over
    ``operands`` (at least ``min_calls`` of them), captured in one CUDA
    graph: with operands larger than the L2 together, each call reads its
    operand from device memory."""
    calls = [operands[i % len(operands)]
             for i in range(max(min_calls, len(operands)))]
    return _time_graph_calls_ms(torch, [lambda o=o: fn(o) for o in calls])


def _time_graph_calls_ms(torch, fns) -> float:
    """Mean device ms per call of the calls ``fns``, all captured in order
    in one CUDA graph."""
    fns[0]()  # warm-up outside the capture (builds, first allocations)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    return _time_ms(torch, graph.replay, 5) / len(fns)


def _host_us(torch, fn, calls: int = 1000, batch: int = 100) -> float:
    """Mean host wall (us) of ``calls`` eager calls of ``fn``, issued in
    batches behind a long device sleep, so that no call waits for the
    card: the wrapper's own time, not the kernel's."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of device time
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e6


def _peaks(name: str) -> tuple[float, float]:
    for key, flops, nbytes in PEAKS:
        if key in name:
            return flops, nbytes
    raise SystemExit(f"chip_smoke: no data-sheet peaks for {name!r}; add "
                     f"the card to PEAKS")


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK["flops"], nbytes / PEAK["bytes"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


# kernels built on csrc/hopper_common.cuh: their SASS must hold warpgroup
# matrix multiplies (HGMMA) and TMA loads (UTMALDG), and ptxas must report
# no spill and no serialized wgmma (C75xx) for them
HOPPER_KERNELS = ("flash_fwd", "flash_bwd_di", "flash_bwd_dq", "flash_bwd_dkv",
                  "qmm", "gmm", "gmm_dw", "paged_attention")


def _sass_counts(build, kernel) -> dict[str, dict[str, int]]:
    """HGMMA and UTMALDG instructions in each kernel function of a built
    library's SASS (by its template arguments), read with the toolkit's
    cuobjdump (beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(kernel.lib_path())],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        tmpl = re.search(r"kernel(I.*)EEv", name)
        counts[tmpl.group(1) if tmpl else name] = {
            op: part.count(op) for op in ("HGMMA", "UTMALDG")}
    return counts


# HGMMA and UTMALDG counts, by head dim, of the attention kernels before
# their window and softcap modes (the same for fp16 and bf16): each
# no-softcap instance (template argument CAP false, "Lb0E") must keep them,
# and each softcap instance must hold both ops. The d-256 instances' counts
# are those of their own tile designs. The segmented instances (a last
# template argument SEG true) of flash_fwd, dq and dkv run the same
# products and loads, so their no-softcap instances must show the same.
SASS_NO_CAP = {"flash_fwd": {64: (24, 3), 128: (32, 6), 256: (40, 12)},
               "flash_bwd_dq": {64: (24, 4), 128: (40, 8), 256: (72, 16)},
               "flash_bwd_dkv": {64: (16, 4), 128: (24, 8), 256: (40, 16)},
               "paged_attention": {64: (8, 4), 128: (12, 8), 256: (20, 16)}}


SEG_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _check_cap_instances(name, per_fn):
    """Hold each instance of an attention kernel to SASS_NO_CAP. The paged
    kernel's last template argument is its page type (0: q's; 1 int8 and 2
    fp8, bf16 q only); its quantized instances are new designs, held only
    to having wgmma and TMA."""
    seen = []
    paged = name == "paged_attention"
    for fn, c in per_fn.items():
        m = re.fullmatch(r"I\w+?Li(\d+)ELb([01])E(?:Lb([01])E)?"
                         r"(?:Li([012])E)?", fn)
        assert m, f"{name}: unexpected instance {fn}"
        assert (m.group(3) is not None) == (name in SEG_KERNELS), fn
        assert (m.group(4) is not None) == paged, fn
        got = (c["HGMMA"], c["UTMALDG"])
        assert all(got), f"{name} {fn}: no wgmma or TMA in SASS"
        if m.group(2) == "0" and m.group(4) in (None, "0"):
            want = SASS_NO_CAP[name][int(m.group(1))]
            assert got == want, f"{name} {fn}: SASS counts {got}, not {want}"
        seen.append(m.groups())
    per_d = 2 * 2 * (2 if name in SEG_KERNELS or paged else 1)
    assert len(seen) == per_d * len(SASS_NO_CAP[name]), (name, seen)


def _prompts(vocab: int, lens=None):
    """The 8 prompts: the same lengths for every model (or ``lens``), ids
    below its vocab."""
    rng = np.random.default_rng(SEED)
    drawn = rng.integers(128, 2049, size=N_REQUESTS)
    return [list(map(int, rng.integers(0, vocab, size=n)))
            for n in (drawn if lens is None else lens)]


def check_flash(torch, dev, bucket, cfg, card):
    """The forward kernel at the prefill shape (b 8, causal and not) and the
    training shape (b 2 x 2048, causal) against its plain version, with two
    runs bit-identical, and SDPA (its backend named) as the yardstick."""
    from flash_attention_tpu_torch.ops import flash_fwd as fm
    from flash_attention_tpu_torch.ops.reference import reference_attention
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = d**-0.5

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    shapes, backend = {}, None
    for label, b, s, causal in (("prefill b8 causal", MAX_BATCH, bucket, True),
                                ("prefill b8 non-causal", MAX_BATCH, bucket,
                                 False),
                                ("train b2 causal", TRAIN_BATCH, TRAIN_SEQ,
                                 True)):
        q, k, v = rnd(b, s, h, d), rnd(b, s, hk, d), rnd(b, s, hk, d)
        o, lse = fm.flash_fwd(q, k, v, causal=causal, sm_scale=scale)
        o_ref, lse_ref = reference_attention(q, k, v, causal=causal)
        m = assert_metrics(f"flash_fwd {label}", o, o_ref, O_TOLS)
        assert_metrics(f"flash_fwd {label} lse", lse, lse_ref, LSE_TOLS)
        del o_ref, lse_ref
        o2, lse2 = fm.flash_fwd(q, k, v, causal=causal, sm_scale=scale)
        assert torch.equal(o, o2) and torch.equal(lse, lse2), \
            f"flash_fwd {label}: two runs differ"
        ms = _time_ms(torch, lambda: fm.flash_fwd(q, k, v, causal=causal,
                                                  sm_scale=scale), 20)
        plain = _time_ms(torch, lambda: reference_attention(
            q, k, v, causal=causal), 3, warmup=1)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)
        lib = _time_ms(torch, sdpa, 20)
        if backend is None:
            backend = _sdpa_profile(torch, sdpa)[1]
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4.0 * d * pairs * b * h
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + o.numel()) \
            + 4 * lse.numel()
        bound_ms, bound_by = _bound(flops, nbytes)
        print(f"flash_fwd {label} b={b} s={s} h={h}/{hk} d={d}: {m}; two runs "
              f"bit-identical; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s, {bound_ms / ms:.1%} of the bound), plain "
              f"{plain:.3f} ms, sdpa {lib:.4f} ms ({ms / lib:.2f}x), bound "
              f"{bound_ms:.4f} ms ({bound_by}) [{card}]")
        shapes[label] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib,
                         "max_abs_err": m.max_abs}
        del q, k, v, o, lse, o2, lse2
    print(f"flash_fwd yardstick: scaled_dot_product_attention(enable_gqa=True)"
          f", backend {backend} [{card}]")
    # causal with sq > sk: the first sq - sk rows see no key
    qs, ks_, vs_ = rnd(2, 1024, h, d), rnd(2, 512, hk, d), rnd(2, 512, hk, d)
    o, lse = fm.flash_fwd(qs, ks_, vs_, causal=True, sm_scale=scale)
    o_ref, lse_ref = reference_attention(qs, ks_, vs_, causal=True)
    m = assert_metrics("flash_fwd sq>sk", o, o_ref, O_TOLS)
    assert_metrics("flash_fwd sq>sk lse", lse, lse_ref, LSE_TOLS)
    assert torch.all(o[:, :512] == 0) and torch.all(lse[:, :, :512] == 0)
    print(f"flash_fwd sq=1024 sk=512 causal (512 empty rows -> O=0, LSE=0): {m}")
    main = shapes["prefill b8 causal"]  # the prefill path runs causal
    return {"name": "flash_fwd", "route": "cuda",
            "source": "flash_attention_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "flash_attention_tpu/ops/flash_fwd.py:74", **main,
            "library": f"scaled_dot_product_attention(enable_gqa=True), "
                       f"backend {backend.split(' ')[0]}",
            "shapes": shapes}


def _random_pool(torch, g, dev, shape):
    """A bf16 page pool of unit normals, one layer's fp32 draw at a time."""
    pool = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    for i in range(shape[0]):
        pool[i].copy_(torch.randn(pool[i].shape, generator=g, device=dev))
    return pool


def check_kv_write(torch, dev, cfg, card):
    from flash_attention_tpu_torch.ops import kv_update as kv
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    L, hk, d, b = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, MAX_BATCH
    kp, vp = (_random_pool(torch, g, dev, (L, hk, TOTAL_PAGES, PAGE_SIZE, d))
              for _ in range(2))
    kval = torch.randn((b, hk, d), generator=g, device=dev).to(torch.bfloat16)
    vval = torch.randn((b, hk, d), generator=g, device=dev).to(torch.bfloat16)
    trash = TOTAL_PAGES - 1
    pages = torch.randperm(TOTAL_PAGES - 1, generator=g, device=dev)[:b]
    pages[-2:] = trash  # two padding rows share the trash page
    wpage = pages.to(torch.int32)
    woff = torch.randint(0, PAGE_SIZE, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    layer = L // 2
    kref, vref = kp.clone(), vp.clone()
    kv.write_token_kv_reference(kref, vref, kval, vval, wpage, woff, layer)
    kv.write_token_kv(kp, vp, None, None, kval, vval, None, None, wpage, woff,
                      layer=layer)
    err = 0.0
    for got, want in ((kp, kref), (vp, vref)):
        want[:, :, trash] = got[:, :, trash]  # the racing rows' target
        bad = got != want
        if bad.any():
            err = max(err, float((got[bad].float() - want[bad].float())
                                 .abs().max()))
    assert err == 0.0, f"kv write differs from its plain version: {err}"
    del kref, vref
    ms = _time_graph_ms(torch, lambda: kv.write_token_kv(
        kp, vp, None, None, kval, vval, None, None, wpage, woff, layer=layer),
        100)
    plain = _time_graph_ms(torch, lambda: kv.write_token_kv_reference(
        kp, vp, kval, vval, wpage, woff, layer), 100)
    idx = (wpage.long(), woff.long())

    def library():  # one index_put_ per pool, as a user would write it
        kp[layer].permute(1, 2, 0, 3).index_put_(idx, kval)
        vp[layer].permute(1, 2, 0, 3).index_put_(idx, vval)
    lib = _time_graph_ms(torch, library, 100)
    nbytes = 2 * 2 * kval.numel() * 2 + 8 * b  # read + write K and V rows
    bound_ms, bound_by = _bound(0.0, nbytes)
    print(f"kv_write L={L} b={b} hk={hk} d={d} (trash page shared by 2 rows): "
          f"max_abs_err {err}; device time in a CUDA graph: kernel {ms:.5f} "
          f"ms, plain {plain:.5f} ms, index_put_ (K and V) {lib:.5f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    return {"name": "kv_write", "route": "cuda",
            "source": "flash_attention_tpu_torch/csrc/kv_update.cu",
            "replaces": "flash_attention_tpu/ops/kv_update.py:36",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib}


def check_paged(torch, dev, cfg, card, max_seq=MAX_SEQ, served=None):
    """The paged kernel against its plain version at lengths linspace(1,
    max_seq, 8), then cold over the L layers of a decode step there and at
    the served decode lengths: ``served`` (prompt lengths) plus 16, or the
    serving prompts' when None."""
    from flash_attention_tpu_torch.ops import paged_attention as pa
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    L, h, hk, d, b = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, MAX_BATCH)
    pps = max_seq // PAGE_SIZE
    total = max(TOTAL_PAGES, b * pps)
    kp, vp = (_random_pool(torch, g, dev, (L, hk, total, PAGE_SIZE, d))
              for _ in range(2))
    q = torch.randn((b, h, d), generator=g, device=dev).to(torch.bfloat16)
    tables = torch.randperm(total, generator=g, device=dev)[:b * pps]
    tables = tables.reshape(b, pps).to(torch.int32)
    lens = np.linspace(1, max_seq, b).astype(np.int32)
    lengths = torch.from_numpy(lens).to(dev)
    layer = L - 1
    o = pa.paged_attention(q, kp, vp, lengths, tables, layer=layer)
    o_ref = pa.paged_attention_reference(q, kp, vp, lengths, tables,
                                         layer=layer)
    m = assert_metrics("paged_attention", o, o_ref, O_TOLS)
    ms = _time_ms(torch, lambda: pa.paged_attention(
        q, kp, vp, lengths, tables, layer=layer), 100)
    plain = _time_ms(torch, lambda: pa.paged_attention_reference(
        q, kp, vp, lengths, tables, layer=layer), 5, warmup=1)
    tokens = int(lens.sum())
    pages_read = int(sum(-(-int(n) // PAGE_SIZE) for n in lens))
    nbytes = tokens * hk * d * 2 * 2 + 2 * 2 * q.numel() + 4 * (b + pages_read)
    flops = 4.0 * tokens * h * d
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"paged_attention L={L} b={b} h={h}/{hk} d={d} ps={PAGE_SIZE} "
          f"lengths={lens.tolist()}: {m}; kernel {ms:.4f} ms "
          f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    # Cold, as a decode step finds its pages: the L calls of one step, each
    # on another layer's pages, in one CUDA graph. At the lengths above and
    # at the served decode lengths (the serving prompts plus 16 tokens).
    shapes = {"eager, one layer (L2 warm in part)": {
        "ms": ms, "bound_ms": bound_ms}}
    served = np.asarray(served if served is not None else
                        [len(p) for p in _prompts(cfg.vocab_size)]) + 16
    for label, ls in ((f"linspace(1, {max_seq}, 8)", lens),
                      ("served decode (prompts + 16)", served)):
        lt = torch.from_numpy(ls.astype(np.int32)).to(dev)
        n_tok = int(ls.sum())
        n_pages = int(sum(-(-int(n) // PAGE_SIZE) for n in ls))
        nb = n_tok * hk * d * 2 * 2 + 2 * 2 * q.numel() + 4 * (b + n_pages)
        bms, _ = _bound(4.0 * n_tok * h * d, nb)
        cold = _time_graph_calls_ms(torch, [
            lambda i=i, lt=lt: pa.paged_attention(q, kp, vp, lt, tables,
                                                  layer=i)
            for i in range(L)])
        shapes[f"cold, {label}"] = {"ms": cold, "bound_ms": bms}
        print(f"paged_attention cold ({L} layers in a CUDA graph), lengths "
              f"{ls.tolist()}: {cold:.5f} ms ({nb / cold / 1e6:.1f} GB/s, "
              f"{bms / cold:.1%} of the {bms:.5f} ms bound, "
              f"{nb / 1e6:.1f} MB) [{card}]")
    host = _host_us(torch, lambda: pa.paged_attention(
        q, kp, vp, lengths, tables, layer=layer))
    print(f"paged_attention wrapper host time: {host:.2f} us a call (mean "
          f"of 1000 eager calls, the card kept busy) [{card}]")
    main = shapes[f"cold, linspace(1, {max_seq}, 8)"]
    return {"name": "paged_attention", "route": "cuda",
            "source": "flash_attention_tpu_torch/csrc/paged_attention.cu",
            "replaces": "flash_attention_tpu/ops/paged_attention.py:74",
            "max_abs_err": m.max_abs, "ms": main["ms"], "plain_ms": plain,
            "bound_ms": main["bound_ms"], "bound_by": bound_by,
            "library_ms": None, "host_us": host, "shapes": shapes}


def _device_kernels(torch, fn, calls: int = 10) -> tuple[float, dict]:
    """Device ms per call of ``fn`` (the summed durations of the device
    kernels its ``calls`` calls launched: no host pacing) and those
    durations (us) by kernel name. Profiled over 10 calls: a later profiler
    session in one process missed the device events of a single short
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a session now and then records no device event at all (seen on the
    # grouped-matmul yardstick at decode): profile again, up to 3 sessions
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                times[e.name] = (times.get(e.name, 0.0)
                                 + e.time_range.elapsed_us())
        if times:
            return sum(times.values()) / calls / 1e3, times
    raise AssertionError("the profiler saw no device kernels in 3 sessions")


def _sdpa_profile(torch, fn, calls: int = 10) -> tuple[float, str]:
    """Device ms per call of ``fn`` and the SDPA backend its kernels name."""
    ms, times = _device_kernels(torch, fn, calls)
    text = " ".join(times).lower()
    backend = ("cuDNN" if "cudnn" in text else "flash" if "flash" in text
               else "efficient" if "fmha" in text or "efficient" in text
               else "math")
    top = sorted(times, key=times.get, reverse=True)[:3]
    return ms, f"{backend} (longest kernels: {'; '.join(n[:70] for n in top)})"


def check_bwd(torch, dev, cfg, card):
    """The three backward kernels at the training path's shapes, each
    against its plain version; two runs bit-identical; sk = 1 exactly 0.
    Times each kernel causal (the training path) and not, beside the SDPA
    backward's device time on the same inputs."""
    from flash_attention_tpu_torch.ops import flash_bwd as fb
    from flash_attention_tpu_torch.ops import flash_fwd as fm
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    q, k, v, do = rnd(b, s, h, d), rnd(b, s, hk, d), rnd(b, s, hk, d), \
        rnd(b, s, h, d)
    scale = d**-0.5
    # one key: O equals its V row, so dP - D must cancel exactly
    o1, lse1 = fm.flash_fwd(q, k[:, :1], v[:, :1], causal=False,
                            sm_scale=scale)
    dq1, dk1, _ = fb.flash_bwd(q, k[:, :1], v[:, :1], o1, lse1, do,
                               causal=False, sm_scale=scale)
    assert torch.all(dq1 == 0) and torch.all(dk1 == 0), \
        "sk = 1: dq and dk are not exactly 0"
    print("flash_bwd sk=1: dq and dk exactly 0")
    del o1, lse1, dq1, dk1

    n_in = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) \
        + 4 * 2 * b * h * s  # bf16 tensors, fp32 LSE and D
    shapes = {"flash_bwd_di": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    errs = {}
    for causal in (True, False):
        label = f"train b{b} {'causal' if causal else 'non-causal'}"
        kw = dict(causal=causal, sm_scale=scale)
        o, lse = fm.flash_fwd(q, k, v, **kw)
        di = fb.flash_bwd_di(o, do)
        di_r = fb.di_reference(o, do)
        dq = fb.flash_bwd_dq(q, k, v, do, lse, di, **kw)
        dk, dv = fb.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
        if causal:  # the training path's shape: held to the plain versions
            errs["flash_bwd_di"] = assert_metrics("flash_bwd_di", di, di_r,
                                                  DI_TOLS)
            errs["flash_bwd_dq"] = assert_metrics(
                "flash_bwd_dq", dq, fb.dq_reference(q, k, v, do, lse, di_r,
                                                    **kw), BWD_TOLS)
            dk_r, dv_r = fb.dkv_reference(q, k, v, do, lse, di_r, **kw)
            m_dk = assert_metrics("flash_bwd_dkv dk", dk, dk_r, BWD_TOLS)
            m_dv = assert_metrics("flash_bwd_dkv dv", dv, dv_r, BWD_TOLS)
            errs["flash_bwd_dkv"] = max(m_dk, m_dv, key=lambda m: m.max_abs)
            del dk_r, dv_r
            again = fb.flash_bwd(q, k, v, o, lse, do, **kw)
            assert all(torch.equal(a, b_) for a, b_ in
                       zip(again, (dq, dk, dv))), "two backward runs differ"
            print(f"flash_bwd b={b} s={s} h={h}/{hk} d={d} causal: di "
                  f"{errs['flash_bwd_di']}; dq {errs['flash_bwd_dq']}; dk "
                  f"{m_dk}; dv {m_dv}; two runs bit-identical")
            del again

        # the library yardstick for dq + dk + dv: the device time of the
        # backward of one SDPA call on the same inputs
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        with torch.enable_grad():
            out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            sdpa_bwd, backend = _sdpa_profile(
                torch, lambda: torch.autograd.grad(
                    out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        del out, qt, kt, vt
        pairs = (s * (s + 1) // 2 if causal else s * s) * b * h
        runs = {
            "flash_bwd_di": (
                lambda: fb.flash_bwd_di(o, do), lambda: fb.di_reference(o, do),
                lambda: torch.linalg.vecdot(o, do, dim=-1), 2.0 * o.numel(),
                2 * 2 * o.numel() + 4 * di.numel()),
            "flash_bwd_dq": (
                lambda: fb.flash_bwd_dq(q, k, v, do, lse, di, **kw),
                lambda: fb.dq_reference(q, k, v, do, lse, di, **kw), None,
                6.0 * d * pairs, n_in + 2 * dq.numel()),
            "flash_bwd_dkv": (
                lambda: fb.flash_bwd_dkv(q, k, v, do, lse, di, **kw),
                lambda: fb.dkv_reference(q, k, v, do, lse, di, **kw), None,
                8.0 * d * pairs, n_in + 2 * 2 * dk.numel()),
        }
        for name, (kern, plain, lib, flops, nbytes) in runs.items():
            if name == "flash_bwd_di":  # tens of us: device time in a graph
                if not causal:
                    continue  # D does not depend on the mask
                ms = _time_graph_ms(torch, kern, 50)
                plain_ms = _time_graph_ms(torch, plain, 5)
                lib_ms = _time_graph_ms(torch, lib, 50)
            else:
                ms = _time_ms(torch, kern, 20)
                plain_ms = _time_ms(torch, plain, 2, warmup=1)
                lib_ms = sdpa_bwd
            bound_ms, bound_by = _bound(flops, nbytes)
            print(f"{name} b={b} s={s} h={h}/{hk} d={d} {label}: kernel "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{bound_ms / ms:.1%} of the bound), plain {plain_ms:.3f} "
                  f"ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}) [{card}]")
            shapes[name][label] = {"ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bound_ms, "bound_by": bound_by,
                                   "library_ms": lib_ms}
        pair = sum(shapes[n][label]["ms"] for n in ("flash_bwd_dq",
                                                    "flash_bwd_dkv"))
        print(f"flash_bwd {label}: dq + dkv {pair:.4f} ms against the SDPA "
              f"backward's device time {sdpa_bwd:.4f} ms (dq + dk + dv, "
              f"{pair / sdpa_bwd:.2f}x; backend {backend}) [{card}]")
        del o, lse, di, di_r, dq, dk, dv
    print(f"flash_bwd_di times are device times in a CUDA graph of 50 "
          f"calls (5 for the plain version); library for flash_bwd_di: "
          f"torch.linalg.vecdot(o, do) (bf16 out, (b, s, h) layout) [{card}]")
    sources = {"flash_bwd_di": ("flash_bwd_di.cu", 129),
               "flash_bwd_dq": ("flash_bwd_dq.cu", 159),
               "flash_bwd_dkv": ("flash_bwd_dkv.cu", 352)}
    main = f"train b{b} causal"
    return [{"name": name, "route": "cuda",
             "source": f"flash_attention_tpu_torch/csrc/{src}",
             "replaces": f"flash_attention_tpu/ops/flash_bwd.py:{line}",
             "max_abs_err": errs[name].max_abs, **shapes[name][main],
             "shapes": shapes[name]}
            for name, (src, line) in sources.items()]


# Window and softcap modes of the attention kernels: Mistral's window at its
# full context (b 1, s 8192, W 4096: the band's live area is 0.75 of the
# causal triangle), the softcap at the prefill shape, a two-sided band with
# sq != sk, rows the band leaves without a key, and both modes together.
# The scores scale * q.k of unit-normal q and k are about N(0, 1), so the
# caps are small enough to bind there: cap * tanh(s / cap) differs from s
# by about s^3 / (3 cap^2), which at Gemma-2's cap 50 moves the LSE by about
# 5e-4, under its gate, and a kernel without the cap would pass. At cap 5
# it moves the LSE by about 4e-2; _softcap_controls checks that the gates
# see it.
MISTRAL_W = 4096
WINDOW_CASES = (
    # label, b, sq, sk, causal, window, softcap, timed
    ("window (4095, 0) b1 s8192", 1, 8192, 8192, True, (4095, 0), None, True),
    ("band (128, 64) non-causal b2 sq2048 sk3072", 2, 2048, 3072, False,
     (128, 64), None, False),
    ("band (20, 5) non-causal sq1024 sk300: 719 rows with no key", 1, 1024,
     300, False, (20, 5), None, False),
    ("softcap 5 b8 s2048 causal", 8, 2048, 2048, True, None, 5.0, True),
    ("softcap 3 + window (1023, 0) b2 s4096", 2, 4096, 4096, True,
     (1023, 0), 3.0, False),
)
# The acceptance bounds: the windowed kernels skip the tiles outside the band
WINDOW_FWD_RATIO = 0.85   # fwd, and dq + dkv, windowed / causal
WINDOW_PAGED_RATIO = 0.65  # paged decode, every row 8192, W 4096 / none
PAGED_CAP = 5.0  # binds at unit-scale scores, as in WINDOW_CASES


def _plain_by_kv_head(torch, fn, q, k, v, *per_head, **kw):
    """``fn`` on one kv head and its query heads at a time, outputs joined
    on the head dims: the plain versions' (b, h, sq, sk) scores of 32 heads
    at s 8192 would take 8.6 GB each in fp32 (17 GB in float64). Tensors in
    ``per_head`` are (b, s, h, d) like q or (b, h, s) like LSE."""
    hk, g = k.shape[2], q.shape[2] // k.shape[2]
    outs = []
    for i in range(hk):
        sl = slice(i * g, (i + 1) * g)
        rest = [x[:, sl] if x.dim() == 3 else x[:, :, sl] for x in per_head]
        outs.append(fn(q[:, :, sl], k[:, :, i:i + 1], v[:, :, i:i + 1],
                       *[x.contiguous() for x in rest], **kw))
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    joined = tuple(torch.cat(parts, dim=1 if parts[0].dim() == 3 else 2)
                   for parts in zip(*outs))
    return joined if len(joined) > 1 else joined[0]


def _ulp_tols(torch, tols, ref):
    """``tols`` with atol no tighter than one ulp of ``ref``'s dtype at its
    largest magnitude: kernel and plain version each round an fp32 sum to
    that dtype once, so they may differ by one ulp there (at unit dO a
    narrow band's dV reaches 8 to 16, where a bf16 ulp is 6.25e-2)."""
    top = float(ref.abs().max())
    if top == 0:
        return tols
    ulp = torch.finfo(ref.dtype).eps * 2.0 ** math.floor(math.log2(top))
    return {**tols, "atol": max(tols["atol"], ulp)}


def _straight_through_grads(torch, q, k, v, do, *, causal, sm_scale, window,
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


def _softcap_controls(torch, q, k, v, do, kw, refs, label):
    """The gates the softcap instances passed must catch, on the same
    inputs, a kernel that ignores the softcap (the no-softcap instances of
    the forward and both backward kernels: LSE, dq, dk and dv) and a
    backward that drops the factor 1 - t^2 (the straight-through plain
    backward: dq and dk; dV does not depend on it)."""
    from flash_attention_tpu_torch.ops import flash_bwd as fb
    from flash_attention_tpu_torch.ops import flash_fwd as fm
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    lse_r, dq_r, dk_r, dv_r = refs
    nocap = {**kw, "softcap": None}
    with torch.inference_mode():
        o0, lse0 = fm.flash_fwd(q, k, v, empty_lse=-1.0, **nocap)
    di0 = fb.flash_bwd_di(o0, do)
    dq0 = fb.flash_bwd_dq(q, k, v, do, lse0, di0, **nocap)
    dk0, dv0 = fb.flash_bwd_dkv(q, k, v, do, lse0, di0, **nocap)
    st = _plain_by_kv_head(torch, functools.partial(_straight_through_grads,
                                                    torch), q, k, v, do, **kw)
    checks = (("no-softcap kernel's LSE", lse0, lse_r, LSE_TOLS),
              ("no-softcap kernels' dq", dq0, dq_r, None),
              ("no-softcap kernels' dk", dk0, dk_r, None),
              ("no-softcap kernels' dv", dv0, dv_r, None),
              ("backward without 1 - t^2: dq", st[0], dq_r, None),
              ("backward without 1 - t^2: dk", st[1], dk_r, None))
    for name, x, ref, tols in checks:
        try:
            assert_metrics(name, x.to(ref.dtype), ref,
                           tols or _ulp_tols(torch, BWD_TOLS, ref))
        except AssertionError as e:
            print(f"  control {label}: caught the {name}: "
                  f"{str(e).split(': ', 1)[1].split(' (')[0]}")
            continue
        raise AssertionError(f"{label}: the gates do not catch the {name}")
    del o0, lse0, di0, dq0, dk0, dv0, st


def _band_pairs(torch, dev, sq, sk, causal, window):
    """Live (row, key) pairs of the band: the work a kernel that skips the
    dead tiles must do."""
    from flash_attention_tpu_torch.ops.reference import _build_mask
    mask = _build_mask(sq, sk, causal, window, device=dev)
    return int(mask.sum()) if mask is not None else sq * sk


def check_window_softcap(torch, dev, cfg, card):
    """The forward, dq and dkv kernels' window and softcap modes against
    their plain versions, at WINDOW_CASES; the timed cases beside the same
    kernels without the mode on the same inputs (the windowed ones bounded
    by WINDOW_FWD_RATIO), and SDPA with the band as a boolean mask as the
    window's library yardstick (no PyTorch call takes a softcap). Returns
    {kernel: {label: numbers}} for the kernel table."""
    from flash_attention_tpu_torch.ops import flash_bwd as fb
    from flash_attention_tpu_torch.ops import flash_fwd as fm
    from flash_attention_tpu_torch.ops.reference import (_build_mask,
                                                         reference_attention)
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = d**-0.5
    out = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    for label, b, sq, sk, causal, window, cap, timed in WINDOW_CASES:
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d)
        do = rnd(b, sq, h, d)
        kw = dict(causal=causal, sm_scale=scale, window=window, softcap=cap)
        with torch.inference_mode():
            o, lse = fm.flash_fwd(q, k, v, empty_lse=-1.0, **kw)
            o_r, lse_r = _plain_by_kv_head(
                torch, reference_attention, q, k, v, causal=causal,
                sm_scale=scale, window=window, softcap=cap, empty_lse=-1.0)
        m = assert_metrics(f"flash_fwd {label}", o, o_r, O_TOLS)
        assert_metrics(f"flash_fwd {label} lse", lse, lse_r, LSE_TOLS)
        mask = _build_mask(sq, sk, causal, window, device=dev)
        empty = ~mask.any(-1) if mask is not None else \
            torch.zeros(sq, dtype=torch.bool, device=dev)
        assert torch.all(o[:, empty] == 0) and \
            torch.all(lse[:, :, empty] == -1.0), label
        del o_r
        di = fb.flash_bwd_di(o, do)
        di_r = fb.di_reference(o, do)
        dq = fb.flash_bwd_dq(q, k, v, do, lse, di, **kw)
        dk, dv = fb.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
        dq_r = _plain_by_kv_head(torch, fb.dq_reference, q, k, v, do, lse,
                                 di_r, **kw)
        m_dq = assert_metrics(f"flash_bwd_dq {label}", dq, dq_r,
                              _ulp_tols(torch, BWD_TOLS, dq_r))
        dk_r, dv_r = _plain_by_kv_head(torch, fb.dkv_reference, q, k, v, do,
                                       lse, di_r, **kw)
        m_dk = assert_metrics(f"flash_bwd_dkv {label} dk", dk, dk_r,
                              _ulp_tols(torch, BWD_TOLS, dk_r))
        m_dv = assert_metrics(f"flash_bwd_dkv {label} dv", dv, dv_r,
                              _ulp_tols(torch, BWD_TOLS, dv_r))
        if cap is not None:
            _softcap_controls(torch, q, k, v, do, kw,
                              (lse_r, dq_r, dk_r, dv_r), label)
        del lse_r, dq_r, dk_r, dv_r
        assert torch.all(dq[:, empty] == 0), label
        print(f"window/softcap {label} h={h}/{hk} d={d}: fwd {m}; dq {m_dq}; "
              f"dk {m_dk}; dv {m_dv}; rows with no key: {int(empty.sum())} "
              f"(O = 0, LSE = empty_lse, dq = 0)")
        errs = {"flash_fwd": m.max_abs, "flash_bwd_dq": m_dq.max_abs,
                "flash_bwd_dkv": max(m_dk.max_abs, m_dv.max_abs)}
        if not timed:
            for name, err in errs.items():
                out[name][label] = {"max_abs_err": err}
            continue

        # timed: the mode against the same kernel without it, in turns
        base = dict(causal=causal, sm_scale=scale)
        with torch.inference_mode():
            o0, lse0 = fm.flash_fwd(q, k, v, **base)
        di0 = fb.flash_bwd_di(o0, do)
        runs = {
            "flash_fwd": (lambda: fm.flash_fwd(q, k, v, **kw),
                          lambda: fm.flash_fwd(q, k, v, **base)),
            "flash_bwd_dq": (
                lambda: fb.flash_bwd_dq(q, k, v, do, lse, di, **kw),
                lambda: fb.flash_bwd_dq(q, k, v, do, lse0, di0, **base)),
            "flash_bwd_dkv": (
                lambda: fb.flash_bwd_dkv(q, k, v, do, lse, di, **kw),
                lambda: fb.flash_bwd_dkv(q, k, v, do, lse0, di0, **base)),
        }
        times = {}
        for name, (mode, plain_mode) in runs.items():
            a1, b1 = _time_ms(torch, mode, 20), _time_ms(torch, plain_mode, 20)
            b2, a2 = _time_ms(torch, plain_mode, 20), _time_ms(torch, mode, 20)
            times[name] = (min(a1, a2), min(b1, b2))
        plain = {
            "flash_fwd": _time_ms(torch, lambda: _plain_by_kv_head(
                torch, reference_attention, q, k, v, causal=causal,
                sm_scale=scale, window=window, softcap=cap), 1, warmup=0),
            "flash_bwd_dq": _time_ms(torch, lambda: _plain_by_kv_head(
                torch, fb.dq_reference, q, k, v, do, lse, di_r, **kw), 1,
                warmup=0),
            "flash_bwd_dkv": _time_ms(torch, lambda: _plain_by_kv_head(
                torch, fb.dkv_reference, q, k, v, do, lse, di_r, **kw), 1,
                warmup=0),
        }
        lib, backend = {}, "none (no PyTorch call takes a softcap)"
        if cap is None:
            # SDPA with the band as a boolean mask, K/V heads expanded
            qt = q.transpose(1, 2)
            kt = k.repeat_interleave(h // hk, 2).transpose(1, 2)
            vt = v.repeat_interleave(h // hk, 2).transpose(1, 2)

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)
            try:
                lib["flash_fwd"], backend = _sdpa_profile(torch, sdpa)
                qg, kg, vg = (x.detach().requires_grad_() for x in
                              (qt, kt, vt))
                with torch.enable_grad():
                    y = torch.nn.functional.scaled_dot_product_attention(
                        qg, kg, vg, attn_mask=mask)
                    lib["flash_bwd_dq"], bwd_backend = _sdpa_profile(
                        torch, lambda: torch.autograd.grad(
                            y, (qg, kg, vg), do.transpose(1, 2),
                            retain_graph=True))
                lib["flash_bwd_dkv"] = lib["flash_bwd_dq"]
                backend += f"; backward {bwd_backend}"
                del qg, kg, vg, y
            except RuntimeError as e:  # a yardstick only: record why not
                backend = f"not measured ({str(e).splitlines()[0][:120]})"
            del qt, kt, vt
        pairs = _band_pairs(torch, dev, sq, sk, causal, window) * b * h
        n_in = 2 * (q.numel() + k.numel() + v.numel())
        flops = {"flash_fwd": 4.0 * d * pairs, "flash_bwd_dq": 6.0 * d * pairs,
                 "flash_bwd_dkv": 8.0 * d * pairs}
        nbytes = {"flash_fwd": n_in + 2 * o.numel() + 4 * lse.numel(),
                  "flash_bwd_dq": n_in + 2 * do.numel() + 8 * lse.numel()
                  + 2 * dq.numel(),
                  "flash_bwd_dkv": n_in + 2 * do.numel() + 8 * lse.numel()
                  + 4 * dk.numel()}
        for name, (ms, ms0) in times.items():
            bound_ms, bound_by = _bound(flops[name], nbytes[name])
            out[name][label] = {
                "ms": ms, "plain_ms": plain[name], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib.get(name),
                "max_abs_err": errs[name],
                "ms_without_mode": ms0, "ratio_to_without": ms / ms0}
            print(f"{name} {label}: kernel {ms:.4f} ms ({flops[name] / ms / 1e9:.1f}"
                  f" TFLOP/s, {bound_ms / ms:.1%} of the bound {bound_ms:.4f} ms"
                  f" ({bound_by}), live pairs {pairs}); the same kernel without"
                  f" the {'window' if cap is None else 'softcap'} {ms0:.4f} ms"
                  f" ({ms / ms0:.3f}x); plain {plain[name]:.3f} ms; library "
                  f"{lib.get(name)} [{card}]")
        if cap is None:
            fwd_ratio = times["flash_fwd"][0] / times["flash_fwd"][1]
            bwd_ratio = (times["flash_bwd_dq"][0] + times["flash_bwd_dkv"][0]) \
                / (times["flash_bwd_dq"][1] + times["flash_bwd_dkv"][1])
            print(f"{label}: forward {fwd_ratio:.3f}x and dq + dkv "
                  f"{bwd_ratio:.3f}x the causal call's time (bound "
                  f"{WINDOW_FWD_RATIO}; live area "
                  f"{pairs / (b * h * sq * (sq + 1) / 2):.3f}); library: "
                  f"scaled_dot_product_attention(attn_mask=band), K/V heads "
                  f"expanded, backend {backend} [{card}]")
            assert fwd_ratio <= WINDOW_FWD_RATIO, fwd_ratio
            assert bwd_ratio <= WINDOW_FWD_RATIO, bwd_ratio
        del o0, lse0, di0
        del q, k, v, do, o, lse, di, di_r, dq, dk, dv
        torch.cuda.empty_cache()
    return out


def check_paged_window(torch, dev, cfg, card):
    """The paged kernel's window and softcap: lengths linspace(1, 8192, 8)
    against the plain version, with the entries of pages wholly behind the
    window as holes (-1) and every page the layer's rows do not read NaN;
    then cold (32 layers in a CUDA graph) with every row at 8192: W 4096
    against no window (bounded by WINDOW_PAGED_RATIO), and the softcap.
    Returns {label: numbers} for the kernel table."""
    from flash_attention_tpu_torch.ops import paged_attention as pa
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    L, h, hk, d, b = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, MAX_BATCH)
    ps, pps = PAGE_SIZE, MISTRAL_MAX_SEQ // PAGE_SIZE
    total = b * pps + 8
    kp, vp = (_random_pool(torch, g, dev, (L, hk, total, ps, d))
              for _ in range(2))
    q = torch.randn((b, h, d), generator=g, device=dev).to(torch.bfloat16)
    tables = torch.randperm(total, generator=g, device=dev)[:b * pps]
    tables = tables.reshape(b, pps).to(torch.int32)

    def holed(lens, w):
        """The table with holes for pages wholly behind each row's window,
        and which pages the rows read."""
        tab = tables.clone()
        read = torch.zeros(total, dtype=torch.bool, device=dev)
        for i, n in enumerate(lens):
            first = max(int(n) - w, 0) // ps
            tab[i, :first] = -1
            read[tables[i, first:-(-int(n) // ps)].long()] = True
        return tab, read

    out = {}
    layer = L - 1
    lens = np.linspace(1, MISTRAL_MAX_SEQ, b).astype(np.int32)
    lengths = torch.from_numpy(lens).to(dev)
    for w, cap in ((MISTRAL_W, None), (MISTRAL_W, PAGED_CAP),
                   (None, PAGED_CAP)):
        o_ref = pa.paged_attention_reference(
            q, kp, vp, lengths, tables, window=w, softcap=cap, layer=layer)
        tab, read = holed(lens, w or 10**9)
        saved = kp[layer].clone(), vp[layer].clone()
        kp[layer][:, ~read] = float("nan")
        vp[layer][:, ~read] = float("nan")
        o = pa.paged_attention(q, kp, vp, lengths, tab, window=w, softcap=cap,
                               layer=layer)
        kp[layer].copy_(saved[0])
        vp[layer].copy_(saved[1])
        del saved
        label = f"window {w} softcap {cap} lengths linspace(1, 8192, 8)"
        m = assert_metrics(f"paged_attention {label}", o, o_ref, O_TOLS)
        control = ""
        if cap is not None:  # the gate catches a kernel without the cap
            o0 = pa.paged_attention(q, kp, vp, lengths, tab, window=w,
                                    layer=layer)
            try:
                assert_metrics("no-softcap instance", o0, o_ref, O_TOLS)
            except AssertionError:
                control = "; the no-softcap instance fails the gate"
            else:
                raise AssertionError(f"{label}: the gate does not catch "
                                     f"the no-softcap instance")
        print(f"paged_attention {label}: {m}; {int((tab < 0).sum())} hole "
              f"entries, unread pages NaN{control}")
        out[label] = {"max_abs_err": m.max_abs}

    full = np.full(b, MISTRAL_MAX_SEQ, np.int32)
    lengths = torch.from_numpy(full).to(dev)
    tab, _ = holed(full, MISTRAL_W)

    def cold(**kw):
        tb = kw.pop("tab", tables)
        return _time_graph_calls_ms(torch, [
            lambda i=i: pa.paged_attention(q, kp, vp, lengths, tb, layer=i,
                                           **kw)
            for i in range(L)])

    runs = {"none": dict(), "window": dict(window=MISTRAL_W, tab=tab),
            "softcap": dict(softcap=PAGED_CAP)}
    times = {n: [] for n in runs}
    for n in list(runs) + list(runs)[::-1]:
        times[n].append(cold(**dict(runs[n])))
    ms = {n: min(t) for n, t in times.items()}
    plain = _time_ms(torch, lambda: pa.paged_attention_reference(
        q, kp, vp, lengths, tables, window=MISTRAL_W, layer=layer), 2,
        warmup=1)
    for n, tokens in (("none", MISTRAL_MAX_SEQ), ("window", MISTRAL_W),
                      ("softcap", MISTRAL_MAX_SEQ)):
        n_tok = tokens * b
        nb = n_tok * hk * d * 2 * 2 + 2 * 2 * q.numel() \
            + 4 * (b + n_tok // ps)
        bms, bby = _bound(4.0 * n_tok * h * d, nb)
        label = {"none": "cold, every row 8192, no window",
                 "window": f"cold, every row 8192, window {MISTRAL_W}",
                 "softcap": f"cold, every row 8192, softcap "
                            f"{PAGED_CAP:g}"}[n]
        out[label] = {"ms": ms[n], "bound_ms": bms, "bound_by": bby,
                      "library_ms": None,
                      **({"plain_ms": plain} if n == "window" else {})}
        print(f"paged_attention {label} (L{L} b{b} h{h}/{hk} d{d}): "
              f"{' / '.join(f'{t:.5f}' for t in times[n])} ms "
              f"({nb / ms[n] / 1e6:.1f} GB/s, {bms / ms[n]:.1%} of the "
              f"{bms:.5f} ms bound) [{card}]")
    ratio = ms["window"] / ms["none"]
    print(f"paged_attention window {MISTRAL_W} at 8192: {ratio:.3f}x the "
          f"no-window call (bound {WINDOW_PAGED_RATIO}); plain version "
          f"(one layer, eager) {plain:.3f} ms [{card}]")
    assert ratio <= WINDOW_PAGED_RATIO, ratio
    del kp, vp
    torch.cuda.empty_cache()
    return out


def check_head_dim_256(torch, dev, cfg, card):
    """Every attention kernel's d-256 instance at Gemma-2-9B's widths (h
    16/8) against its plain version, with the gates, controls and timings
    of the d-128 phases: the forward at the prefill shape b8 s2048 (the
    FLOPs of Llama-3-8B's b8 s2048 h32/8 d128) and the training shape b2
    s2048, the backward at the training shape, the kv write, paged decode at
    linspace(1, 8192, 8) and the served lengths, and the window and softcap
    modes (WINDOW_CASES, and paged decode with every row at 8192, with and
    without the window). Returns {kernel: {"d256 <label>": numbers}}."""
    out = {}

    def add(name, shapes):
        out.setdefault(name, {}).update(
            {f"d256 {label}": nums for label, nums in shapes.items()})

    with torch.inference_mode():
        add("flash_fwd", check_flash(torch, dev, 2048, cfg, card)["shapes"])
        kv = check_kv_write(torch, dev, cfg, card)
        add("kv_write", {"decode b8": {k: kv[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")}})
        paged = check_paged(torch, dev, cfg, card, max_seq=MISTRAL_MAX_SEQ,
                            served=MISTRAL_PROMPT_LENS)
        add("paged_attention", paged["shapes"])
    torch.cuda.empty_cache()
    for e in check_bwd(torch, dev, cfg, card):
        add(e["name"], e["shapes"])
    torch.cuda.empty_cache()
    for name, shapes in check_window_softcap(torch, dev, cfg, card).items():
        add(name, shapes)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        add("paged_attention", check_paged_window(torch, dev, cfg, card))
    torch.cuda.empty_cache()
    return out


# Segment ids and varlen (check_segments): the segmented instances of the
# forward, dq and dkv kernels against their plain versions, at Llama-3-8B's
# widths (h 32/8, d 128) and Gemma-2-9B's (h 16/8, d 256), bf16:
# (a) 8 packed causal sequences of 2048 against the dense b8 s2048 causal
#     call of the same kernels: the same tiles, so the outputs must agree
#     bit for bit, and the same live work and bound; the packed forward and
#     dq + dkv must take at most SEG_PACKED_RATIO of the dense calls' time
#     (a kernel that ignored the ranges would take about 8x the forward's
#     live tiles: every q block against all 16384 keys);
# (b) SEG_RAGGED_N ragged sequences, lengths drawn from the seed in 1..4096
#     with 1 and 4096 among them and len_k >= len_q in each: causal,
#     non-causal and the window (4095, 0), and at d 256 softcap 5 too;
# (c) the segs of the served chunked prefill's last chunk (b 8, chunk 2048,
#     an 8192-token prefix table): the kv key is not sorted there, so the
#     rows take the full-range fallback.
SEG_PACKED = (8, 2048)
SEG_PACKED_RATIO = 1.5
SEG_RAGGED_N = 12
SEG_MAX_LEN = 4096
SEG_WINDOW = (4095, 0)
SEG_CAP = 5.0
# Llama-3-8B served with chunked prefill: Mistral's traffic, chunks of 2048
CHUNK_SIZE = 2048
CHUNK_REL_L2 = 5e-2  # chunked against unchunked last-position logits
# the Gemma-2 config (window 64 every second layer, softcaps 5/3) chunked
GEMMA_CHUNK = 256


def _ragged_lens(seed: int):
    """SEG_RAGGED_N (len_q, len_k) pairs in 1..SEG_MAX_LEN with len_k >=
    len_q, one q length 1 and one SEG_MAX_LEN."""
    rng = np.random.default_rng(seed)
    lq = rng.integers(1, SEG_MAX_LEN + 1, size=SEG_RAGGED_N)
    lq[0], lq[1] = 1, SEG_MAX_LEN
    lk = np.minimum(lq + rng.integers(0, 512, size=SEG_RAGGED_N), SEG_MAX_LEN)
    return lq, lk


def _seg_pairs(torch, segs, causal, window, rows: int = 1024) -> int:
    """Live (query, key) pairs of a segmented layout: the work the kernels
    must do, counted from the same mask as the plain versions."""
    from flash_attention_tpu_torch.ops.reference import _build_mask
    q_seg, kv_seg, q_pos, kv_pos = segs
    total = 0
    for r0 in range(0, q_seg.shape[1], rows):
        sl = slice(r0, r0 + rows)
        mask = _build_mask(0, 0, causal, window,
                           segs=(q_seg[:, sl], kv_seg, q_pos[:, sl], kv_pos))
        total += int(mask.sum())
    return total


def _timed_once(torch, fn):
    """(fn(), its ms by CUDA events): a plain version, run once."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _varlen_library(torch, q, k, v, cu_q, cu_k, lq, lk, causal,
                    window=None):
    """The device ms of torch.nn.attention.varlen.varlen_attn on the same
    packed inputs, a yardstick only; (None, why) where this torch lacks it
    or refuses the call. Its causal and window are (left, right) windows in
    newer torch (``window_size``) and a flag in older."""
    import inspect
    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError:
        return None, "torch.nn.attention.varlen.varlen_attn is absent"
    params = inspect.signature(varlen_attn).parameters
    kw, kx, vx = {}, k[0], v[0]
    if "enable_gqa" in params:
        kw["enable_gqa"] = True
    else:
        g = q.shape[2] // k.shape[2]
        kx, vx = kx.repeat_interleave(g, 1), vx.repeat_interleave(g, 1)
    if "window_size" in params:
        left = -1 if window is None else window[0]
        kw["window_size"] = (left, 0 if causal else -1)
    elif window is not None:
        return None, "varlen_attn takes no window in this torch"
    else:
        kw["is_causal"] = causal
    cq, ck = cu_q.to(q.device, torch.int32), cu_k.to(q.device, torch.int32)

    def call():
        return varlen_attn(q[0], kx, vx, cq, ck, int(max(lq)), int(max(lk)),
                           **kw)
    try:
        call()
        torch.cuda.synchronize()
        return _time_ms(torch, call, 10), f"varlen_attn({kw})"
    except Exception as e:  # a yardstick only: report why it is missing
        return None, f"varlen_attn refused: {str(e).splitlines()[0][:120]}"


def _seg_kernel_ms(torch, call, kernel, d, segs, causal, direction,
                   iters: int = 10) -> tuple[float, float]:
    """(kernel ms, block ranges ms): device times of a segmented wrapper's
    call in a CUDA graph, less the same block ranges alone (the wrapper's
    few small torch ops on the segs, which ``kernel``'s tiles size), so the
    kernel is timed apart from its host time and its ranges."""
    from flash_attention_tpu_torch.ops import flash_fwd as fm
    from flash_attention_tpu_torch.ops import segments
    q_seg, kv_seg, q_pos, kv_pos = segs
    args = (q_seg, q_pos, kv_seg, kv_pos) if direction == "kv_le_q" \
        else (kv_seg, kv_pos, q_seg, q_pos)
    tiles = fm.seg_tiles(kernel, d)
    ranges = _time_graph_ms(torch, lambda: segments.block_ranges(
        *args, *tiles, causal=causal, causal_dir=direction), iters)
    return _time_graph_ms(torch, call, iters) - ranges, ranges


def _seg_bound(torch, segs, causal, window, q, k):
    """{kernel: (bound ms, bound_by, live pairs)} of a segmented call."""
    pairs = _seg_pairs(torch, segs, causal, window) * q.shape[2]
    d = q.shape[-1]
    n_in = 2 * (q.numel() + 2 * k.numel())
    rows = q.shape[0] * q.shape[1] * q.shape[2]
    out = {}
    for name, mult, nbytes in (
            ("flash_fwd", 4.0, n_in + 2 * q.numel() + 4 * rows),
            ("flash_bwd_dq", 6.0, n_in + 2 * 2 * q.numel() + 8 * rows),
            ("flash_bwd_dkv", 8.0, n_in + 2 * q.numel() + 8 * rows
             + 4 * k.numel())):
        out[name] = (*_bound(mult * d * pairs, nbytes), pairs)
    return out


def _check_seg_case(torch, label, q, k, v, do, segs, kw, card, out,
                    library=(None, "")):
    """One segmented case: forward, D, dq and dkv against their plain
    versions (the backward from the plain version's D), each kernel timed
    beside its plain version's one run; numbers into ``out``."""
    from flash_attention_tpu_torch.ops import flash_bwd as fb
    from flash_attention_tpu_torch.ops import flash_fwd as fm
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    kw = dict(kw, segs=segs)
    with torch.inference_mode():
        o, lse = fm.flash_fwd(q, k, v, empty_lse=-1.0, **kw)
        (o_r, lse_r), plain_fwd = _timed_once(
            torch, lambda: fm.flash_fwd_segmented_reference(
                q, k, v, empty_lse=-1.0, **kw))
    m = assert_metrics(f"flash_fwd {label}", o, o_r, O_TOLS)
    assert_metrics(f"flash_fwd {label} lse", lse, lse_r, LSE_TOLS)
    dead = segs[0] < 0
    assert torch.all(o[dead] == 0) and torch.all(
        lse.transpose(1, 2)[dead] == -1.0), label
    del o_r, lse_r
    di = fb.flash_bwd_di(o, do)
    di_r = fb.di_reference(o, do)
    dq = fb.flash_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    dq_r, plain_dq = _timed_once(torch, lambda: fb.dq_reference(
        q, k, v, do, lse, di_r, **kw))
    m_dq = assert_metrics(f"flash_bwd_dq {label}", dq, dq_r,
                          _ulp_tols(torch, BWD_TOLS, dq_r))
    del dq_r
    (dk_r, dv_r), plain_dkv = _timed_once(torch, lambda: fb.dkv_reference(
        q, k, v, do, lse, di_r, **kw))
    m_dk = assert_metrics(f"flash_bwd_dkv {label} dk", dk, dk_r,
                          _ulp_tols(torch, BWD_TOLS, dk_r))
    m_dv = assert_metrics(f"flash_bwd_dkv {label} dv", dv, dv_r,
                          _ulp_tols(torch, BWD_TOLS, dv_r))
    del dk_r, dv_r
    assert torch.all(dq[dead] == 0), label
    d, causal = q.shape[-1], kw["causal"]
    times = {
        "flash_fwd": (*_seg_kernel_ms(
            torch, lambda: fm.flash_fwd(q, k, v, **kw), fm.KERNEL, d, segs,
            causal, "kv_le_q"), plain_fwd, m.max_abs),
        "flash_bwd_dq": (*_seg_kernel_ms(
            torch, lambda: fb.flash_bwd_dq(q, k, v, do, lse, di, **kw),
            fb.DQ_KERNEL, d, segs, causal, "kv_le_q"), plain_dq, m_dq.max_abs),
        "flash_bwd_dkv": (*_seg_kernel_ms(
            torch, lambda: fb.flash_bwd_dkv(q, k, v, do, lse, di, **kw),
            fb.DKV_KERNEL, d, segs, causal, "q_ge_kv"), plain_dkv,
            max(m_dk.max_abs, m_dv.max_abs)),
    }
    bounds = _seg_bound(torch, segs, kw["causal"], kw.get("window"), q, k)
    for name, (ms, ranges_ms, plain, err) in times.items():
        bound_ms, bound_by, pairs = bounds[name]
        lib = library[0] if name == "flash_fwd" else None
        out[name][label] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib,
                            "max_abs_err": err, "ranges_ms": ranges_ms}
        print(f"{name} {label}: kernel {ms:.4f} ms ({bound_ms / ms:.1%} of "
              f"the bound {bound_ms:.4f} ms ({bound_by}), live pairs "
              f"{pairs}); its block ranges {ranges_ms:.4f} ms; plain "
              f"{plain:.3f} ms; library "
              f"{'null' if lib is None else f'{lib:.4f} ms'} [{card}]")
    print(f"segmented {label}: fwd {m}; dq {m_dq}; dk {m_dk}; dv {m_dv}; "
          f"rows with no key: {int(dead.sum())} (O = 0, LSE = empty_lse, "
          f"dq = 0); yardstick: {library[1] or 'none'}")
    return o, lse, dq, dk, dv


def _chunk_segs(torch, dev, lens, chunk):
    """The (q_seg, kv_seg, q_pos, kv_pos) prefill_chunk builds for the last
    chunk of prompts of ``lens`` (b = len(lens)), with the engine's
    power-of-two prefix table: what the chunked engine's last dispatch
    gives the segmented forward."""
    lens = torch.tensor(lens, device=dev)
    base = (int(lens.max()) - 1) // chunk * chunk
    done = lens.clamp(max=base)
    clen = (lens - base).clamp(0, chunk)
    pages = max(1, -(-base // PAGE_SIZE))
    pref = (1 << (pages - 1).bit_length()) * PAGE_SIZE
    b = lens.shape[0]
    idx = torch.arange(chunk, device=dev)
    positions = done[:, None] + idx
    kv_pos_prefix = torch.arange(pref, device=dev).expand(b, pref)
    live = idx < clen[:, None]
    kv_seg = torch.cat([torch.where(kv_pos_prefix < done[:, None], 0, -1),
                        torch.where(live, 0, -1)], 1)
    kv_pos = torch.cat([kv_pos_prefix, positions], 1)
    return tuple(t.int() for t in (torch.where(live, 0, -2), kv_seg,
                                   positions, kv_pos))


def check_segments(torch, dev, cfg, card, tag, kernels, paths=None):
    """The segmented forward, dq and dkv at ``cfg``'s widths: (a) packed
    against dense, bit for bit and in time (SEG_PACKED_RATIO), (b) ragged
    varlen causal, non-causal, windowed (and at d 256 softcapped), (c) the
    served chunked prefill's fallback segs; each against its plain version.
    With ``paths`` the library's entry points varlen_fwd and varlen_bwd run
    on (b)'s causal inputs as the path "varlen", with the launch counts set
    to 0 first and their outputs held to the kernels' bit for bit. Returns
    {kernel: {"<tag> seg <label>": numbers}}."""
    import flash_attention_tpu_torch as ft
    from flash_attention_tpu_torch.ops import flash_bwd as fb
    from flash_attention_tpu_torch.ops import flash_fwd as fm
    from flash_attention_tpu_torch.ops.attention import _varlen_segs
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = d**-0.5
    out = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    # (a) packed against dense
    b, s = SEG_PACKED
    q, k, v, do = rnd(b, s, h, d), rnd(b, s, hk, d), rnd(b, s, hk, d), \
        rnd(b, s, h, d)
    seg = (torch.arange(b * s, device=dev, dtype=torch.int32) // s)[None]
    pos = (torch.arange(b * s, device=dev, dtype=torch.int32) % s)[None]
    segs = (seg, seg, pos, pos)
    packed = [x.reshape(1, b * s, *x.shape[2:]) for x in (q, k, v, do)]
    kw = dict(causal=True, sm_scale=scale)
    with torch.inference_mode():
        o, lse = fm.flash_fwd(q, k, v, **kw)
        o_s, lse_s = fm.flash_fwd(*packed[:3], segs=segs, **kw)
    assert torch.equal(o_s.view(o.shape), o) and torch.equal(
        lse_s.view(1, h, b, s).transpose(0, 2)[:, :, 0], lse), \
        "packed forward differs from the dense one"
    di = fb.flash_bwd_di(o, do)
    dense = (fb.flash_bwd_dq(q, k, v, do, lse, di, **kw),
             *fb.flash_bwd_dkv(q, k, v, do, lse, di, **kw))
    di_s = di.view(b, h, s).transpose(0, 1).reshape(1, h, b * s)
    seg_kw = dict(kw, segs=segs)
    got = (fb.flash_bwd_dq(*packed[:3], packed[3], lse_s, di_s, **seg_kw),
           *fb.flash_bwd_dkv(*packed[:3], packed[3], lse_s, di_s, **seg_kw))
    for name, x, y in zip(("dq", "dk", "dv"), got, dense):
        assert torch.equal(x.view(y.shape), y), f"packed {name} differs"
    seg_calls = {  # entry name: (segmented call, its kernel, direction)
        "flash_fwd": (lambda: fm.flash_fwd(*packed[:3], segs=segs, **kw),
                      fm.KERNEL, "kv_le_q"),
        "flash_bwd_dq": (lambda: fb.flash_bwd_dq(
            *packed[:3], packed[3], lse_s, di_s, **seg_kw), fb.DQ_KERNEL,
            "kv_le_q"),
        "flash_bwd_dkv": (lambda: fb.flash_bwd_dkv(
            *packed[:3], packed[3], lse_s, di_s, **seg_kw), fb.DKV_KERNEL,
            "q_ge_kv"),
    }
    dense_calls = {
        "flash_fwd": lambda: fm.flash_fwd(q, k, v, **kw),
        "flash_bwd_dq": lambda: fb.flash_bwd_dq(q, k, v, do, lse, di, **kw),
        "flash_bwd_dkv": lambda: fb.flash_bwd_dkv(q, k, v, do, lse, di, **kw),
    }
    parts = {"fwd": ("flash_fwd",),
             "dq + dkv": ("flash_bwd_dq", "flash_bwd_dkv")}
    label = f"{tag} seg packed {b}x{s} causal"
    lens = np.full(b, s)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]))
    lib, lib_note = _varlen_library(torch, *packed[:3], cu, cu, lens, lens,
                                    True)
    bounds = _seg_bound(torch, segs, True, None, packed[0], packed[1])
    for part, entry_names in parts.items():
        # device times in CUDA graphs, in turns: segmented, dense, dense,
        # segmented; the segmented kernels less their block ranges
        per = {}
        for seg_turn in (True, False, False, True):
            for n in entry_names:
                if seg_turn:
                    call, kern, direction = seg_calls[n]
                    t, r = _seg_kernel_ms(torch, call, kern, d, segs, True,
                                          direction)
                    per.setdefault(("ranges", n), []).append(r)
                else:
                    t = _time_graph_ms(torch, dense_calls[n], 10)
                per.setdefault((seg_turn, n), []).append(t)
        best = {key: min(v) for key, v in per.items()}
        ms = sum(best[(True, n)] for n in entry_names)
        ms0 = sum(best[(False, n)] for n in entry_names)
        ranges = sum(best[("ranges", n)] for n in entry_names)
        bound_ms = sum(bounds[n][0] for n in entry_names)
        print(f"{tag} packed {b} x {s} causal {part}: segmented kernels "
              f"{ms:.4f} ms, dense b{b} s{s} {ms0:.4f} ms ({ms / ms0:.3f}x; "
              f"bound {SEG_PACKED_RATIO}); the segmented wrappers' block "
              f"ranges {ranges:.4f} ms more; live-work bound {bound_ms:.4f} "
              f"ms ({bound_ms / ms:.1%} of it); outputs bit-identical; "
              f"yardstick {lib_note}: "
              f"{'null' if lib is None else f'{lib:.4f} ms'} [{card}]")
        assert ms / ms0 <= SEG_PACKED_RATIO, (part, ms / ms0)
        for n in entry_names:
            bound_n, by, _ = bounds[n]
            out[n][label] = {"ms": best[(True, n)], "bound_ms": bound_n,
                             "bound_by": by,
                             "library_ms": lib if n == "flash_fwd" else None,
                             "max_abs_err": 0.0,
                             "ranges_ms": best[("ranges", n)],
                             "dense_ms": best[(False, n)],
                             "ratio_to_dense": ms / ms0}
    del q, k, v, do, o, lse, o_s, lse_s, di, di_s, dense, got, packed
    torch.cuda.empty_cache()

    # (b) ragged varlen
    lq, lk = _ragged_lens(SEED + d)
    cu_q = torch.tensor(np.concatenate([[0], np.cumsum(lq)]))
    cu_k = torch.tensor(np.concatenate([[0], np.cumsum(lk)]))
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    segs = tuple(x.to(dev) for x in _varlen_segs(cu_q, cu_k, tq, tk))
    q, k, v, do = rnd(1, tq, h, d), rnd(1, tk, hk, d), rnd(1, tk, hk, d), \
        rnd(1, tq, h, d)
    modes = [("causal", True, None, None), ("non-causal", False, None, None),
             (f"window {SEG_WINDOW}", True, SEG_WINDOW, None)]
    if d == 256:
        modes.append((f"softcap {SEG_CAP:g}", True, None, SEG_CAP))
    print(f"{tag} ragged varlen: {SEG_RAGGED_N} sequences, len_q "
          f"{lq.tolist()}, len_k {lk.tolist()} (total {tq} / {tk})")
    for name, causal, window, cap in modes:
        label = f"{tag} seg ragged {SEG_RAGGED_N} {name}"
        kw = dict(causal=causal, sm_scale=scale, window=window, softcap=cap)
        lib = (None, "none (no PyTorch call takes a softcap)")
        if cap is None:
            lib = _varlen_library(torch, q, k, v, cu_q, cu_k, lq, lk, causal,
                                  window)
        res = _check_seg_case(torch, label, q, k, v, do, segs, kw, card, out,
                              lib)
        if paths is not None and name == "causal":
            # the library's entry points on the same inputs: the path
            for kern in kernels:
                kern.launches = 0
            o3, lse3 = ft.varlen_fwd(q[0], k[0], v[0], cu_q, cu_k,
                                     is_causal=True)
            grads = ft.varlen_bwd(q[0], k[0], v[0], o3, lse3, do[0], cu_q,
                                  cu_k, is_causal=True)
            torch.cuda.synchronize()
            paths["varlen"] = {kern.name: kern.launches for kern in kernels}
            want = (res[0][0], res[1][0], res[2][0], res[3][0], res[4][0])
            assert all(torch.equal(x, y) for x, y in zip(
                (o3, lse3, *grads), want)), "varlen_* differ from the kernels"
            print(f"varlen path: varlen_fwd and varlen_bwd on the ragged "
                  f"inputs, outputs bit-identical to the kernels'; launches "
                  f"{paths['varlen']}")
        del res
    del q, k, v, do
    torch.cuda.empty_cache()

    # (c) the served chunked prefill's last chunk: the fallback
    segs = _chunk_segs(torch, dev, MISTRAL_PROMPT_LENS, CHUNK_SIZE)
    b, c = segs[0].shape
    sk = segs[1].shape[1]
    q, do = rnd(b, c, h, d), rnd(b, c, h, d)
    k, v = rnd(b, sk, hk, d), rnd(b, sk, hk, d)
    label = f"{tag} seg chunk b{b} c{c} prefix {sk - c} (fallback)"
    _check_seg_case(torch, label, q, k, v, do, segs,
                    dict(causal=True, sm_scale=scale), card, out)
    del q, k, v, do
    torch.cuda.empty_cache()
    return out


class _RangeLog:
    """Records the forward's block ranges while a chunked engine runs
    (``segments.block_ranges`` wrapped): for each call, (lo, hi) of every
    row's query blocks."""

    def __enter__(self):
        from flash_attention_tpu_torch.ops import segments
        self.mod, self.orig, self.calls = segments, segments.block_ranges, []

        def logged(*args, **kw):
            lo, hi = self.orig(*args, **kw)
            if kw.get("causal_dir") == "kv_le_q":
                self.calls.append((lo, hi, -(-args[2].shape[1] // args[5])))
            return lo, hi
        segments.block_ranges = logged
        return self

    def __exit__(self, *exc):
        self.mod.block_ranges = self.orig

    def report(self, n_layers: int) -> list[str]:
        """Per chunk (the first layer's call), each row's range: "full"
        (the whole kv, the unsorted-key fallback), "narrowed" or "empty",
        and the kv tiles loaded against the full range's."""
        lines = []
        for i, (lo, hi, n_kv) in enumerate(self.calls[::n_layers]):
            tiles = (hi - lo + 1).clamp(min=0)
            kinds = []
            for r in range(lo.shape[0]):
                if int(tiles[r].sum()) == 0:
                    kinds.append("empty")
                elif bool((lo[r] == 0).all() and (hi[r] == n_kv - 1).all()):
                    kinds.append("full (fallback)")
                else:
                    kinds.append("narrowed")
            lines.append(f"chunk {i}: rows {kinds}; kv tiles loaded "
                         f"{int(tiles.sum())} of {tiles.numel() * n_kv}")
        return lines


class _SampleLog:
    """Records the logits of an engine's first ``n`` ``_sample_batch``
    calls, with the tokens sampled from them: in a run that admits every
    request at once, the prefill's last positions (``rows``), then the
    decode steps'."""

    def __init__(self, eng, n: int = 1):
        self.calls, orig = [], eng._sample_batch

        def sample(reqs, logits):
            toks = orig(reqs, logits)
            if len(self.calls) < n:
                self.calls.append((logits[:len(reqs)].float().cpu(), toks))
            return toks
        eng._sample_batch = sample

    @property
    def rows(self):
        return self.calls[0][0] if self.calls else None


def _rel(torch, x, y) -> float:
    return float((x - y).norm() / y.norm())


def serve_chunked(torch, params, cfg, prompts, card, kernels, model,
                  chunk=CHUNK_SIZE, max_seq=MISTRAL_MAX_SEQ):
    """The prompts through Engine(chunk_size=chunk) and through an
    unchunked engine, with exact launch counts: tokens/s, peak memory, the
    ranges each chunk took, and the chunked engine's last-position prefill
    logits held to the unchunked ones (rel L2 <= CHUNK_REL_L2). Returns
    (the chunked path's launches, the chunked and the unchunked engine's
    last-position prefill logits)."""
    from flash_attention_tpu_torch import Engine
    out = {}
    L = cfg.n_layers
    for cs in (chunk, None):
        eng = Engine(cfg, params, total_pages=TOTAL_PAGES, page_size=PAGE_SIZE,
                     max_batch=MAX_BATCH, max_seq_len=max_seq,
                     native_allocator=True, chunk_size=cs)
        rec = _SampleLog(eng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        with _RangeLog() as ranges:
            reqs = [eng.add_request(p, MAX_NEW) for p in prompts]
            eng.run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {kern.name: kern.launches for kern in kernels}
        peak = torch.cuda.max_memory_allocated()
        for r in reqs:
            assert r.error is None, f"request {r.uid} failed: {r.error}"
            assert len(r.output) == MAX_NEW, (r.uid, len(r.output))
        st = eng.throughput()
        name = f"{model} {'chunked ' + str(cs) if cs else 'unchunked'}"
        fwd_calls = st.get("prefill_chunks", st["prefill_dispatches"])
        assert launches["flash_fwd"] == L * fwd_calls > 0, launches
        assert launches["kv_update"] == L * st["decode_steps"] > 0, launches
        assert launches["paged_attention"] == L * st["decode_steps"]
        if cs:
            assert st["prefill_chunks"] > 1 and len(ranges.calls) == \
                L * st["prefill_chunks"], (st, len(ranges.calls))
        print(f"{name} L{L}: served {len(reqs)} requests ({sum(map(len, prompts))}"
              f" prompt tokens) x {MAX_NEW} tokens in {wall:.3f} s; prefill "
              f"tokens/s {st['prefill_tokens_per_s']:.1f} "
              f"({st['prefill_dispatches']} dispatches"
              f"{', ' + str(st['prefill_chunks']) + ' chunks' if cs else ''})"
              f"; decode tokens/s {st['decode_tokens_per_s']:.1f}; peak device"
              f" memory {peak / 2**30:.2f} GiB [{card}]")
        print(f"{name} kernel launches: {launches}")
        for line in ranges.report(L):
            print(f"  {name} ranges, {line}")
        if cs:  # where the time goes: the prompts again, prefill step
            for p in prompts:
                eng.add_request(p, 4)
            profile_window(torch, f"{name} prefill (every chunk) + decode "
                           f"step", eng.step, card)
        out[cs] = (launches, rec.rows, [r.output for r in reqs])
        # the recorder's wrapper ties the engine into a cycle: collect it,
        # or its cache stays on the card into the next phase
        del eng, rec
        gc.collect()
        torch.cuda.empty_cache()
    rows_c, rows_u = out[chunk][1], out[None][1]
    rels = [_rel(torch, a, b) for a, b in zip(rows_c, rows_u)]
    agree = [int(a.argmax()) == int(b.argmax())
             for a, b in zip(rows_c, rows_u)]
    same = sum(x == y for x, y in zip(out[chunk][2], out[None][2]))
    print(f"{model} chunked vs unchunked last-position logits: rel L2 "
          f"{[f'{r:.3e}' for r in rels]} (gate {CHUNK_REL_L2}); greedy first "
          f"token agrees {sum(agree)}/{len(agree)}; whole completions equal "
          f"{same}/{len(prompts)} (printed, not gated: random weights) "
          f"[{card}]")
    assert max(rels) <= CHUNK_REL_L2, rels
    return out[chunk][0], rows_c, rows_u


def chunk_control(torch, params, cfg, prompt, ref_row, card, model,
                  chunk=CHUNK_SIZE):
    """The last chunk of ``prompt`` through prefill_chunk over its prefix's
    pages: its last-position logits held to the unchunked ``ref_row`` (rel
    L2 <= CHUNK_REL_L2), and with ``done`` forced to 0 (the prefix masked
    off) the same gate must fail."""
    from flash_attention_tpu_torch.models import llama
    dev = params["embed"].device
    n = len(prompt)
    base = (n - 1) // chunk * chunk
    toks = torch.tensor([prompt + [0] * (base + chunk - n)], device=dev)
    with torch.inference_mode():
        _, ks, vs = llama.prefill(params, toks[:, :base], cfg,
                                  logit_rows=torch.tensor([base - 1],
                                                          device=dev))
        npg = base // PAGE_SIZE
        kp = torch.zeros((cfg.n_layers, cfg.n_kv_heads, npg, PAGE_SIZE,
                          cfg.head_dim), dtype=ks.dtype, device=dev)
        vp = torch.zeros_like(kp)
        ids = torch.arange(npg, device=dev)
        llama.write_prefill_to_pages(kp, vp, (ks, vs), ids,
                                     torch.zeros_like(ids), ids, PAGE_SIZE)
        del ks, vs
        rels = {}
        for done in (base, 0):
            logits, _, _ = llama.prefill_chunk(
                params, toks[:, base:], torch.tensor([done], device=dev),
                torch.tensor([n - base], device=dev), kp, vp, None, None,
                ids[None], cfg,
                logit_rows=torch.tensor([n - 1 - base], device=dev))
            rels[done] = _rel(torch, logits[0].float().cpu(), ref_row)
    print(f"{model} prompt {n}: its last chunk ({n - base} tokens after "
          f"{base}) against the unchunked logits: rel L2 {rels[base]:.3e}; "
          f"control with done forced to 0 (prefix masked off): "
          f"{rels[0]:.3e} (must fail the gate {CHUNK_REL_L2}) [{card}]")
    assert rels[base] <= CHUNK_REL_L2, rels
    assert rels[0] > CHUNK_REL_L2, "the control passed the gate"
    del kp, vp


def gemma2_chunked(torch, dev, card, kernels):
    """The Gemma-2 config (window 64 on every second layer, softcaps 5/3)
    served chunked (GEMMA_CHUNK) against unchunked on the card, and the
    chunked engine's prefill logits on the card against the CPU's plain
    versions on the same weights. Returns the chunked path's launches."""
    from flash_attention_tpu_torch import Engine
    from flash_attention_tpu_torch.models import llama
    gcfg = llama.LlamaConfig.tiny_gemma2(n_layers=GEMMA_LAYERS,
                                         window_pattern=2, **GEMMA_CAPS)
    model = (f"Gemma-2 config (tiny_gemma2 L{GEMMA_LAYERS}, window "
             f"{gcfg.sliding_window} every 2 layers, softcaps "
             f"{gcfg.attn_softcap:g}/{gcfg.final_softcap:g})")
    params = llama.init_params(gcfg, seed=SEED + 13, device=dev)
    cpu = {n: w.to("cpu", torch.float32) for n, w in params.items()}
    prompts = _prompts(gcfg.vocab_size, GEMMA_PROMPT_LENS)
    launches, rows_c, _ = serve_chunked(torch, params, gcfg, prompts, card,
                                        kernels, model, chunk=GEMMA_CHUNK,
                                        max_seq=GEMMA_MAX_SEQ)
    eng = Engine(gcfg, cpu, total_pages=TOTAL_PAGES, page_size=PAGE_SIZE,
                 max_batch=MAX_BATCH, max_seq_len=GEMMA_MAX_SEQ,
                 chunk_size=GEMMA_CHUNK)
    rec = _SampleLog(eng)
    for p in prompts:
        eng.add_request(p, 1)
    eng.run()
    rels = [_rel(torch, a, b) for a, b in zip(rows_c, rec.rows)]
    del eng, rec
    gc.collect()
    print(f"{model} chunked prefill, card (bf16, kernels) vs CPU (fp32, "
          f"plain versions) last-position logits: rel L2 "
          f"{[f'{r:.3e}' for r in rels]} (gate {CONSISTENCY_REL_L2}) [{card}]")
    assert max(rels) <= CONSISTENCY_REL_L2, rels
    del params, cpu
    return launches


def _moe_layout(torch, moe, dev, g, t, cfg, skip_expert=None):
    """A random top-k routing of t tokens (distinct experts per token) and
    the path's own dispatch of it. Returns (block_expert, n_pad)."""
    scores = torch.rand((t, cfg.n_experts), generator=g, device=dev)
    if skip_expert is not None:
        scores[:, skip_expert] = -1.0  # never among the winners
    ids = scores.topk(cfg.n_experts_per_tok, dim=-1).indices
    _, _, be, n_pad = moe.dispatch(ids, cfg.n_experts)
    return be, n_pad


def _group_offsets(torch, be, n_experts):
    """int32 end row of each expert's (padded) group: the offs of
    torch._grouped_mm over the dispatch buffer."""
    sizes = torch.stack([(be == e).sum() for e in range(n_experts)]) * 128
    return torch.cumsum(sizes, 0).to(torch.int32)


def _library(torch, fn):
    """One library call, or (None, why) when this torch does not take it."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm is absent"
    try:
        fn()
        torch.cuda.synchronize()
        return fn, ""
    except Exception as e:  # a yardstick only: report why it is missing
        return None, f"torch._grouped_mm refused: {str(e).splitlines()[0][:120]}"


GRAPH_NOTE = (" [kernel: device time in a CUDA graph; library: device time"
              " from the profiler]")


def check_gmm(torch, dev, cfg, card):
    """gmm against its plain version at the path's shapes: Mixtral prefill
    (8 x 2048 tokens), decode (8 tokens) and training (2 x 2048 tokens),
    forward and dx through the strided w^T. Dead blocks must be exactly 0."""
    from flash_attention_tpu_torch.ops import moe
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    D, F_, E, k = cfg.dim, cfg.hidden_dim, cfg.n_experts, cfg.n_experts_per_tok

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    # weights scaled for outputs of about half a unit (see GMM_TOLS)
    w_up = rnd(E, D, F_, scale=0.5 * D**-0.5)
    w_down = rnd(E, F_, D, scale=0.5 * F_**-0.5)
    cases = []  # (label, tokens, k_in, w, graph)
    for label, t in (("prefill", MAX_BATCH * 2048), ("decode", MAX_BATCH),
                     ("train", TRAIN_BATCH * TRAIN_SEQ)):
        cases += [(f"{label} gate/up", t, D, w_up),
                  (f"{label} down", t, F_, w_down)]
    # dx = dy . w^T, w^T the strided view of the forward's weight
    cases += [("train dx gate/up", TRAIN_BATCH * TRAIN_SEQ, F_,
               w_up.transpose(1, 2)),
              ("train dx down", TRAIN_BATCH * TRAIN_SEQ, D,
               w_down.transpose(1, 2))]
    entry, shapes = None, {}
    for label, t, k_in, w in cases:
        be, n_pad = _moe_layout(torch, moe, dev, g, t, cfg)
        x = rnd(n_pad, k_in)
        y = moe.gmm(x, w, be)
        want = moe.gmm_reference(x, w, be)
        m = assert_metrics(f"gmm {label}", y, want, GMM_TOLS)
        dead = (be < 0).repeat_interleave(128)
        assert torch.all(y[dead] == 0), f"gmm {label}: dead rows not 0"
        n_dead = int((be < 0).sum())
        del want
        offs = _group_offsets(torch, be, E)
        lib_fn, why = _library(torch, lambda: torch._grouped_mm(x, w,
                                                                offs=offs))
        decode = label.startswith("decode")
        if decode:  # host-bound when eager: device times on both sides
            ms = _time_graph_ms(torch, lambda: moe.gmm(x, w, be), 50)
            # the library call may not be capturable: its kernels' durations
            lib = _device_kernels(torch, lib_fn)[0] if lib_fn else None
        else:
            ms = _time_ms(torch, lambda: moe.gmm(x, w, be), 20)
            lib = _time_ms(torch, lib_fn, 20) if lib_fn else None
        plain = _time_ms(torch, lambda: moe.gmm_reference(x, w, be), 2,
                         warmup=1)
        live_rows = t * k
        live_experts = int((torch.bincount(be[be >= 0].long(),
                                           minlength=E) > 0).sum())
        n_out = w.shape[2]
        flops = 2.0 * live_rows * k_in * n_out
        nbytes = 2 * (live_rows * (k_in + n_out)
                      + live_experts * k_in * n_out) + 4 * be.numel()
        bound_ms, bound_by = _bound(flops, nbytes)
        strided = "" if w.stride(2) == 1 else " (w^T by strides)"
        print(f"gmm {label}{strided}: x ({n_pad}, {k_in}) x w {tuple(w.shape)}"
              f", {be.numel()} blocks ({n_dead} dead), {live_rows} live rows:"
              f" {m}; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s,"
              f" {100 * bound_ms / ms:.1f}% of the bound),"
              f" plain {plain:.3f} ms, library "
              f"{'null' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound_ms:.4f} ms ({bound_by})"
              f"{GRAPH_NOTE if decode else ''}"
              f"{' [' + why + ']' if why else ''} [{card}]")
        shapes[label] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib,
                         "max_abs_err": m.max_abs}
        if label == "prefill gate/up":  # the largest call on the path
            entry = {"name": "gmm", "route": "cuda",
                     "source": "flash_attention_tpu_torch/csrc/gmm.cu",
                     "replaces": "flash_attention_tpu/ops/moe.py:61",
                     "max_abs_err": m.max_abs, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib}
        del x, y
    entry["max_abs_err"] = max(v["max_abs_err"] for v in shapes.values())
    entry["shapes"] = shapes
    return entry


def check_gmm_dw(torch, dev, cfg, card):
    """gmm_dw against its plain version at the training shapes; an expert
    with no rows must get exact zeros, and two runs must be bit-identical."""
    from flash_attention_tpu_torch.ops import moe
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    D, F_, E = cfg.dim, cfg.hidden_dim, cfg.n_experts
    t = TRAIN_BATCH * TRAIN_SEQ
    rows = t * cfg.n_experts_per_tok // E  # rows an expert sums over

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    entry, shapes = None, {}
    for label, k_in, n_out, skip in (("gate/up", D, F_, None),
                                     ("down", F_, D, None),
                                     ("gate/up, expert 0 empty", D, F_, 0)):
        be, n_pad = _moe_layout(torch, moe, dev, g, t, cfg, skip_expert=skip)
        x = rnd(n_pad, k_in)
        dy = rnd(n_pad, n_out, scale=0.5 * rows**-0.5)
        dw = moe.gmm_dw(x, dy, be, E)
        want = moe.gmm_dw_reference(x, dy, be, E)
        m = assert_metrics(f"gmm_dw {label}", dw, want, GMM_TOLS)
        del want
        assert torch.equal(dw, moe.gmm_dw(x, dy, be, E)), \
            f"gmm_dw {label}: two runs differ"
        if skip is not None:
            assert torch.all(dw[skip] == 0), "empty expert: dW is not 0"
            print(f"gmm_dw {label}: dW[{skip}] exactly 0, {m}")
            continue
        offs = _group_offsets(torch, be, E)
        lib_fn, why = _library(torch, lambda: torch._grouped_mm(
            x.t(), dy, offs=offs))
        ms = _time_ms(torch, lambda: moe.gmm_dw(x, dy, be, E), 20)
        lib = _time_ms(torch, lib_fn, 20) if lib_fn else None
        plain = _time_ms(torch, lambda: moe.gmm_dw_reference(x, dy, be, E),
                         2, warmup=1)
        live_rows = t * cfg.n_experts_per_tok
        flops = 2.0 * live_rows * k_in * n_out
        nbytes = 2 * (live_rows * (k_in + n_out) + E * k_in * n_out) \
            + 4 * be.numel()
        bound_ms, bound_by = _bound(flops, nbytes)
        print(f"gmm_dw train {label}: x ({n_pad}, {k_in}), dy ({n_pad}, "
              f"{n_out}) -> dW ({E}, {k_in}, {n_out}), {live_rows} live rows: "
              f"{m}; two runs bit-identical; kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% "
              f"of the bound), plain {plain:.3f} ms, "
              f"library {'null' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound_ms:.4f} ms ({bound_by}){' [' + why + ']' if why else ''}"
              f" [{card}]")
        shapes[label] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib,
                         "max_abs_err": m.max_abs}
        if entry is None:
            entry = {"name": "gmm_dw", "route": "cuda",
                     "source": "flash_attention_tpu_torch/csrc/gmm_dw.cu",
                     "replaces": "flash_attention_tpu/ops/moe.py:121",
                     "max_abs_err": m.max_abs, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib}
        del x, dy, dw
    entry["max_abs_err"] = max(v["max_abs_err"] for v in shapes.values())
    entry["shapes"] = shapes
    return entry


class _NoSplit:
    """While active, ``quantized_matmul`` runs its kernel without a k split
    (one pass over the whole of k): the yardstick of the split's worth."""

    def __init__(self):
        from flash_attention_tpu_torch.ops import quant
        self.quant = quant

    def __enter__(self):
        real = self.real = self.quant.plan

        def plan(m, k, n, n_sms):
            rows, _, _ = real(m, k, n, n_sms)
            return rows, 1, max(1, -(-k // self.quant.BK))
        self.quant.plan = plan
        return self

    def __exit__(self, *exc):
        self.quant.plan = self.real


def check_qmm(torch, dev, cfg, card):
    """qmm against its plain version at the quantized serving path's shapes,
    int8 and int4: every projection at prefill (8 x 2048 rows) and decode
    (8 rows), and the lm_head (8 rows on both: the prefill runs it only at
    ``logit_rows``). Two launches must be bit-identical. Times: the kernel
    (at decode in a CUDA graph over a rotation of weights larger than the L2
    together, as a decode step finds them, and there also without its k
    split), the plain version, the bound and a yardstick, the bf16
    ``torch.matmul`` of the same (m, k, n) with the dequantised weight (what
    the unquantized model runs; cold in the same way at decode). No single
    PyTorch call computes this function (``torch._int_mm`` quantises the
    activations too)."""
    from flash_attention_tpu_torch.ops import quant
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    D, F_ = cfg.dim, cfg.hidden_dim
    proj = {"wq/wo": (D, cfg.n_heads * cfg.head_dim),
            "wk/wv": (D, cfg.n_kv_heads * cfg.head_dim),
            "gate/up": (D, F_), "down": (F_, D)}
    cases = [(f"{phase} {name}", m, k, n)
             for phase, m in (("prefill", MAX_BATCH * 2048),
                              ("decode", MAX_BATCH))
             for name, (k, n) in proj.items()]
    cases.append(("lm_head", MAX_BATCH, D, cfg.vocab_size))
    entry, shapes = None, {}
    for bits in QUANT_BITS:
        quantize = quant.quantize_int8 if bits == 8 else quant.quantize_int4
        for label, m, k, n in cases:
            # weights scaled for outputs of about unit size (see GMM_TOLS)
            w = quantize(torch.randn((k, n), generator=g, device=dev)
                         * k**-0.5)
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            y = quant.quantized_matmul(x, w)
            want = quant.quantized_matmul_reference(x, w)
            tag = f"int{bits} {label}"
            mt = assert_metrics(f"qmm {tag}", y, want, GMM_TOLS)
            assert torch.equal(y, quant.quantized_matmul(x, w)), \
                f"qmm {tag}: two runs differ"
            del y, want
            wb = quant.dequantize(w).to(torch.bfloat16)
            decode = m <= quant.DECODE_M
            if decode:  # a few us of work: device time in a CUDA graph
                q_bytes = w.values.numel() + 4 * w.scales.numel()
                copies = [w] + [quant.QuantizedTensor(
                    w.values.clone(), w.scales.clone(), bits)
                    for _ in range(max(2, -(-int(COLD_BYTES) // q_bytes)) - 1)]
                wbs = [wb] + [wb.clone() for _ in range(
                    max(2, -(-int(COLD_BYTES) // (2 * wb.numel()))) - 1)]

                def qmm(w_):
                    return quant.quantized_matmul(x, w_)
                ms = _time_cold_ms(torch, qmm, copies)
                with _NoSplit():
                    no_split = _time_cold_ms(torch, qmm, copies)
                lib = _time_cold_ms(torch, lambda w_: torch.matmul(x, w_), wbs)
                del copies, wbs
            else:
                ms = _time_ms(torch, lambda: quant.quantized_matmul(x, w), 10)
                lib = _time_ms(torch, lambda: torch.matmul(x, wb), 10)
            plain = _time_ms(torch, lambda: quant.quantized_matmul_reference(
                x, w), 2, warmup=1)
            flops = 2.0 * m * k * n
            nbytes = 2 * m * k + k * n * bits / 8 + 4 * n + 2 * m * n
            bound_ms, bound_by = _bound(flops, nbytes)
            rows, splits, _ = quant.plan(
                m, k, n, torch.cuda.get_device_properties(dev)
                .multi_processor_count)
            split = (f" (k split {splits} ways; without the split "
                     f"{no_split:.4f} ms)" if decode else "")
            print(f"qmm {tag}: x ({m}, {k}) bf16 @ int{bits} ({k}, {n}), "
                  f"{'decode' if decode else 'prefill'} variant, {rows} "
                  f"rows of x a tile: {mt}; two runs bit-identical; kernel "
                  f"{ms:.4f} ms{split} ({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain:.3f} ms, "
                  f"bf16 torch.matmul {lib:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})"
                  f"{' [device times in a CUDA graph, L2 cold]' if decode else ''}"
                  f" [{card}]")
            shapes[tag] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                           "bound_by": bound_by, "library_ms": lib,
                           "max_abs_err": mt.max_abs}
            if decode:
                shapes[tag]["ms_no_split"] = no_split
            if tag == "int8 prefill gate/up":  # the largest projection
                entry = {"name": "qmm", "route": "cuda",
                         "source": "flash_attention_tpu_torch/csrc/qmm.cu",
                         "replaces": "flash_attention_tpu/ops/quant.py:97",
                         "max_abs_err": mt.max_abs, "ms": ms,
                         "plain_ms": plain, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib,
                         "library": "bf16 torch.matmul with the dequantised "
                                    "weight (timed only)"}
            del x, w, wb
    entry["max_abs_err"] = max(v["max_abs_err"] for v in shapes.values())
    entry["shapes"] = shapes
    return entry


class _RouteLog:
    """Records the ids of every ``ops.moe.route`` call while active (each
    token's top-k set, sorted, on the device: no host sync); the results
    pass through unchanged."""

    def __init__(self):
        from flash_attention_tpu_torch.ops import moe
        self.moe, self.ids = moe, []

    def __enter__(self):
        real = self.real = self.moe.route

        def route(x, router_w, n_top):
            out = real(x, router_w, n_top)
            self.ids.append(out[1].detach().sort(-1).values)
            return out
        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def check_moe_ffn(torch, dev, cfg, card):
    """moe_ffn forward and backward through the kernels against the same
    call through the plain versions, on the card with the same bf16 inputs
    at the training shapes (2 x 2048 tokens, one full-width layer), so both
    route alike."""
    import torch.nn.functional as F
    from flash_attention_tpu_torch.ops import moe
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    D, F_, E = cfg.dim, cfg.hidden_dim, cfg.n_experts
    t = TRAIN_BATCH * TRAIN_SEQ

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    inputs = (rnd(t, D), rnd(D, E, scale=0.02), rnd(E, D, F_, scale=D**-0.5),
              rnd(E, D, F_, scale=D**-0.5), rnd(E, F_, D, scale=F_**-0.5))
    # a small cotangent keeps every gradient within a few units (bf16 gates)
    cot = rnd(t, D, scale=1e-3)
    names = ("x", "w_router", "w_gate", "w_up", "w_down")
    runs = []
    for matmul in (moe.grouped_matmul, moe.grouped_matmul_reference):
        leaves = [a.clone().requires_grad_() for a in inputs]
        real, moe.grouped_matmul = moe.grouped_matmul, matmul
        try:
            with _RouteLog() as log:
                out, _ = moe.moe_ffn(*leaves, n_top=cfg.n_experts_per_tok,
                                     act=lambda a: F.silu(a.float()))
                grads = torch.autograd.grad(out, leaves, cot)
        finally:
            moe.grouped_matmul = real
        runs.append((out.detach(), grads, log.ids[0]))
    (out, grads, ids), (out_r, grads_r, ids_r) = runs
    assert torch.equal(ids, ids_r), "kernel and plain runs routed apart"
    parts = [f"out {assert_metrics('moe_ffn out', out, out_r, BWD_TOLS)}"]
    for name, a, b in zip(names, grads, grads_r):
        m = assert_metrics(f"moe_ffn d{name}", a, b, BWD_TOLS)
        parts.append(f"d{name} max_abs {m.max_abs:.3e} mean_rel "
                     f"{m.mean_rel:.3e} (ref max {float(b.abs().max()):.3e})")
    print(f"moe_ffn t={t} d={D} f={F_} e={E} k={cfg.n_experts_per_tok}, "
          f"kernels vs plain versions on the card, same routing: "
          + "; ".join(parts))


def _weight_bytes(params) -> str:
    """The weights' bytes on the card, quantized ones apart."""
    from flash_attention_tpu_torch.ops.quant import QuantizedTensor
    quant = plain = 0
    for w in params.values():
        if isinstance(w, QuantizedTensor):
            quant += sum(t.numel() * t.element_size()
                         for t in (w.values, w.scales))
        else:
            plain += w.numel() * w.element_size()
    return (f"weights {(quant + plain) / 1e9:.3f} GB"
            + (f" ({quant / 1e9:.3f} GB quantized values and scales, "
               f"{plain / 1e9:.3f} GB bf16 embedding and norms)"
               if quant else ""))


def serve(torch, params, cfg, prompts, card, kernels, model,
          max_seq=MAX_SEQ, after_step=None, page_size=PAGE_SIZE,
          total_pages=TOTAL_PAGES, **engine_kw):
    """Serve the prompts through the engine with exact launch counts,
    calling ``after_step(eng)`` after every engine step when given;
    ``engine_kw`` goes to the engine (kv_quant, kv_dtype).
    Returns (the serving path's launches, each request's tokens)."""
    from flash_attention_tpu_torch import Engine
    from flash_attention_tpu_torch.models import llama
    eng = Engine(cfg, params, total_pages=total_pages, page_size=page_size,
                 max_batch=MAX_BATCH, max_seq_len=max_seq,
                 native_allocator=True, **engine_kw)
    print(f"runtime: {'native C++' if eng.rt.is_native else 'Python'} "
          f"page allocator")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, MAX_NEW) for p in prompts]
    eng.run(on_step=after_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    for r in reqs:
        assert r.error is None, f"request {r.uid} failed: {r.error}"
        assert len(r.output) == MAX_NEW, (r.uid, len(r.output))
    st = eng.throughput()
    L = cfg.n_layers
    assert launches["flash_fwd"] == L * st["prefill_dispatches"] > 0, launches
    assert launches["kv_update"] == L * st["decode_steps"] > 0, launches
    assert launches["paged_attention"] == L * st["decode_steps"], launches
    # three grouped matmuls a layer, in every prefill dispatch and decode step
    moe_calls = 3 * L * (st["prefill_dispatches"] + st["decode_steps"])
    assert launches["gmm"] == (moe_calls if cfg.n_experts else 0), launches
    assert launches["gmm_dw"] == 0, launches
    # seven projections a layer and the lm_head, in every dispatch and step
    qmm_calls = (7 * L + 1) * (st["prefill_dispatches"] + st["decode_steps"])
    assert launches["qmm"] == (qmm_calls if llama.is_quantized(params)
                               else 0), launches
    print(f"{model} L{L}: served {len(reqs)} requests x {MAX_NEW} tokens in "
          f"{wall:.3f} s [{card}]")
    print(f"{model} prefill tokens/s: {st['prefill_tokens_per_s']:.1f} "
          f"({st['prefill_tokens']} tokens, {st['prefill_dispatches']} "
          f"dispatches) [{card}]")
    print(f"{model} decode tokens/s: {st['decode_tokens_per_s']:.1f} "
          f"({st['decode_tokens']} tokens) [{card}]")
    print(f"{model} engine steps: prefill dispatches {st['prefill_dispatches']}, "
          f"decode steps {st['decode_steps']} [{card}]")
    print(f"{model} serving peak device memory: {peak / 2**30:.2f} GiB; "
          f"{_weight_bytes(params)} [{card}]")
    print(f"{model} kernel launches on the serving path: {launches}")
    profile_serving(torch, eng, prompts, card, model)
    del eng
    return launches, [r.output for r in reqs]


_KERNEL_GROUPS = (("flash_fwd", "flash_fwd_kernel"),
                  ("gmm", "gmm_kernel"),
                  ("qmm", "qmm_kernel|qmm_reduce_kernel"),
                  ("gmm_dw", "gmm_dw_kernel"),
                  ("flash_bwd_di", "flash_bwd_di_kernel"),
                  ("flash_bwd_dq", "flash_bwd_dq_kernel"),
                  ("flash_bwd_dkv", "flash_bwd_dkv_kernel"),
                  ("kv_write", "kv_write_kernel|kv_write_quant_kernel"),
                  ("paged_attention", "paged_attn_kernel"),
                  ("matmul", "gemm|gemv|cutlass|xmma|nvjet|cublas"))


def profile_window(torch, label, fn, card):
    """Run ``fn`` once under torch.profiler and print its wall time, the
    device's busy share (the union of the device events' intervals, so
    nothing is counted twice), device time by kernel group, and the largest
    kernels of the "other" group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device activity only: kernels, copies and sets, not host ops and
    # not user annotations (those span other device events)
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    groups = dict.fromkeys([g for g, _ in _KERNEL_GROUPS] + ["other"], 0.0)
    other: dict[str, float] = {}
    for e in events:
        t = e.time_range.elapsed_us() / 1e3  # us -> ms
        name = next((g for g, pat in _KERNEL_GROUPS
                     if re.search(pat, e.name, re.I)), "other")
        groups[name] += t
        if name == "other":
            other[e.name] = other.get(e.name, 0.0) + t
    busy, end = 0.0, float("-inf")
    for s, f in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    busy /= 1e3
    if busy == 0:
        print(f"profile {label}: device time not measured (the profiler "
              f"saw no device activity)")
        return
    total = sum(groups.values())
    parts = ", ".join(f"{g} {t:.3f} ms ({t / total:.1%})"
                      for g, t in groups.items() if t > 0)
    print(f"profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms"
          f" ({busy / wall:.1%} of wall, idle {1 - busy / wall:.1%}); "
          f"{parts} [{card}]")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {label}: largest 'other' kernels: " + "; ".join(
        f"{n[:60]} {t:.3f} ms" for n, t in top))


def profile_serving(torch, eng, prompts, card, model):
    """Where the device time goes, after the timed run: the same 8 prompts
    again (4 new tokens each) under torch.profiler. Window 1 is the first
    engine step (the batched prefill and one decode step), window 2 the
    remaining decode steps."""
    for p in prompts:
        eng.add_request(p, 4)
    profile_window(torch, f"{model} prefill+decode step", eng.step, card)
    profile_window(torch, f"{model} decode steps", eng.run, card)


def _prefill_vs_decode(torch, params, cfg, p):
    """Prefill logits at p[-1] (flash kernel), and the logits of one decode
    step on p[-1] after p[:-1]'s K/V went into pages (kv-write and paged
    kernels), on the params' device."""
    from flash_attention_tpu_torch.models import llama
    dev = params["embed"].device
    L, hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    n = len(p)
    toks = torch.tensor([p], device=dev)
    a, _, _ = llama.prefill(params, toks, cfg, return_kv=False,
                            logit_rows=torch.tensor([n - 1], device=dev))
    _, ks, vs = llama.prefill(params, toks[:, :-1], cfg)
    npg = -(-n // PAGE_SIZE)
    kp = torch.zeros((L, hk, npg, PAGE_SIZE, hd),
                     dtype=params["embed"].dtype, device=dev)
    vp = torch.zeros_like(kp)
    ids = torch.arange(-(-(n - 1) // PAGE_SIZE), device=dev)
    llama.write_prefill_to_pages(kp, vp, (ks, vs), ids, torch.zeros_like(ids),
                                 ids, PAGE_SIZE)
    i32 = dict(dtype=torch.int32, device=dev)
    b, *_ = llama.decode_step(
        params, kp, vp, None, None, toks[:, -1], torch.tensor([n], **i32),
        torch.arange(npg, **i32)[None],
        torch.tensor([(n - 1) // PAGE_SIZE], **i32),
        torch.tensor([(n - 1) % PAGE_SIZE], **i32), cfg)
    return a[0].float().cpu(), b[0].float().cpu()


def consistency(torch, params, cfg, prompts, model, n_prompts=2):
    """Prefill logits at p[-1] (flash kernel) against prefill of p[:-1],
    pages, and one decode step on p[-1] (kv-write and paged kernels).

    For an MoE model the routing is recorded: the checked token's top-2
    set in every layer, prefill against decode, and how many earlier tokens
    the two prefills route apart. A prompt whose checked token routes alike
    in every layer is held to the gates; one that flips is printed only
    (one swapped expert moves a token's output by tens of percent, a fact of
    top-k routing, not of a kernel). At least one prompt must route alike."""
    L = cfg.n_layers
    held = 0
    with torch.inference_mode():
        for p in prompts[:n_prompts]:
            n = len(p)
            with _RouteLog() as log:  # L calls in each of the three passes
                a, b = _prefill_vs_decode(torch, params, cfg, p)
            full, short, dec = (log.ids[i * L:(i + 1) * L] for i in range(3))
            assert torch.isfinite(a).all() and torch.isfinite(b).all()
            rel = float((a - b).norm() / a.norm())
            top2 = torch.topk(a, 2).values
            routing, agree = "", True
            if cfg.n_experts:
                same = [bool(torch.equal(f[n - 1], d[0]))
                        for f, d in zip(full, dec)]
                earlier = sum(int((f[:n - 1] != sh).any(-1).sum())
                              for f, sh in zip(full, short))
                agree = all(same)
                routing = (f"; checked token routed alike in {sum(same)}/{L}"
                           f" layers ({''.join('=' if x else 'x' for x in same)}"
                           f"), earlier tokens routed apart by the two "
                           f"prefills: {earlier} of {(n - 1) * L} "
                           f"(token, layer) pairs")
            print(f"{model} prefill vs decode logits, prompt {n} tokens: rel "
                  f"L2 {rel:.3e}, max abs {float((a - b).abs().max()):.3e}, "
                  f"greedy {int(a.argmax())} vs {int(b.argmax())}, top-2 gap "
                  f"{float(top2[0] - top2[1]):.3e}{routing}"
                  f"{'' if agree else ' (not held: routing flipped)'}")
            if agree:
                assert rel <= CONSISTENCY_REL_L2, rel
                assert int(a.argmax()) == int(b.argmax())
                held += 1
    print(f"{model} prefill vs decode: {held} of {min(n_prompts, len(prompts))}"
          f" prompts held to the gates")
    assert held >= 1, "no prompt routed alike in prefill and decode"


def _greedy_agree(x, y) -> bool:
    """x and y share a greedy token: some id is a maximum of both. The
    card's logits are bf16 values, and two of them can be equal at the top,
    where argmax alone would pick the lower id."""
    return bool(((x == x.max()) & (y == y.max())).any())


def window_consistency(torch, dev, cfg, card, model, served=()):
    """Prefill against decode, on the card (bf16, kernels) and on the CPU
    (fp32, plain versions) with the same weights, at CONSISTENCY_LENS: each
    side's two logits agree (rel L2 <= CONSISTENCY_REL_L2, equal greedy
    tokens, ties at the top counting for each tied id: _greedy_agree), and
    the card's agree with the CPU's (the same rel L2 gate).
    The card's greedy token must equal the CPU's wherever the CPU's top-2
    gap exceeds GREEDY_MARGIN times the largest card-vs-CPU logit error of
    that pass: below it the card's error may swap the two, and the card's
    logits at the CPU's top two ids are printed to show it. With
    ``served`` (prompt lengths), the card's prefill logits at each such
    prompt's last position are held to the CPU's (rel L2 <=
    CONSISTENCY_REL_L2)."""
    from flash_attention_tpu_torch.models import llama
    params = llama.init_params(cfg, seed=SEED + 12, device=dev)
    cpu = {n: w.to("cpu", torch.float32) for n, w in params.items()}
    torch.set_num_threads(os.cpu_count() or 1)

    def rel(x, y):
        return float((x - y).norm() / y.norm())
    with torch.inference_mode():
        for p in _prompts(cfg.vocab_size, CONSISTENCY_LENS):
            a, b = _prefill_vs_decode(torch, params, cfg, p)
            ac, bc = _prefill_vs_decode(torch, cpu, cfg, p)
            assert all(torch.isfinite(x).all() for x in (a, b, ac, bc))
            card_top = torch.topk(a, 2)
            print(f"{model} prefill vs decode, prompt {len(p)} tokens: card "
                  f"rel L2 {rel(b, a):.3e}, CPU {rel(bc, ac):.3e}; card vs "
                  f"CPU prefill {rel(a, ac):.3e}, decode {rel(b, bc):.3e}; "
                  f"card greedy {int(a.argmax())}/{int(b.argmax())} (card "
                  f"prefill top-2 ids {card_top.indices.tolist()}, gap "
                  f"{float(card_top.values[0] - card_top.values[1]):.4e}; "
                  f"decode there {float(b[card_top.indices[0]]):.6f} / "
                  f"{float(b[card_top.indices[1]]):.6f}) [{card}]")
            for x, y in ((b, a), (bc, ac), (a, ac), (b, bc)):
                assert rel(x, y) <= CONSISTENCY_REL_L2, rel(x, y)
            assert _greedy_agree(ac, bc), (model, len(p))
            for name, x, xc in (("prefill", a, ac), ("decode", b, bc)):
                top = torch.topk(xc, 2)
                gap = float(top.values[0] - top.values[1])
                err = float((x - xc).abs().max())
                held = gap > GREEDY_MARGIN * err
                ids = top.indices.tolist()
                print(f"  {name}: greedy card {int(x.argmax())}, CPU {ids[0]}"
                      f"; CPU top-2 gap {gap:.4e} (ids {ids}: CPU "
                      f"{top.values[0]:.6f} / {top.values[1]:.6f}, card "
                      f"{x[ids[0]]:.6f} / {x[ids[1]]:.6f}); max |card - CPU|"
                      f" {err:.4e}: {'held' if held else 'not held'} (gap > "
                      f"{GREEDY_MARGIN:g} x max error)")
                if held:
                    assert _greedy_agree(x, xc), (name, len(p))
            assert _greedy_agree(a, b), (model, len(p))
        rels = []
        for p in _prompts(cfg.vocab_size, served) if served else ():
            last = [len(p) - 1]
            x, xc = (llama.prefill(w, torch.tensor([p], device=d), cfg,
                                   return_kv=False,
                                   logit_rows=torch.tensor(last, device=d)
                                   )[0][0].float().cpu()
                     for w, d in ((params, dev), (cpu, "cpu")))
            assert torch.isfinite(x).all() and torch.isfinite(xc).all()
            rels.append(rel(x, xc))
            print(f"{model} served prompt {len(p)} tokens, logits at its "
                  f"last position: card vs CPU rel L2 {rels[-1]:.3e}, max "
                  f"abs {float((x - xc).abs().max()):.3e}; greedy card "
                  f"{int(x.argmax())}, CPU {int(xc.argmax())} [{card}]")
        assert all(r <= CONSISTENCY_REL_L2 for r in rels), rels
    del params, cpu


def _quant_error(torch, params, qparams) -> str:
    """||dequantize(q) - w|| / ||w|| for layer 0's projections and the
    lm_head: the error each quantized product starts from."""
    from flash_attention_tpu_torch.ops.quant import QuantizedTensor, dequantize
    errs = {}
    for name, qt in qparams.items():
        if not isinstance(qt, QuantizedTensor):
            continue
        w = params[name]
        if qt.values.dim() == 3:  # a layer stack: layer 0
            w, qt = w[0], QuantizedTensor(qt.values[0], qt.scales[0], qt.bits)
        w = w.float()
        errs[name] = float((dequantize(qt) - w).norm() / w.norm())
        del w
    return ", ".join(f"{n} {e:.3e}" for n, e in errs.items())


def generated_logits(torch, params, cfg, prompts, outputs,
                     kv_fake_quant=None):
    """Teacher-forced logits at the generated positions: each served
    sequence (its prompt and its tokens but the last) through one prefill
    (with ``kv_fake_quant``, K/V rounded through the quantized cache's
    quantizer), and the rows that predict its generated tokens. Returns
    (n_requests, MAX_NEW, vocab) fp32 on the card."""
    from flash_attention_tpu_torch.models import llama
    dev = params["embed"].device
    rows = []
    with torch.inference_mode():
        for p, o in zip(prompts, outputs):
            seq = torch.tensor([p + o[:-1]], device=dev)
            logits, _, _ = llama.prefill(params, seq, cfg, return_kv=False,
                                         kv_fake_quant=kv_fake_quant)
            rows.append(logits[0, len(p) - 1:])
            del logits
    return torch.stack(rows)


def quant_quality(torch, ref, rows, outputs, q_outputs, model):
    """The method of tools/eval_quant.py on the served sequences: the
    teacher-forced cross-entropy of the generated tokens, quantized against
    bf16 (dCE); the rel L2 of the last position's logits; the share of
    positions whose greedy token agrees. Printed, not gated: only finite."""
    import torch.nn.functional as F
    tgt = torch.tensor(outputs, device=ref.device).flatten()

    def ce(r):
        return float(F.cross_entropy(r.flatten(0, 1), tgt))
    ce_ref, ce_q = ce(ref), ce(rows)
    last = float((rows[:, -1] - ref[:, -1]).norm() / ref[:, -1].norm())
    agree = float((rows.argmax(-1) == ref.argmax(-1)).float().mean())
    same = sum(a == b for a, b in zip(q_outputs, outputs))
    print(f"{model} quality on the {len(outputs)} served sequences "
          f"({tgt.numel()} generated positions, teacher-forced): CE "
          f"{ce_q:.6f} vs bf16 {ce_ref:.6f} (dCE {ce_q - ce_ref:+.6f} nats); "
          f"last-position logits rel L2 {last:.4e}; greedy tokens agree at "
          f"{agree:.2%} of positions; served completions identical to bf16's:"
          f" {same} of {len(outputs)}")
    assert all(np.isfinite([ce_ref, ce_q, last, agree])), (ce_q, last)


def quant_card_vs_cpu(torch, dev, cfg, card, n_layers=2):
    """Full width, ``n_layers`` layers, b 1, s 256, int8 and int4: prefill
    logits through the qmm kernel (bf16 activations, card) against the
    plain version (fp32 activations, CPU) on the same QuantizedTensors."""
    from flash_attention_tpu_torch.models import llama
    from flash_attention_tpu_torch.ops.quant import QuantizedTensor
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    params = llama.init_params(cfg2, seed=SEED + 9, device=dev)
    toks, _ = _batch(torch, dev, cfg.vocab_size, 1, 256, SEED + 9)
    torch.set_num_threads(os.cpu_count() or 1)

    def to_cpu(w):
        if isinstance(w, QuantizedTensor):
            return QuantizedTensor(w.values.cpu(), w.scales.cpu(), w.bits)
        return w.to("cpu", torch.float32)
    with torch.inference_mode():
        for bits in QUANT_BITS:
            qp = llama.quantize_params(params, bits=bits)
            card_logits, _, _ = llama.prefill(qp, toks, cfg2, return_kv=False)
            t0 = time.perf_counter()
            cpu_logits, _, _ = llama.prefill(
                {n: to_cpu(w) for n, w in qp.items()}, toks.cpu(), cfg2,
                return_kv=False)
            t_cpu = time.perf_counter() - t0
            a, b = card_logits.float().cpu(), cpu_logits
            assert torch.isfinite(a).all() and torch.isfinite(b).all()
            rel = float((a - b).norm() / b.norm())
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            print(f"Llama-3-8B int{bits} card vs CPU (L{n_layers}, b1 s256, "
                  f"full width, the same QuantizedTensors): prefill logits "
                  f"rel L2 {rel:.3e}, max abs "
                  f"{float((a - b).abs().max()):.3e}, greedy tokens agree at "
                  f"{agree:.2%} of positions (CPU {t_cpu:.2f} s) [{card}]")
            assert rel <= QUANT_CARD_CPU_REL_L2, (bits, rel)
            del qp, card_logits, cpu_logits


# ------------------------------------------------- the quantized KV cache

def _quant_rows(torch, g, dev, b, hk, d, dtype):
    """bf16 K or V rows (b, hk, d) of unit scale with the quantizer's hard
    cases: a zero row (scale 1e-8), a row whose amax gives scale 1 exactly
    (int8: 127; e4m3: 448) holding ties (int8: n + 0.5; e4m3: odd integers
    in [17, 31], halfway between two steps of 2), and amax elements of
    either sign."""
    x = torch.randn((b, hk, d), generator=g, device=dev)
    x[0, 0] = 0.0
    i = torch.arange(d, device=dev, dtype=torch.float32)
    if dtype == torch.int8:
        x[0, -1] = i % 20 - 9.5
        x[0, -1, 0] = 127.0
    else:
        x[0, -1] = (17 + 2 * (i % 8)) * (1 - 2 * (i % 2))
        x[0, -1, 0] = 448.0
    x[-1, 0, d // 2] = -40.0
    return x.to(torch.bfloat16)


def _quant_pool(torch, g, dev, shape, dtype, spread=False):
    """A quantized pool (L, hk, P, 128, d) and its scale tiles, each layer
    drawn as unit normals (with ``spread``, K's: times a log-normal factor
    per token, as real caches' token norms vary, so a scale read for the
    wrong token moves the scores) and quantized per token, one layer's fp32
    draw at a time."""
    from flash_attention_tpu_torch.ops.quant import quantize_kv_pages
    L, hk, P, ps, d = shape
    pages = torch.empty(shape, dtype=dtype, device=dev)
    scales = torch.empty((L, hk, P, 8, 128), dtype=torch.float32, device=dev)
    for i in range(L):
        x = torch.randn((hk, P, ps, d), generator=g, device=dev)
        if spread:
            x *= torch.randn((hk, P, ps, 1), generator=g, device=dev).exp()
        pages[i], scales[i] = quantize_kv_pages(x, dtype)
        del x
    return pages, scales


def _bits_equal(torch, got, want, trash) -> bool:
    """Bit-identical everywhere but the trash page (axis 2)."""
    keep = torch.ones(got.shape[2], dtype=torch.bool, device=got.device)
    keep[trash] = False
    g, w = got[:, :, keep], want[:, :, keep]
    if g.element_size() == 1:
        g, w = g.view(torch.uint8), w.view(torch.uint8)
    return bool(torch.equal(g, w))


def check_kv_write_quant(torch, dev, cfg, card):
    """The kv write's two quantized instances (rows already in the cache's
    type with their scales, "store"; bf16 rows quantized in the kernel,
    "quantize") against their plain versions, int8 and fp8, d 64, 128 and
    256, pools and scale tiles bit for bit; then timed in a CUDA graph at
    the serving shape (L32 b8 hk8 d128, 256 pages of 128)."""
    from flash_attention_tpu_torch.ops import kv_update as kv
    from flash_attention_tpu_torch.ops.quant import _quantize_token
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    hk, b = cfg.n_kv_heads, MAX_BATCH
    shapes = {}
    for name, dtype in KV_QUANT.items():
        for d, L, P in ((64, 2, 64), (128, 2, 64), (256, 2, 64),
                        (cfg.head_dim, cfg.n_layers, KV_QUANT_PAGES)):
            timed = L == cfg.n_layers
            kp, ks = _quant_pool(torch, g, dev, (L, hk, P, 128, d), dtype)
            vp, vs = _quant_pool(torch, g, dev, (L, hk, P, 128, d), dtype)
            k = _quant_rows(torch, g, dev, b, hk, d, dtype)
            v = _quant_rows(torch, g, dev, b, hk, d, dtype)
            trash = P - 1
            wpage = torch.randperm(P - 1, generator=g, device=dev)[:b]
            wpage[-2:] = trash  # two padding rows share the trash page
            wpage = wpage.to(torch.int32)
            woff = torch.randint(0, 128, (b,), generator=g, device=dev,
                                 dtype=torch.int32)
            woff[0], woff[1] = 0, 127
            layer = L - 1
            kq, ksc = _quantize_token(k, dtype)
            vq, vsc = _quantize_token(v, dtype)

            def plain(kp, vp, ks, vs):
                kq, ksc = _quantize_token(k, dtype)
                vq, vsc = _quantize_token(v, dtype)
                kv.write_token_kv_reference(kp, vp, kq, vq, wpage, woff,
                                            layer)
                kv._write_scales_reference(ks, ksc, wpage, woff, layer)
                kv._write_scales_reference(vs, vsc, wpage, woff, layer)
            pools = (kp, vp, ks, vs)
            orig = [x.clone() for x in pools]
            ref = [x.clone() for x in pools]
            plain(*ref)
            calls = {
                "store": lambda: kv.write_token_kv(
                    kp, vp, ks, vs, kq, vq, ksc, vsc, wpage, woff,
                    layer=layer),
                "quantize": lambda: kv.quantize_write_token_kv(
                    kp, vp, ks, vs, k, v, wpage, woff, layer=layer)}
            for mode, call in calls.items():
                for x, o in zip(pools, orig):
                    x.copy_(o)
                call()
                same = all(_bits_equal(torch, x, r, trash)
                           for x, r in zip(pools, ref))
                assert same, f"kv write {mode} {name} d{d}: not bit-identical"
            print(f"kv_write {name} d{d} L{L} b{b} hk{hk} (trash page shared "
                  f"by 2 rows; a zero row, ties and amax elements): store and"
                  f" quantize instances bit-identical to their plain "
                  f"versions, pools and scale tiles")
            if timed:
                rows = b * hk * d
                for mode, call in calls.items():
                    ms = _time_graph_ms(torch, call, 100)
                    # read: the rows (bf16 to quantize, else 8-bit and an
                    # fp32 scale) and wpage/woff; written: the 8-bit rows and
                    # each scale into the 8 rows of its tile
                    nread = 2 * (rows * (2 if mode == "quantize" else 1)
                                 + (0 if mode == "quantize" else 4 * b * hk))
                    nbytes = nread + 2 * (rows + 8 * 4 * b * hk) + 8 * b
                    bound_ms, bound_by = _bound(0.0, nbytes)
                    shapes[f"{name} {mode} L{L} b{b} hk{hk} d{d}"] = {
                        "ms": ms, "bound_ms": bound_ms}
                    print(f"kv_write {name} {mode} L{L} b{b} hk{hk} d{d}: "
                          f"device time in a CUDA graph {ms:.5f} ms, bound "
                          f"{bound_ms:.6f} ms ({bound_by}) [{card}]")
                p_ms = _time_graph_ms(torch, lambda: plain(kp, vp, ks, vs),
                                      20)
                shapes[f"{name} quantize L{L} b{b} hk{hk} d{d}"][
                    "plain_ms"] = p_ms
                print(f"kv_write {name} plain version (quantize, write "
                      f"rows and scales) in a CUDA graph: {p_ms:.5f} ms "
                      f"[{card}]")
            del kp, vp, ks, vs, pools, orig, ref
    return shapes


def _paged_live(lens, window=None) -> tuple[float, float]:
    """The tokens a paged call reads (each row's last ``window`` tokens,
    or all of them) and the pages of KV_QUANT_PAGE_SIZE they lie in."""
    ps, tokens, pages = KV_QUANT_PAGE_SIZE, 0, 0
    for n in map(int, lens):
        lo = max(n - window, 0) if window else 0
        tokens += n - lo
        pages += -(-n // ps) - lo // ps
    return float(tokens), float(pages)


def _paged_bytes(lens, hk, d, q, quant: bool, window=None) -> float:
    """Bytes a paged call must move: each live token's K and V (8-bit with
    a 4-byte scale each, or bf16), q and out, lengths and table entries."""
    n, pages = _paged_live(lens, window)
    per_token = 2 * d + 8 if quant else 4 * d
    return n * hk * per_token + 2 * 2 * q.numel() + 4 * (len(lens) + pages)


def check_paged_quant(torch, dev, cfg, gemma, card):
    """The paged kernel's int8 and fp8 instances against the plain version
    on the same quantized cache (O_TOLS), with two controls that must fail
    the gate (the scales ignored; the scales read one token off), and timed
    cold (the L calls of a decode step in one CUDA graph, each on another
    layer's pages) beside the bf16 instance at the same shape: d 128 L32 b8
    h32/8, lengths linspace(1, 4096, 8) and the served decode lengths;
    every row 8192 with W 4096 and holes; softcap 5; then d 256 at
    Gemma-2-9B's widths (h16/8) and d 64."""
    from flash_attention_tpu_torch.ops import paged_attention as pa
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    ps, b = KV_QUANT_PAGE_SIZE, MAX_BATCH
    shapes = {}

    def gate_and_controls(label, q, kp, vp, ks, vs, lens, tab, layer, **kw):
        lt = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
        o = pa.paged_attention(q, kp, vp, lt, tab, k_scales=ks, v_scales=vs,
                               layer=layer, **kw)
        o_ref = pa.paged_attention_reference(
            q, kp, vp, lt, tab.clamp(min=0), k_scales=ks, v_scales=vs,
            layer=layer, **kw)
        m = assert_metrics(f"paged_attention {label}", o, o_ref, O_TOLS)
        ones = torch.ones_like(ks[layer:layer + 1])
        fails = []
        for ctl, (kc, vc) in {
                "scales ignored": (ones, ones),
                "scales one token off": (ks[layer:layer + 1].roll(1, -1),
                                         vs[layer:layer + 1].roll(1, -1))
        }.items():
            bad = pa.paged_attention(q, kp[layer:layer + 1],
                                     vp[layer:layer + 1], lt, tab,
                                     k_scales=kc, v_scales=vc, layer=0, **kw)
            try:
                assert_metrics(f"control {ctl}", bad, o_ref, O_TOLS)
            except AssertionError:
                fails.append(ctl)
                continue
            raise AssertionError(f"paged_attention {label}: the control "
                                 f"'{ctl}' passed the gate")
        print(f"paged_attention {label}: {m}; controls failing the gate: "
              f"{fails} [{card}]")
        return m

    def cold(fn, L):
        return _time_graph_calls_ms(torch, [lambda i=i: fn(i)
                                            for i in range(L)])

    def timed(label, q, pools, lens, tab, L, hk, d, **kw):
        """Cold ms of each dtype's pools, % of its byte bound, and the
        ratio to the bf16 instance."""
        lt = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
        h = q.shape[1]
        res = {}
        for name, (kp, vp, ks, vs) in pools.items():
            quant = ks is not None
            ms = cold(lambda i: pa.paged_attention(
                q, kp, vp, lt, tab, k_scales=ks, v_scales=vs, layer=i, **kw),
                L)
            nb = _paged_bytes(lens, hk, d, q, quant, kw.get("window"))
            n_live, _ = _paged_live(lens, kw.get("window"))
            bms, by = _bound(4.0 * n_live * h * d, nb)
            res[name] = (ms, bms, by, nb)
        bf16_ms = res["bf16"][0]
        for name, (ms, bms, by, nb) in res.items():
            if name == "bf16":
                continue
            shapes[f"{name} {label}"] = {"ms": ms, "bound_ms": bms,
                                         "vs_bf16": ms / bf16_ms}
            print(f"paged_attention {name} cold ({L} layers in a CUDA "
                  f"graph), {label}: {ms:.5f} ms ({nb / ms / 1e6:.1f} GB/s, "
                  f"{bms / ms:.1%} of the {bms:.5f} ms bound ({by}), "
                  f"{nb / 1e6:.1f} MB); bf16 instance at the same shape "
                  f"{bf16_ms:.5f} ms ({res['bf16'][1] / bf16_ms:.1%} of its "
                  f"{res['bf16'][1]:.5f} ms bound): {ms / bf16_ms:.3f}x "
                  f"[{card}]")

    # d 128 at Llama-3-8B's widths, 512 pages of 128 tokens a layer: every
    # row of 8192 tokens fits
    L, h, hk, d = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    P = b * 8192 // ps
    pools = {}
    for name, dtype in KV_QUANT.items():
        kp, ks = _quant_pool(torch, g, dev, (L, hk, P, ps, d), dtype,
                             spread=True)
        vp, vs = _quant_pool(torch, g, dev, (L, hk, P, ps, d), dtype)
        pools[name] = (kp, vp, ks, vs)
    pools["bf16"] = (_random_pool(torch, g, dev, (L, hk, P, ps, d)),
                     _random_pool(torch, g, dev, (L, hk, P, ps, d)),
                     None, None)
    q = torch.randn((b, h, d), generator=g, device=dev).to(torch.bfloat16)
    perm = torch.randperm(P, generator=g, device=dev).to(torch.int32)
    tab32 = perm[:b * 32].reshape(b, 32).contiguous()  # 4096-token rows
    tab64 = perm.reshape(b, 64).contiguous()            # 8192-token rows
    lin = np.linspace(1, 4096, b).astype(np.int32)
    served = np.asarray([len(p) for p in _prompts(cfg.vocab_size)]) + 16
    full = np.full(b, 8192, np.int32)
    # holes: the entries of pages wholly behind each row's window
    w = MISTRAL_W
    holed = tab64.clone()
    for i, n in enumerate(full):
        holed[i, :max(int(n) - w, 0) // ps] = -1
    t_plain, max_abs = {}, {}
    for name in KV_QUANT:
        kp, vp, ks, vs = pools[name]
        args = (q, kp, vp, ks, vs)
        m = gate_and_controls(f"{name} L{L} b{b} h{h}/{hk} d{d} lengths "
                              f"{lin.tolist()}", *args, lin, tab32, L - 1)
        max_abs[name] = m.max_abs
        gate_and_controls(f"{name} served decode lengths {served.tolist()}",
                          *args, served, tab32, 0)
        gate_and_controls(f"{name} every row 8192, window {w}, "
                          f"{int((holed < 0).sum())} hole entries", *args,
                          full, holed, 1, window=w)
        gate_and_controls(f"{name} softcap {PAGED_CAP}", *args, lin, tab32,
                          L // 2, softcap=PAGED_CAP)
        lt = torch.from_numpy(lin).to(dev)
        t_plain[name] = _time_ms(torch, lambda: pa.paged_attention_reference(
            q, kp, vp, lt, tab32, k_scales=ks, v_scales=vs, layer=0), 3,
            warmup=1)
    main = f"L{L} b{b} h{h}/{hk} d{d}, lengths linspace(1, 4096, 8)"
    timed(main, q, pools, lin, tab32, L, hk, d)
    for name in KV_QUANT:
        shapes[f"{name} {main}"].update(max_abs_err=max_abs[name],
                                        plain_ms=t_plain[name])
    timed(f"L{L} b{b} h{h}/{hk} d{d}, served decode lengths", q, pools,
          served, tab32, L, hk, d)
    timed(f"L{L} b{b} h{h}/{hk} d{d}, every row 8192, window {w}", q, pools,
          full, holed, L, hk, d, window=w)
    timed(f"L{L} b{b} h{h}/{hk} d{d}, linspace(1, 4096, 8), softcap "
          f"{PAGED_CAP}", q, pools, lin, tab32, L, hk, d, softcap=PAGED_CAP)
    del pools
    torch.cuda.empty_cache()
    # d 256 at Gemma-2-9B's widths (h16/8), and d 64 at Llama's heads
    for (hh, hkk, dd, LL) in ((gemma.n_heads, gemma.n_kv_heads,
                               gemma.head_dim, PAGED_QUANT_LAYERS[0]),
                              (h, hk, 64, PAGED_QUANT_LAYERS[1])):
        P2 = b * 32
        pools = {}
        for name, dtype in KV_QUANT.items():
            kp, ks = _quant_pool(torch, g, dev, (LL, hkk, P2, ps, dd), dtype,
                                 spread=True)
            vp, vs = _quant_pool(torch, g, dev, (LL, hkk, P2, ps, dd), dtype)
            pools[name] = (kp, vp, ks, vs)
        pools["bf16"] = (_random_pool(torch, g, dev, (LL, hkk, P2, ps, dd)),
                         _random_pool(torch, g, dev, (LL, hkk, P2, ps, dd)),
                         None, None)
        q2 = torch.randn((b, hh, dd), generator=g, device=dev).to(
            torch.bfloat16)
        tab = torch.randperm(P2, generator=g, device=dev).to(
            torch.int32).reshape(b, 32)
        for name in KV_QUANT:
            gate_and_controls(f"{name} L{LL} b{b} h{hh}/{hkk} d{dd} lengths "
                              f"{lin.tolist()}", q2, *pools[name], lin, tab,
                              LL - 1)
        gate_and_controls(f"fp8 L{LL} d{dd} window {w // 4} softcap "
                          f"{PAGED_CAP}", q2, *pools["fp8"], lin, tab, 0,
                          window=w // 4, softcap=PAGED_CAP)
        timed(f"L{LL} b{b} h{hh}/{hkk} d{dd}, lengths linspace(1, 4096, 8)",
              q2, pools, lin, tab, LL, hkk, dd)
        del pools
        torch.cuda.empty_cache()
    print(f"paged_attention quantized plain version (one layer, eager, "
          f"L{L} b{b} lengths linspace(1, 4096, 8)): "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in t_plain.items())
          + f" [{card}]")
    return shapes


def serve_kv_quant(torch, params, cfg, prompts, card, kernels, name):
    """Llama-3-8B served with a quantized cache (``name`` int8 or fp8) at
    the bf16 serve's token slots: KV_QUANT_PAGES pages of 128 tokens. The
    exact launch counts of ``serve``, and the cache's bytes."""
    from flash_attention_tpu_torch.models import llama
    kw = dict(kv_quant=True)
    if name == "fp8":
        kw["kv_dtype"] = KV_QUANT["fp8"]
    L, hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    pages = L * hk * KV_QUANT_PAGES * KV_QUANT_PAGE_SIZE * hd * 2
    scales = L * hk * KV_QUANT_PAGES * 8 * 128 * 4 * 2
    bf16 = L * hk * TOTAL_PAGES * PAGE_SIZE * hd * 2 * 2
    print(f"Llama-3-8B KV {name} cache: {KV_QUANT_PAGES} pages of "
          f"{KV_QUANT_PAGE_SIZE} tokens ({KV_QUANT_PAGES * KV_QUANT_PAGE_SIZE}"
          f" slots): pages {pages / 2**30:.3f} GiB + scale tiles "
          f"{scales / 2**30:.3f} GiB = {(pages + scales) / 2**30:.3f} GiB, "
          f"against the bf16 cache's {bf16 / 2**30:.3f} GiB at the same "
          f"slots")
    held = []
    out = serve(torch, params, cfg, prompts, card, kernels,
                f"Llama-3-8B KV {name}", page_size=KV_QUANT_PAGE_SIZE,
                total_pages=KV_QUANT_PAGES,
                after_step=lambda e: held.append(
                    e.rt.total_pages - e.rt.free_pages()), **kw)
    print(f"Llama-3-8B KV {name} pages held (trash page included): at most "
          f"{max(held)} of {KV_QUANT_PAGES}, after admission {held[0]}")
    return out


def _quant_prefill_vs_decode(torch, params, cfg, p, dtype, fake_quant=None,
                             ignore_scales=False):
    """The logits of one decode step on p[-1] against a quantized cache
    (``dtype``) holding p[:-1]'s K/V, from prefill (with ``fake_quant``, its
    K/V rounded through the quantizer first) and write_prefill_to_pages; with
    ``ignore_scales`` the decode reads the cache with unit scales."""
    from flash_attention_tpu_torch.models import llama
    dev = params["embed"].device
    L, hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    n, ps = len(p), KV_QUANT_PAGE_SIZE
    toks = torch.tensor([p], device=dev)
    _, ks, vs = llama.prefill(params, toks[:, :-1], cfg,
                              kv_fake_quant=fake_quant,
                              logit_rows=torch.tensor([n - 2], device=dev))
    npg = -(-n // ps)
    kp = torch.zeros((L, hk, npg, ps, hd), dtype=dtype, device=dev)
    vp = torch.zeros_like(kp)
    ksc = torch.ones((L, hk, npg, 8, 128), dtype=torch.float32, device=dev)
    vsc = torch.ones_like(ksc)
    ids = torch.arange(-(-(n - 1) // ps), device=dev)
    llama.write_prefill_to_pages(kp, vp, (ks, vs), ids, torch.zeros_like(ids),
                                 ids, ps, k_scales=ksc, v_scales=vsc)
    del ks, vs
    if ignore_scales:
        ksc.fill_(1.0)
        vsc.fill_(1.0)
    i32 = dict(dtype=torch.int32, device=dev)
    b, *_ = llama.decode_step(
        params, kp, vp, ksc, vsc, toks[:, -1], torch.tensor([n], **i32),
        torch.arange(npg, **i32)[None], torch.tensor([(n - 1) // ps], **i32),
        torch.tensor([(n - 1) % ps], **i32), cfg)
    return b[0].float().cpu()


def kv_quant_consistency(torch, dev, params, cfg, prompts, card):
    """The quantized cache's decode logits held to gates a wrong kernel
    fails:
    * full width, 2 layers, int8 and fp8: the card's decode logits (bf16,
      the kv-write and paged kernels' quantized instances) against the CPU's
      (fp32, plain versions) on the same weights, rel L2 <=
      CONSISTENCY_REL_L2;
    * full depth (``params``): the decode logits over a cache written from
      prefill(kv_fake_quant=)'s K/V against prefill(kv_fake_quant=)'s own
      logits at the last position (the same rounding of K and V on both
      sides), rel L2 <= CONSISTENCY_REL_L2; with the scales ignored the
      gate must fail."""
    from flash_attention_tpu_torch.models import llama
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = llama.init_params(cfg2, seed=SEED + 23, device=dev)
    cpu = {n: w.to("cpu", torch.float32) for n, w in p2.items()}
    torch.set_num_threads(os.cpu_count() or 1)
    with torch.inference_mode():
        for name, dtype in KV_QUANT.items():
            for p in _prompts(cfg.vocab_size, CONSISTENCY_LENS):
                a = _quant_prefill_vs_decode(torch, p2, cfg2, p, dtype)
                ac = _quant_prefill_vs_decode(torch, cpu, cfg2, p, dtype)
                r = _rel(torch, a, ac)
                print(f"Llama-3-8B L2 KV {name} decode logits, prompt "
                      f"{len(p)} tokens: card vs CPU rel L2 {r:.3e}, max abs "
                      f"{float((a - ac).abs().max()):.3e}; greedy card "
                      f"{int(a.argmax())}, CPU {int(ac.argmax())} [{card}]")
                assert torch.isfinite(a).all() and r <= CONSISTENCY_REL_L2, r
        del p2, cpu
        for name, dtype in KV_QUANT.items():
            p = prompts[0]
            a = llama.prefill(params, torch.tensor([p], device=dev), cfg,
                              kv_fake_quant=dtype, return_kv=False,
                              logit_rows=torch.tensor([len(p) - 1],
                                                      device=dev)
                              )[0][0].float().cpu()
            b = _quant_prefill_vs_decode(torch, params, cfg, p, dtype,
                                         fake_quant=dtype)
            c = _quant_prefill_vs_decode(torch, params, cfg, p, dtype,
                                         fake_quant=dtype,
                                         ignore_scales=True)
            r, rc = _rel(torch, b, a), _rel(torch, c, a)
            print(f"Llama-3-8B L{cfg.n_layers} KV {name}, prompt {len(p)} "
                  f"tokens: decode over the quantized cache vs "
                  f"prefill(kv_fake_quant) logits at the last position: rel "
                  f"L2 {r:.3e} (gate {CONSISTENCY_REL_L2}), greedy "
                  f"{int(b.argmax())} vs {int(a.argmax())}; control with the "
                  f"scales ignored: {rc:.3e} (must fail the gate) [{card}]")
            assert r <= CONSISTENCY_REL_L2, r
            assert rc > CONSISTENCY_REL_L2, "the control passed the gate"


def gemma2_kv_quant(torch, dev, card, kernels):
    """The Gemma-2 config (window 64 on every second layer, softcaps 5/3)
    served with an int8 cache and chunked prefill (GEMMA_CHUNK) on the card
    and on the CPU (plain versions) with the same weights: the prefill's
    last-position logits (the last chunk over its dequantized prefix) and
    the first decode step's (the quantized kv write and paged kernels with
    the window and the softcap) held together, rel L2 <=
    CONSISTENCY_REL_L2; a decode row is compared where both sides sampled
    the same prefill token. Returns the card path's launches."""
    from flash_attention_tpu_torch import Engine
    from flash_attention_tpu_torch.models import llama
    gcfg = llama.LlamaConfig.tiny_gemma2(n_layers=GEMMA_LAYERS,
                                         window_pattern=2, **GEMMA_CAPS)
    model = (f"Gemma-2 config (tiny_gemma2 L{GEMMA_LAYERS}, window "
             f"{gcfg.sliding_window} every 2 layers, softcaps "
             f"{gcfg.attn_softcap:g}/{gcfg.final_softcap:g}) KV int8 chunked "
             f"{GEMMA_CHUNK}")
    params = llama.init_params(gcfg, seed=SEED + 24, device=dev)
    cpu = {n: w.to("cpu", torch.float32) for n, w in params.items()}
    prompts = _prompts(gcfg.vocab_size, GEMMA_PROMPT_LENS)
    rec, launches = {}, None
    for side, w in (("card", params), ("CPU", cpu)):
        eng = Engine(gcfg, w, total_pages=32, page_size=KV_QUANT_PAGE_SIZE,
                     max_batch=MAX_BATCH, max_seq_len=GEMMA_MAX_SEQ,
                     chunk_size=GEMMA_CHUNK, kv_quant=True)
        rec[side] = _SampleLog(eng, 2)
        for kern in kernels:
            kern.launches = 0
        reqs = [eng.add_request(p, 2) for p in prompts]
        eng.run()
        for r in reqs:
            assert r.error is None, f"{side} request {r.uid}: {r.error}"
        st = eng.throughput()
        if side == "card":
            launches = {kern.name: kern.launches for kern in kernels}
            L = gcfg.n_layers
            assert launches["flash_fwd"] == L * st["prefill_chunks"] > 0
            assert launches["kv_update"] == L * st["decode_steps"] > 0
            assert launches["paged_attention"] == L * st["decode_steps"]
        del eng
        gc.collect()
    (pc, tc), (dc, _) = rec["card"].calls
    (pu, tu), (du, _) = rec["CPU"].calls
    rels_p = [_rel(torch, a, b) for a, b in zip(pc, pu)]
    same = [i for i in range(len(prompts)) if tc[i] == tu[i]]
    rels_d = [_rel(torch, dc[i], du[i]) for i in same]
    print(f"{model}: card (bf16, kernels) vs CPU (fp32, plain versions): "
          f"prefill last-position logits rel L2 "
          f"{[f'{r:.3e}' for r in rels_p]}; first decode step "
          f"{[f'{r:.3e}' for r in rels_d]} (rows {same}, where the prefill "
          f"tokens agree) (gate {CONSISTENCY_REL_L2}); launches {launches} "
          f"[{card}]")
    assert same and max(rels_p + rels_d) <= CONSISTENCY_REL_L2, (rels_p,
                                                                 rels_d)
    del params, cpu
    return launches


def _batch(torch, dev, vocab, b, s, seed):
    """Tokens from a numpy seed; targets are the tokens rolled by one, with
    the last position ignored (-100)."""
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s))
    tgt = np.roll(toks, -1, axis=-1)
    tgt[:, -1] = -100
    return torch.from_numpy(toks).to(dev), torch.from_numpy(tgt).to(dev)


def train_consistency(torch, dev, cfg, card, model, n_layers=2):
    """Full width, ``n_layers`` layers, b 1, s 256: the same weights through
    the kernels (bf16, card) and through the plain versions (fp32, CPU); the
    loss and every parameter's gradient must agree.

    For an MoE model the two sides may route a token to different experts
    (bf16 against fp32 activations). With one layer a token's expert output
    reaches only its own loss, so the tokens whose top-2 set differs get
    target -100 and both sides run again: that removes the flips exactly."""
    from flash_attention_tpu_torch.models import llama
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    params = llama.init_params(cfg2, seed=SEED + 4, device=dev)
    toks, tgt = _batch(torch, dev, cfg.vocab_size, 1, 256, SEED + 4)
    torch.set_num_threads(os.cpu_count() or 1)

    def run(tgt):
        out = []
        for device, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
            p = {n: w.detach().to(device, dtype).requires_grad_()
                 for n, w in params.items()}
            t0 = time.perf_counter()
            with _RouteLog() as log:
                loss = llama.train_loss(p, toks.to(device), tgt.to(device),
                                        cfg2)
                loss.backward()
            out.append((float(loss.detach()),
                        {n: w.grad for n, w in p.items()},
                        time.perf_counter() - t0, log.ids[:n_layers]))
            del p
        return out

    out = run(tgt)
    flips = ""
    if cfg.n_experts:
        assert n_layers == 1, "the flip mask is exact for one layer only"
        ids_card, ids_cpu = out[0][3][0].cpu(), out[1][3][0]
        flipped = (ids_card != ids_cpu).any(-1)
        n_flip = int(flipped.sum())
        flips = (f"; tokens routed apart (card vs CPU): {n_flip} of "
                 f"{flipped.numel()}, masked out of the loss")
        assert n_flip <= MAX_FLIP_SHARE * flipped.numel(), n_flip
        if n_flip:
            tgt = tgt.clone()
            tgt[0, flipped.to(tgt.device)] = -100
            out = run(tgt)
    (l_card, g_card, t_card, _), (l_cpu, g_cpu, t_cpu, _) = out
    rel = {n: float((g_card[n].float().cpu() - g_cpu[n]).norm()
                    / g_cpu[n].norm()) for n in g_cpu}
    worst = max(rel, key=rel.get)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"{model} train consistency (L{n_layers}, b1 s256, full width): "
          f"loss card bf16 {l_card:.6f} vs CPU fp32 {l_cpu:.6f} (rel "
          f"{loss_rel:.3e}); gradient rel L2 per parameter: "
          + ", ".join(f"{n} {r:.3e}" for n, r in sorted(rel.items()))
          + f"; worst {worst} (card {t_card:.2f} s, CPU {t_cpu:.2f} s)"
          + flips)
    assert all(torch.isfinite(g).all() for g in g_card.values())
    assert loss_rel <= TRAIN_LOSS_REL, loss_rel
    assert rel[worst] <= TRAIN_GRAD_REL_L2, (worst, rel[worst])


def train(torch, params, cfg, card, kernels, model, lr=LR,
          shape=(TRAIN_BATCH, TRAIN_SEQ)):
    """The training path: train_loss with remat, .backward() and plain SGD
    on a fixed (b, s) batch of ``shape``, with exact launch counts per step.
    The last step runs under the profiler."""
    import torch.nn.functional as F
    from flash_attention_tpu_torch.models import llama
    dev = params["embed"].device
    batch, seq = shape
    toks, tgt = _batch(torch, dev, cfg.vocab_size, batch, seq, SEED)
    with torch.no_grad():  # the inference forward's cross-entropy
        logits, _, _ = llama.prefill(params, toks, cfg, return_kv=False)
        ref = float(F.cross_entropy(logits.flatten(0, 1), tgt.flatten(),
                                    ignore_index=-100))
        del logits
    for w in params.values():
        w.requires_grad_(True)
    L = cfg.n_layers
    moe = 1 if cfg.n_experts else 0
    # forward, remat recompute and dx: three grouped matmuls each per layer
    want = {"flash_fwd": 2 * L, "flash_bwd_di": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "gmm": 9 * L * moe, "gmm_dw": 3 * L * moe,
            "qmm": 0}
    totals = dict.fromkeys(want, 0)
    losses, step_ms = [], []

    def step():
        loss = llama.train_loss(params, toks, tgt, cfg, remat=True)
        loss.backward()
        with torch.no_grad():
            for w in params.values():
                w.sub_(w.grad, alpha=lr)
        losses.append(float(loss.detach()))

    def routed(log):  # (L, E) bool: which experts got rows in each layer
        used = torch.zeros((L, cfg.n_experts), dtype=torch.bool, device=dev)
        for i, ids in enumerate(log.ids[:L]):  # the forward's calls
            used[i, ids.flatten().long()] = True
        return used

    def dead(n, g, used):
        """Non-finite, or all zero; for an expert stack, each (layer,
        expert) slice must be non-zero exactly where the expert got rows
        (an expert the router left empty gets exact zeros)."""
        if not bool(torch.isfinite(g).all()):
            return True
        if moe and n in ("w_gate", "w_up", "w_down"):
            live = g.flatten(2).abs().amax(-1).gt(0)
            return not torch.equal(live, used)
        return not bool(g.any())

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    empty = []  # (layer, expert) pairs without rows, per step
    for i in range(TRAIN_STEPS + 1):
        for k in kernels:
            k.launches = 0
        with _RouteLog() as log:
            if i < TRAIN_STEPS:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            else:
                profile_window(torch, f"{model} training step", step, card)
        launches = {k.name: k.launches for k in kernels if k.name in want}
        assert launches == want, (i, launches)
        for n in want:
            totals[n] += launches[n]
        used = routed(log) if moe else None
        empty.append(int((~used).sum()) if moe else 0)
        bad = [n for n, w in params.items() if dead(n, w.grad, used)]
        assert not bad, f"step {i}: gradients non-finite or all zero: {bad}"
        for w in params.values():
            w.grad = None
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        final = float(llama.train_loss(params, toks, tgt, cfg))
    assert all(np.isfinite(losses)) and np.isfinite(final), losses
    assert 0.0 < losses[0] < 20.0, losses
    assert abs(losses[0] - ref) <= TRAIN_FWD_REL * abs(ref), (losses[0], ref)
    assert final < losses[0], (losses, final)
    tokens = batch * seq
    steady = float(np.mean(step_ms[1:]))
    print(f"train {model} L{L} b{batch} s{seq} remat, SGD lr "
          f"{lr}: losses {[round(x, 6) for x in losses]}, after the last "
          f"step {final:.6f}; first loss vs inference-forward cross-entropy "
          f"{ref:.6f} (rel {abs(losses[0] - ref) / abs(ref):.2e})")
    print(f"train {model} step ms {[round(x, 3) for x in step_ms]} (step 1 "
          f"included first-use costs); steady {steady:.3f} ms, "
          f"{tokens / steady * 1e3:.1f} training tokens/s [{card}]")
    print(f"train {model} peak device memory: {peak / 2**30:.2f} GiB "
          f"[{card}]")
    print(f"{model} kernel launches per training step: {want}; on the "
          f"training path ({TRAIN_STEPS + 1} steps): {totals}")
    if moe:
        print(f"train {model}: (layer, expert) pairs the router left without "
              f"rows, per step: {empty} of {L * cfg.n_experts}; their "
              f"gradient slices were exactly 0, every other slice non-zero")
    return totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from flash_attention_tpu_torch.models import llama
    from flash_attention_tpu_torch.ops import _build
    from flash_attention_tpu_torch.ops import flash_bwd, flash_fwd, kv_update
    from flash_attention_tpu_torch.ops import moe, paged_attention, quant
    t_start = time.perf_counter()

    def mark(phase):  # the script's own clock at the start of each phase
        print(f"wall {time.perf_counter() - t_start:.1f} s: {phase}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card_line()
    PEAK["flops"], PEAK["bytes"] = _peaks(torch.cuda.get_device_name(0))
    KV_QUANT.update(int8=torch.int8, fp8=torch.float8_e4m3fn)
    print(f"card: {card}; peaks from its data sheet: bf16 dense "
          f"{PEAK['flops'] / 1e12:g} TFLOP/s, HBM {PEAK['bytes'] / 1e12:g} "
          f"TB/s")
    kernels = [flash_fwd.KERNEL, kv_update.KERNEL, paged_attention.KERNEL,
               *flash_bwd.KERNELS, *moe.KERNELS, quant.KERNEL]

    # 1. build every kernel from source, with the ptxas summary
    t0 = time.perf_counter()
    logs = _build.build(kernels, ptxas_verbose=True)
    print(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for fn, use in re.findall(r"entry function '(\w+)'.*?(Used [^\n]*)",
                                  log, re.S):
            tmpl = re.search(r"kernel(I.*)EEv", fn)
            print(f"  {name} {tmpl.group(1) if tmpl else fn}: {use.strip()}")
        for line in log.splitlines():
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                               r"loads", line)
            if (spills and spills.group(0) != "0 bytes spill stores, 0 bytes "
                    "spill loads") or "C75" in line:  # "wgmma serialized"
                print(f"  {name}: {line.strip()}")
                assert name not in HOPPER_KERNELS, \
                    f"{name}: a spill or a serialized wgmma"
    for k in kernels:
        if k.name in HOPPER_KERNELS:
            per_fn = _sass_counts(_build, k)
            for fn, counts in per_fn.items():
                print(f"  {k.name} {fn} SASS: {counts}")
            assert all(sum(c[op] for c in per_fn.values())
                       for op in ("HGMMA", "UTMALDG")), \
                f"{k.name}: no wgmma or TMA in SASS"
            if k.name in SASS_NO_CAP:
                _check_cap_instances(k.name, per_fn)

    cfg = llama.LlamaConfig.llama3_8b()
    mix = llama.LlamaConfig.mixtral_8x7b()
    mistral = llama.LlamaConfig.mistral_7b()
    prompts = _prompts(cfg.vocab_size)
    bucket = max(32, 1 << (max(map(len, prompts)) - 1).bit_length())
    print(f"prompt lengths {[len(p) for p in prompts]} -> prefill bucket "
          f"{bucket}, batch {MAX_BATCH}")

    mark("kernel checks")
    # 2. each kernel against its plain version at its path's shapes
    with torch.inference_mode():
        entries = [check_flash(torch, dev, bucket, cfg, card),
                   check_kv_write(torch, dev, cfg, card),
                   check_paged(torch, dev, cfg, card),
                   check_gmm(torch, dev, mix, card),
                   check_gmm_dw(torch, dev, mix, card),
                   check_qmm(torch, dev, cfg, card)]
    torch.cuda.empty_cache()
    entries += check_bwd(torch, dev, cfg, card)
    torch.cuda.empty_cache()
    # the window and softcap modes, at Mistral's widths
    modes = check_window_softcap(torch, dev, mistral, card)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        modes["paged_attention"] = check_paged_window(torch, dev, mistral,
                                                      card)
    for e in entries:
        if e["name"] in modes:
            e["shapes"].update(modes[e["name"]])
    torch.cuda.empty_cache()
    # the d-256 instances, at Gemma-2-9B's widths
    gemma = llama.LlamaConfig.gemma2_9b()
    for name, shapes in check_head_dim_256(torch, dev, gemma, card).items():
        e = next(e for e in entries if e["name"] == name)
        e.setdefault("shapes", {}).update(shapes)
    mark("quantized KV kernel checks")
    # the quantized KV cache's instances: the kv write's two (rows in the
    # cache's type; bf16 rows quantized in the kernel) and the paged
    # kernel's int8 and fp8, d 64, 128 and 256, with window and softcap
    with torch.inference_mode():
        for name, shapes in (
                ("kv_write", check_kv_write_quant(torch, dev, cfg, card)),
                ("paged_attention", check_paged_quant(torch, dev, cfg, gemma,
                                                      card))):
            e = next(e for e in entries if e["name"] == name)
            e.setdefault("shapes", {}).update(shapes)
    torch.cuda.empty_cache()
    mark("segmented instances")
    paths = {}  # path -> {kernel: launches}
    # the segmented instances at Llama-3-8B's and Gemma-2-9B's widths; the
    # library's varlen entry points as the path "varlen"
    t0 = time.perf_counter()
    for seg_cfg, tag, seg_paths in ((cfg, "d128", paths),
                                    (gemma, "d256", None)):
        for name, shapes in check_segments(torch, dev, seg_cfg, card, tag,
                                           kernels, seg_paths).items():
            e = next(e for e in entries if e["name"] == name)
            e["shapes"].update(shapes)
        torch.cuda.empty_cache()
    print(f"check_segments: {time.perf_counter() - t0:.1f} s")
    for name in SEG_KERNELS + ("flash_bwd_di",):
        assert paths["varlen"][name] > 0, (name, paths["varlen"])
    check_moe_ffn(torch, dev, mix, card)
    torch.cuda.empty_cache()

    mark("Llama-3-8B")
    # 3. Llama-3-8B, full width and depth: serving, prefill vs decode, then
    #    training (a 2-layer card-vs-CPU check first)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"init_params Llama-3-8B bf16 on device: "
          f"{time.perf_counter() - t0:.3f} s")
    paths["serve"], outputs = serve(torch, params, cfg, prompts, card,
                                    kernels, "Llama-3-8B")
    consistency(torch, params, cfg, prompts, "Llama-3-8B")
    ref_rows = generated_logits(torch, params, cfg, prompts, outputs)
    # the same weights with chunked prefill (Mistral's traffic, chunks of
    # CHUNK_SIZE) against an unchunked engine, and the masked-prefix control
    t0 = time.perf_counter()
    chunk_prompts = _prompts(cfg.vocab_size, MISTRAL_PROMPT_LENS)
    paths["serve_chunked"], _, rows_u = serve_chunked(
        torch, params, cfg, chunk_prompts, card, kernels, "Llama-3-8B")
    chunk_control(torch, params, cfg, chunk_prompts[0], rows_u[0], card,
                  "Llama-3-8B")
    del rows_u
    torch.cuda.empty_cache()
    print(f"Llama-3-8B chunked serving phase: {time.perf_counter() - t0:.1f} s")
    # the same weights with a quantized KV cache, int8 then fp8: serving,
    # the consistency gates, and the quality of prefill(kv_fake_quant)
    # against bf16 on the served sequences
    t0 = time.perf_counter()
    for name, dtype in KV_QUANT.items():
        paths[f"serve_kv_{name}"], kv_outputs = serve_kv_quant(
            torch, params, cfg, prompts, card, kernels, name)
        torch.cuda.empty_cache()
        quant_quality(torch, ref_rows,
                      generated_logits(torch, params, cfg, prompts, outputs,
                                       kv_fake_quant=dtype),
                      outputs, kv_outputs,
                      f"Llama-3-8B KV {name} (prefill kv_fake_quant)")
    kv_quant_consistency(torch, dev, params, cfg, prompts, card)
    torch.cuda.empty_cache()
    print(f"Llama-3-8B quantized KV phase: {time.perf_counter() - t0:.1f} s")
    train_consistency(torch, dev, cfg, card, "Llama-3-8B")
    torch.cuda.empty_cache()
    paths["train"] = train(torch, params, cfg, card, kernels, "Llama-3-8B")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mark("Llama-3-8B int8 and int4")
    # 4. the same Llama-3-8B weights (the same seed) quantized, int8 then
    #    int4: only the quantized copy and the bf16 embedding and norms stay
    #    on the card while it serves
    for bits in QUANT_BITS:
        model = f"Llama-3-8B int{bits}"
        params = llama.init_params(cfg, seed=SEED, device=dev,
                                   dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qparams = llama.quantize_params(params, bits=bits)
        torch.cuda.synchronize()
        print(f"quantize_params {model} on device: "
              f"{time.perf_counter() - t0:.3f} s; weight rel L2 error "
              f"{_quant_error(torch, params, qparams)}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        paths[f"serve_int{bits}"], q_outputs = serve(
            torch, qparams, cfg, prompts, card, kernels, model)
        consistency(torch, qparams, cfg, prompts, model)
        quant_quality(torch, ref_rows,
                      generated_logits(torch, qparams, cfg, prompts, outputs),
                      outputs, q_outputs, model)
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    del ref_rows
    quant_card_vs_cpu(torch, dev, cfg, card)
    gc.collect()
    torch.cuda.empty_cache()

    mark("Mixtral-8x7B serving")
    # 5. Mixtral-8x7B, full width, 16 layers: serving, prefill vs decode
    mix_serve = dataclasses.replace(mix, n_layers=MIX_SERVE_LAYERS)
    mix_prompts = _prompts(mix.vocab_size)
    t0 = time.perf_counter()
    params = llama.init_params(mix_serve, seed=SEED, device=dev,
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"init_params Mixtral-8x7B L{MIX_SERVE_LAYERS} bf16 on device: "
          f"{time.perf_counter() - t0:.3f} s")
    paths["serve_mixtral"], _ = serve(torch, params, mix_serve, mix_prompts,
                                      card, kernels, "Mixtral-8x7B")
    consistency(torch, params, mix_serve, mix_prompts, "Mixtral-8x7B",
                n_prompts=MIX_CONSISTENCY_PROMPTS)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mark("Mixtral-8x7B training")
    # 6. Mixtral training: a 1-layer card-vs-CPU check, then 8 layers
    train_consistency(torch, dev, mix, card, "Mixtral-8x7B", n_layers=1)
    gc.collect()
    torch.cuda.empty_cache()
    mix_train = dataclasses.replace(mix, n_layers=MIX_TRAIN_LAYERS)
    params = llama.init_params(mix_train, seed=SEED, device=dev,
                               dtype=torch.bfloat16)
    paths["train_mixtral"] = train(torch, params, mix_train, card, kernels,
                                   "Mixtral-8x7B", lr=MIX_LR)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mark("Mistral-7B")
    # 7. Mistral-7B-v0.1 (window 4096 on every layer), full width and depth:
    #    serving with window page reclamation, then training on 1 x 8192
    t0 = time.perf_counter()
    params = llama.init_params(mistral, seed=SEED, device=dev,
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"init_params Mistral-7B bf16 on device: "
          f"{time.perf_counter() - t0:.3f} s")
    pages = WindowPages(mistral.sliding_window, PAGE_SIZE)
    paths["serve_mistral"], _ = serve(
        torch, params, mistral, _prompts(mistral.vocab_size,
                                         MISTRAL_PROMPT_LENS),
        card, kernels, "Mistral-7B", max_seq=MISTRAL_MAX_SEQ,
        after_step=pages)
    print(pages.report("Mistral-7B"))
    assert pages.freed_in_decode > 0, "the window freed no page in decode"
    torch.cuda.empty_cache()
    paths["train_mistral"] = train(torch, params, mistral, card, kernels,
                                   "Mistral-7B", shape=MISTRAL_TRAIN)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mark("window and softcap consistency")
    # 8. consistency of the window and softcap paths: Mistral at 2 layers
    #    with the window cut to 64, and the Gemma-2 config (window every
    #    second layer, and every layer), card against CPU; the Gemma-2
    #    config served through the engine
    m64 = dataclasses.replace(mistral, n_layers=2, sliding_window=WINDOW_CUT)
    window_consistency(torch, dev, m64, card, "Mistral-7B L2 W64")
    train_consistency(torch, dev, m64, card, "Mistral-7B W64")
    for pattern in (2, 1):
        gcfg = llama.LlamaConfig.tiny_gemma2(
            n_layers=GEMMA_LAYERS, window_pattern=pattern, **GEMMA_CAPS)
        model = (f"Gemma-2 config (tiny_gemma2 L{GEMMA_LAYERS}, window "
                 f"{gcfg.sliding_window} every {pattern} layers, softcaps "
                 f"{gcfg.attn_softcap:g}/{gcfg.final_softcap:g})")
        window_consistency(torch, dev, gcfg, card, model)
        train_consistency(torch, dev, gcfg, card, model,
                          n_layers=GEMMA_LAYERS)
        params = llama.init_params(gcfg, seed=SEED, device=dev,
                                   dtype=torch.bfloat16)
        gpages = WindowPages(gcfg.sliding_window, PAGE_SIZE) \
            if pattern == 1 else None
        paths[f"serve_gemma2_every{pattern}"], _ = serve(
            torch, params, gcfg, _prompts(gcfg.vocab_size, GEMMA_PROMPT_LENS),
            card, kernels, model, max_seq=GEMMA_MAX_SEQ, after_step=gpages)
        if gpages is not None:
            print(gpages.report(model))
        del params
    # the Gemma-2 config served with chunked prefill: the window and the
    # softcaps through the segmented forward, card against CPU
    paths["serve_chunked_gemma2"] = gemma2_chunked(torch, dev, card, kernels)
    paths["serve_chunked_gemma2_kv_int8"] = gemma2_kv_quant(torch, dev, card,
                                                            kernels)
    gc.collect()
    torch.cuda.empty_cache()

    mark("Gemma-2-9B")
    # 9. Gemma-2-9B (head dim 256; window 4096 on every second layer,
    #    softcaps 50/30), full width and depth: its consistency at 2 layers
    #    (card against CPU, with the served prompts' logits gate), then
    #    serving with Mistral's traffic (every page held: JAX's rule for
    #    global layers), then training on 1 x 8192
    g2 = dataclasses.replace(gemma, n_layers=GEMMA2_LAYERS_CHECK,
                             sliding_window=WINDOW_CUT, **GEMMA_CAPS)
    model = (f"Gemma-2-9B L{GEMMA2_LAYERS_CHECK} W{WINDOW_CUT} softcaps "
             f"{g2.attn_softcap:g}/{g2.final_softcap:g}")
    window_consistency(torch, dev, g2, card, model,
                       served=MISTRAL_PROMPT_LENS)
    train_consistency(torch, dev, g2, card, model,
                      n_layers=GEMMA2_LAYERS_CHECK)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = llama.init_params(gemma, seed=SEED, device=dev,
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"init_params Gemma-2-9B bf16 on device: "
          f"{time.perf_counter() - t0:.3f} s; {_weight_bytes(params)}")
    pages = WindowPages(None, PAGE_SIZE)
    paths["serve_gemma2_9b"], _ = serve(
        torch, params, gemma, _prompts(gemma.vocab_size, MISTRAL_PROMPT_LENS),
        card, kernels, "Gemma-2-9B", max_seq=MISTRAL_MAX_SEQ,
        after_step=pages)
    print(pages.report("Gemma-2-9B"))
    assert pages.freed_in_decode == 0, "a page was freed under global layers"
    torch.cuda.empty_cache()
    w_bytes = sum(w.numel() * w.element_size() for w in params.values())
    logits = MISTRAL_TRAIN[0] * MISTRAL_TRAIN[1] * gemma.vocab_size * 4
    print(f"Gemma-2-9B training, reckoned peak: weights and gradients "
          f"{2 * w_bytes / 2**30:.2f} GiB, plus fp32 logits of "
          f"{logits / 2**30:.2f} GiB a copy (the softcap, log-softmax and "
          f"their gradients hold about four at once): about "
          f"{(2 * w_bytes + 4 * logits) / 2**30:.2f} GiB")
    paths["train_gemma2_9b"] = train(torch, params, gemma, card, kernels,
                                     "Gemma-2-9B", shape=MISTRAL_TRAIN)
    del params

    kernel_of = {"kv_write": "kv_update"}  # entry name -> counter name
    for e in entries:
        by_path = {p: n[kernel_of.get(e["name"], e["name"])]
                   for p, n in paths.items()
                   if n.get(kernel_of.get(e["name"], e["name"]), 0)}
        e["launches"] = sum(by_path.values())
        if len(by_path) > 1:
            e["launches_by_path"] = by_path
        assert e["launches"] > 0, f"{e['name']} never launched on a path"
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")
    print(card)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
