#!/usr/bin/env python3
"""Call the d-384/512 attention kernels thousands of times and count the
calls whose outputs differ from the first call's.

    python3 tools/probe_wide_stress.py [--calls N] [--kernels fwd,dq,dkv]

The wide forward, dq and dK/dV kernels (``csrc/flash_fwd_wide.cu``,
``csrc/flash_bwd_dq_pair.cu`` and ``csrc/flash_bwd_dq_wide.cu``,
``csrc/flash_bwd_dkv_wide.cu``) hand buffers between warpgroups, and the dq
pair and the dK/dV kernel between the two CTAs of a cluster, writing into
each other's shared memory and releasing each other's buffers by remote
barrier arrivals; a buffer overwritten while its reader still reads it
shows as a call whose output differs now and then. Each case (causal bf16,
h group/1: the packed probe shape d512 b2 s512 h8/1, then groups 8 and 64
at d 384 and 512) holds the first dense call to the plain version (the
forward at the forward gates, O_TOLS and LSE_TOLS; dq, dk and dv at the
bf16 backward gates with atol no tighter than one ulp of the output's
largest magnitude), then makes N calls (2000 by default), dense and packed
in turn (the batch's rows as one segmented row, which must give the dense
call's bits), and counts every call that is not bit-identical to the first.
Prints one line a case with the card's name and power limit; exits 1 if any
call differed. Imports no JAX.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from flash_attention_tpu_torch.ops import flash_bwd as fb  # noqa: E402
from flash_attention_tpu_torch.ops import flash_fwd as fm  # noqa: E402
from flash_attention_tpu_torch.utils.metrics import assert_metrics  # noqa: E402

O_TOLS = {"atol": 4e-2, "mean_atol": 2e-3, "mean_rtol": 5e-2}
LSE_TOLS = {"atol": 1e-2, "mean_atol": 1e-3, "mean_rtol": 1e-2}
BWD_TOLS = {"atol": 4e-2, "mean_atol": 2e-3, "mean_rtol": 2e-1}
# (label, d, group, b, s): the probe shape where the dK/dV exchange once
# gave a wrong packed dv, then groups 8 and 64 at both head dims
CASES = (("probe d512 b2 s512 h8/1", 512, 8, 2, 512),
         ("group 8 d384 b2 s512", 384, 8, 2, 512),
         ("group 64 d512 b2 s2048", 512, 64, 2, 2048),
         ("group 64 d384 b2 s2048", 384, 64, 2, 2048))


def ulp_tols(tols, ref):
    top = float(ref.abs().max())
    if top == 0:
        return tols
    ulp = torch.finfo(ref.dtype).eps * 2.0 ** math.floor(math.log2(top))
    return {**tols, "atol": max(tols["atol"], ulp)}


def dense_segs(b, s, dev):
    zero = torch.zeros((b, s), dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    return zero, zero, pos.contiguous(), pos.contiguous()


def run_case(kernel, d, group, b, s, calls, dev):
    """(calls made, calls that differed from the first, seconds)."""
    g = torch.Generator(device=dev).manual_seed(d + group + s)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((b, s, group, d), (b, s, 1, d), (b, s, 1, d),
                                 (b, s, group, d)))
    kw = dict(causal=True, sm_scale=d**-0.5)
    o, lse = fm.flash_fwd(q, k, v, **kw)
    di = fb.flash_bwd_di(o, do)
    seg = torch.arange(b * s, dtype=torch.int32, device=dev)[None] // s
    pos = torch.arange(b * s, dtype=torch.int32, device=dev)[None] % s
    segs = (seg, seg, pos, pos)

    def flat(x):
        return x.reshape(1, b * s, *x.shape[2:])

    def rows(x):  # (b, h, s) -> the packed row's (1, h, b s)
        return x.transpose(0, 1).reshape(1, x.shape[1], b * s).contiguous()

    if kernel == "fwd":
        dense = lambda: fm.flash_fwd(q, k, v, **kw)  # noqa: E731
        packed = lambda: fm.flash_fwd(flat(q), flat(k), flat(v), segs=segs,  # noqa: E731
                                      **kw)
        first = dense()
        ref = fm.flash_fwd_segmented_reference(q, k, v, dense_segs(b, s, dev),
                                               **kw)
        assert_metrics(f"fwd d{d} group {group}", first[0], ref[0], O_TOLS)
        assert_metrics(f"fwd d{d} group {group} lse", first[1], ref[1],
                       LSE_TOLS)
        unpack = (lambda out: (out[0].view(first[0].shape),  # noqa: E731
                               out[1].view(1, group, b, s).transpose(0, 2)
                               [:, :, 0]))
    elif kernel == "dq":
        dense = lambda: (fb.flash_bwd_dq(q, k, v, do, lse, di, **kw),)  # noqa: E731
        packed = lambda: (fb.flash_bwd_dq(  # noqa: E731
            flat(q), flat(k), flat(v), flat(do), rows(lse), rows(di),
            segs=segs, **kw),)
        first = dense()
        ref = fb.dq_reference(q, k, v, do, lse, fb.di_reference(o, do),
                              segs=dense_segs(b, s, dev), **kw)
        assert_metrics(f"dq d{d} group {group}", first[0], ref,
                       ulp_tols(BWD_TOLS, ref))
        unpack = lambda out: (out[0].view(first[0].shape),)  # noqa: E731
    else:
        dense = lambda: fb.flash_bwd_dkv(q, k, v, do, lse, di, **kw)  # noqa: E731
        packed = lambda: fb.flash_bwd_dkv(  # noqa: E731
            flat(q), flat(k), flat(v), flat(do), rows(lse), rows(di),
            segs=segs, **kw)
        first = dense()
        refs = fb.dkv_reference(q, k, v, do, lse, fb.di_reference(o, do),
                                segs=dense_segs(b, s, dev), **kw)
        for name, x, ref in zip(("dk", "dv"), first, refs):
            assert_metrics(f"{name} d{d} group {group}", x, ref,
                           ulp_tols(BWD_TOLS, ref))
        unpack = lambda out: tuple(x.view(first[0].shape) for x in out)  # noqa: E731
    del ref
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bad = 0
    for i in range(calls):
        out = dense() if i % 2 == 0 else unpack(packed())
        if not all(torch.equal(x, y) for x, y in zip(out, first)):
            bad += 1
    return calls, bad, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_wide_stress: needs an NVIDIA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--kernels", default="dkv,fwd,dq")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    total_bad = 0
    with torch.inference_mode():
        for kernel in args.kernels.split(","):
            for label, d, group, b, s in CASES:
                n, bad, sec = run_case(kernel, d, group, b, s, args.calls,
                                       dev)
                total_bad += bad
                print(f"{kernel} {label} causal: {n} calls (dense and packed "
                      f"in turn), {bad} not bit-identical to the first; "
                      f"{sec:.1f} s [{card}]", flush=True)
                torch.cuda.empty_cache()
    print(f"probe_wide_stress: {total_bad} calls differed [{card}]")
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main())
