#!/usr/bin/env python3
"""Time sources of the port's forward kernel against each other on one card.

    python3 tools/ab_flash_fwd.py NAME=PATH [NAME=PATH ...]

Each PATH is a CUDA source with the C interface of
``flash_attention_tpu_torch/csrc/flash_fwd.cu`` (``fat_flash_fwd``); its
own headers are found beside it. A ``flash_fwd.py`` beside it, the
``ops/flash_fwd.py`` whose wrapper calls that interface, runs that source
(an earlier revision's interface may differ). To compare with an earlier
kernel, copy that revision's ``flash_fwd.cu``, headers and wrapper into a
directory that git ignores, for example:

    mkdir -p build/old && for f in flash_fwd.cu flash_common.cuh \\
        hopper_common.cuh; do
      git show REV:flash_attention_tpu_torch/csrc/$f > build/old/$f; done
    git show REV:flash_attention_tpu_torch/ops/flash_fwd.py \\
        > build/old/flash_fwd.py
    python3 tools/ab_flash_fwd.py old=build/old/flash_fwd.cu \\
        new=flash_attention_tpu_torch/csrc/flash_fwd.cu

Every source is built with the port's flags, checked against the plain
version and against the first source (bit for bit) on one shape and at
every timed shape, and timed with CUDA events at b8 and b2 s2048 h32/8, d 64
and 128 (causal and not), in the order a b .. b a; SDPA with ``enable_gqa`` is
timed last. A source whose wrapper takes ``segs`` also runs the segmented
instance on 8 packed sequences of 2048 (one row of 16384 tokens, causal),
checked and timed the same way against the other such sources. Prints the
card's name and power limit with every line. Imports no JAX.
"""

from __future__ import annotations

import importlib.util
import inspect
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from flash_attention_tpu_torch.ops import _build  # noqa: E402
from flash_attention_tpu_torch.ops import flash_fwd as fm  # noqa: E402
from flash_attention_tpu_torch.ops.reference import reference_attention  # noqa: E402

SHAPES = [(8, True), (8, False), (2, True)]  # (batch, causal) at s 2048
SEG_BATCH = 8  # packed sequences of S tokens in the segmented cell
S, H, HK = 2048, 32, 8
DIMS = (64, 128)  # the head dims whose instances are compared


def time_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
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


def load_wrapper(path: pathlib.Path, name: str):
    """A private copy of a forward wrapper module, so each source keeps its
    kernel and its interface."""
    spec = importlib.util.spec_from_file_location(f"ab_fwd_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def packed_segs(dev, n: int, s: int):
    """(q_seg, kv_seg, q_pos, kv_pos) of n packed sequences of s tokens."""
    seg = torch.arange(n * s, device=dev, dtype=torch.int32) // s
    pos = torch.arange(n * s, device=dev, dtype=torch.int32) % s
    return seg[None], seg[None], pos[None], pos[None]


def takes_segs(mod) -> bool:
    return "segs" in inspect.signature(mod.flash_fwd).parameters


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_flash_fwd: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    mods = {}
    for name, path in (arg.split("=", 1) for arg in sys.argv[1:]):
        src = pathlib.Path(path).resolve()
        wrapper = src.parent / "flash_fwd.py"
        mod = load_wrapper(wrapper if wrapper.exists()
                           else pathlib.Path(fm.__file__), name)
        mod.KERNEL = _build.Kernel(f"ab_{name}", str(src), mod.KERNEL.argtypes)
        mods[name] = mod
    for name, log in _build.build([m.KERNEL for m in mods.values()],
                                  ptxas_verbose=True).items():
        for line in log.splitlines():
            if "Used" in line or ("spill" in line and " 0 bytes spill" not in line):
                print(f"  {name}: {line.strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    inputs = {(b, d): (rnd(b, S, H, d), rnd(b, S, HK, d), rnd(b, S, HK, d))
              for d in DIMS for b in {b for b, _ in SHAPES}}
    checks = {d: (rnd(2, 1000, 8, d), rnd(2, 700, 2, d), rnd(2, 700, 2, d))
              for d in DIMS}
    refs = {d: reference_attention(*x, causal=True)[0]
            for d, x in checks.items()}
    cells = [(b, causal, d) for d in DIMS for b, causal in SHAPES]
    segs = packed_segs(dev, SEG_BATCH, S)
    seg_inputs = {d: tuple(x.reshape(1, SEG_BATCH * S, *x.shape[2:])
                           for x in inputs[(SEG_BATCH, d)]) for d in DIMS}
    seg_mods = [n for n, m in mods.items() if takes_segs(m)]
    seg_times = {n: {d: [] for d in DIMS} for n in seg_mods}
    times = {n: {c: [] for c in cells} for n in mods}
    first = {}  # d -> (name, O, LSE) of the first source
    for name in list(mods) + list(mods)[::-1]:
        mod = mods[name]
        same = True
        for d in DIMS:
            o, lse = mod.flash_fwd(*checks[d], causal=True, sm_scale=d**-0.5)
            first.setdefault(d, (name, o, lse))
            err = (o.float() - refs[d].float()).abs().max().item()
            same_d = torch.equal(o, first[d][1]) and torch.equal(
                lse, first[d][2])
            same = same and same_d
            print(f"{name} d{d}: max abs err against the plain version "
                  f"{err:.3e}; O and LSE bit-identical to {first[d][0]}'s: "
                  f"{same_d}")
        ref_mod = mods[first[DIMS[0]][0]]
        for b, causal, d in cells:
            q, k, v = inputs[(b, d)]
            kw = dict(causal=causal, sm_scale=d**-0.5)
            same = same and all(torch.equal(x, y) for x, y in zip(
                mod.flash_fwd(q, k, v, **kw), ref_mod.flash_fwd(q, k, v, **kw)))
            times[name][(b, causal, d)].append(time_ms(
                lambda: mod.flash_fwd(q, k, v, **kw)))
        print(f"{name}: at every timed shape too, O and LSE bit-identical to "
              f"{first[DIMS[0]][0]}'s: {same}")
        if name in seg_mods:
            seg_ref = mods[seg_mods[0]]
            for d in DIMS:
                kw = dict(causal=True, sm_scale=d**-0.5, segs=segs)
                out = mod.flash_fwd(*seg_inputs[d], **kw)
                same_seg = all(torch.equal(x, y) for x, y in zip(
                    out, seg_ref.flash_fwd(*seg_inputs[d], **kw)))
                seg_times[name][d].append(time_ms(
                    lambda: mod.flash_fwd(*seg_inputs[d], **kw)))
                print(f"{name} segmented {SEG_BATCH} x {S} packed d{d}: O "
                      f"and LSE bit-identical to {seg_mods[0]}'s: {same_seg}")
    for b, causal, d in cells:
        q, k, v = inputs[(b, d)]
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True))
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 4.0 * d * pairs * b * H
        parts = ", ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in r[(b, causal, d)])} ms "
            f"({flops / min(r[(b, causal, d)]) / 1e9:.0f} TFLOP/s)"
            for n, r in times.items())
        print(f"b{b} s{S} h{H}/{HK} d{d} causal={causal}: {parts}; "
              f"sdpa {sdpa:.4f} ms [{card}]")
    for d in DIMS:
        if seg_mods:
            parts = ", ".join(f"{n} {' / '.join(f'{t:.4f}' for t in r[d])} ms"
                              for n, r in seg_times.items())
            print(f"segmented {SEG_BATCH} x {S} packed causal h{H}/{HK} "
                  f"d{d}: {parts} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
