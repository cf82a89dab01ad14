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
version and against the first source (bit for bit) on one shape, and timed with CUDA events at b8 and b2 s2048 h32/8
d128 (causal and not), in the order a b .. b a; SDPA with ``enable_gqa`` is
timed last. Prints the card's name and power limit with every line.
Imports no JAX.
"""

from __future__ import annotations

import importlib.util
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
S, H, HK, D = 2048, 32, 8, 128


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

    inputs = {b: (rnd(b, S, H, D), rnd(b, S, HK, D), rnd(b, S, HK, D))
              for b in {b for b, _ in SHAPES}}
    qs, ks, vs = rnd(2, 1000, 8, D), rnd(2, 700, 2, D), rnd(2, 700, 2, D)
    o_ref, _ = reference_attention(qs, ks, vs, causal=True)
    times = {n: {sh: [] for sh in SHAPES} for n in mods}
    first = None
    for name in list(mods) + list(mods)[::-1]:
        mod = mods[name]
        o, lse = mod.flash_fwd(qs, ks, vs, causal=True, sm_scale=D**-0.5)
        first = first or (name, o, lse)
        err = (o.float() - o_ref.float()).abs().max().item()
        same = torch.equal(o, first[1]) and torch.equal(lse, first[2])
        print(f"{name}: max abs err against the plain version {err:.3e}; "
              f"O and LSE bit-identical to {first[0]}'s: {same}")
        for b, causal in SHAPES:
            q, k, v = inputs[b]
            same = same and all(torch.equal(x, y) for x, y in zip(
                mod.flash_fwd(q, k, v, causal=causal, sm_scale=D**-0.5),
                mods[first[0]].flash_fwd(q, k, v, causal=causal,
                                         sm_scale=D**-0.5)))
            times[name][(b, causal)].append(time_ms(
                lambda: mod.flash_fwd(q, k, v, causal=causal,
                                      sm_scale=D**-0.5)))
        print(f"{name}: at every timed shape too, O and LSE bit-identical to "
              f"{first[0]}'s: {same}")
    for b, causal in SHAPES:
        q, k, v = inputs[b]
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True))
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 4.0 * D * pairs * b * H
        parts = ", ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in r[(b, causal)])} ms "
            f"({flops / min(r[(b, causal)]) / 1e9:.0f} TFLOP/s)"
            for n, r in times.items())
        print(f"b{b} s{S} h{H}/{HK} d{D} causal={causal}: {parts}; "
              f"sdpa {sdpa:.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
