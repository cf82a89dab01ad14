#!/usr/bin/env python3
"""Time sources of the port's paged-attention decode kernel against each
other on one card.

    python3 tools/ab_paged.py NAME=DIR [NAME=DIR ...]

Each DIR holds a ``paged_attention.cu`` with the C interface
``fat_paged_attention`` and the headers it includes. A DIR may also hold the
``ops/paged_attention.py`` whose wrapper calls that interface, as
``paged_attention.py``: its ``paged_attention`` then runs that source (an
earlier revision's interface may differ). To compare with an earlier
revision, copy its files into a directory that git ignores:

    mkdir -p build/old_paged && for f in paged_attention.cu \\
        flash_common.cuh hopper_common.cuh; do
      git show REV:flash_attention_tpu_torch/csrc/$f > build/old_paged/$f; done
    git show REV:flash_attention_tpu_torch/ops/paged_attention.py \\
        > build/old_paged/paged_attention.py
    python3 tools/ab_paged.py old=build/old_paged \\
        new=flash_attention_tpu_torch/csrc

Every source is built with the port's flags (its ``-Xptxas -v`` register,
spill and C75xx lines printed). At Llama-3-8B's attention widths (32 query
and 8 kv heads, d 64 and 128, bf16) in a pool of 32 layers of 512 pages of 64
tokens, b 8, three sets of lengths: ``linspace(1, 4096, 8)``, the served
decode lengths (the serving prompts plus 16 tokens) and every row full
(4096). Each output is compared
with the first source's bit for bit; then each source is timed in the order
a b .. b a, cold: the 32 calls of a decode step, each on another layer's
pages, captured in one CUDA graph (device time per call). Last, each
wrapper's host time per call: the mean wall of 1000 eager calls issued
while the card is kept busy, so that no call waits for the card. Prints the
card's name and power limit with every line. Imports no JAX.
"""

from __future__ import annotations

import importlib.util
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from flash_attention_tpu_torch.ops import _build  # noqa: E402
from flash_attention_tpu_torch.ops import paged_attention as pa  # noqa: E402

L, H, HK, B = 32, 32, 8, 8
DIMS = (64, 128)  # the head dims whose instances are compared
PAGE_SIZE, TOTAL_PAGES, MAX_SEQ = 64, 512, 4096
SERVED = [1762, 1351, 1109, 646, 719, 206, 272, 159]  # chip_smoke's prompts
LENGTHS = {"linspace(1, 4096, 8)": np.linspace(1, MAX_SEQ, B).astype(np.int32),
           "served decode (prompts + 16)": np.asarray(SERVED, np.int32) + 16,
           "every row 4096": np.full(B, MAX_SEQ, np.int32)}
HOST_CALLS = 1000


def time_ms(fn, iters: int) -> float:
    for _ in range(2):
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


def graph_calls_ms(fns) -> float:
    """Device ms per call of the calls ``fns`` captured in one CUDA graph."""
    fns[0]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    return time_ms(graph.replay, 5) / len(fns)


def host_us(fn, calls: int = HOST_CALLS, batch: int = 100) -> float:
    """Mean host wall (us) of eager calls issued behind a long device sleep,
    in batches, so that the card never drains the queue meanwhile."""
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


def load_wrapper(path: pathlib.Path, name: str):
    """A private copy of a paged-attention module, so each source keeps its
    kernel."""
    spec = importlib.util.spec_from_file_location(f"ab_paged_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_paged: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    mods = {}
    for name, path in (arg.split("=", 1) for arg in sys.argv[1:]):
        src = pathlib.Path(path).resolve()
        wrapper = src / "paged_attention.py"
        mod = load_wrapper(wrapper if wrapper.exists()
                           else pathlib.Path(pa.__file__), name)
        mod.KERNEL = _build.Kernel(f"ab_{name}_paged",
                                   str(src / "paged_attention.cu"),
                                   mod.KERNEL.argtypes)
        mods[name] = mod
    for name, log in _build.build([m.KERNEL for m in mods.values()],
                                  ptxas_verbose=True).items():
        for line in log.splitlines():
            if "Used" in line or "C75" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    pps = MAX_SEQ // PAGE_SIZE
    tables = torch.randperm(TOTAL_PAGES, generator=g, device=dev)[:B * pps]
    tables = tables.reshape(B, pps).to(torch.int32)
    first = next(iter(mods))
    for d in DIMS:
        shape = (L, HK, TOTAL_PAGES, PAGE_SIZE, d)
        kp = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        vp = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        q = torch.randn((B, H, d), generator=g, device=dev).to(torch.bfloat16)
        for label, lens in LENGTHS.items():
            lengths = torch.from_numpy(lens).to(dev)
            out = {name: mod.paged_attention(q, kp, vp, lengths, tables,
                                             layer=L - 1)
                   for name, mod in mods.items()}
            same = {name: torch.equal(o, out[first]) for name, o in out.items()}
            tokens = int(lens.sum())
            nbytes = tokens * HK * d * 2 * 2 + 2 * 2 * q.numel()
            times = {name: [] for name in mods}
            for name in list(mods) + list(mods)[::-1]:
                mod = mods[name]
                times[name].append(graph_calls_ms([
                    lambda mod=mod, i=i: mod.paged_attention(
                        q, kp, vp, lengths, tables, layer=i)
                    for i in range(L)]))
            row = ", ".join(
                f"{name} {' / '.join(f'{v:.5f}' for v in ts)} ms "
                f"({nbytes / min(ts) / 1e6:.1f} GB/s)"
                for name, ts in times.items())
            print(f"paged d{d} {label}, {nbytes / 1e6:.1f} MB a call, cold "
                  f"(32 layers in a CUDA graph): {row}; bit-identical to "
                  f"{first}'s: {same} [{card}]")
    lengths = torch.from_numpy(LENGTHS["served decode (prompts + 16)"]).to(dev)
    host = {name: [] for name in mods}
    for name in list(mods) + list(mods)[::-1]:
        mod = mods[name]
        host[name].append(host_us(lambda mod=mod: mod.paged_attention(
            q, kp, vp, lengths, tables, layer=0)))
    print("paged wrapper host time per call (1000 eager calls, card kept "
          "busy): " + ", ".join(f"{name} {' / '.join(f'{v:.2f}' for v in us)}"
                                f" us" for name, us in host.items())
          + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
