#!/usr/bin/env python3
"""Time sources of the port's grouped matmuls (gmm, gmm_dw) against each
other on one card.

    python3 tools/ab_gmm.py NAME=DIR [NAME=DIR ...]

Each DIR holds a ``gmm.cu`` and a ``gmm_dw.cu`` with the C interfaces
``fat_gmm`` and ``fat_gmm_dw`` and the headers they include. A DIR may also
hold the ``ops/moe.py`` whose wrappers call that interface, as ``moe.py``:
its ``gmm`` and ``gmm_dw`` then run that source (an earlier revision's
interface may differ). To compare with an earlier revision, copy its files
into a directory that git ignores:

    mkdir -p build/old_gmm && for f in gmm.cu gmm_dw.cu gmm_common.cuh \\
        flash_common.cuh hopper_common.cuh; do
      git show REV:flash_attention_tpu_torch/csrc/$f > build/old_gmm/$f; done
    git show REV:flash_attention_tpu_torch/ops/moe.py > build/old_gmm/moe.py
    python3 tools/ab_gmm.py old=build/old_gmm new=flash_attention_tpu_torch/csrc

Every source is built with the port's flags (its ``-Xptxas -v`` register,
spill and C75xx lines printed). At Mixtral-8x7B's widths (dim 4096, FFN
14336, 8 experts, top-2 routing drawn from a seed through the port's
``dispatch``), bf16: gmm at prefill (8 x 2048 tokens), training (2 x 2048),
dx through the strided view w^T, and decode (8 tokens, device time in a
CUDA graph of 20 calls), gate/up and down; gmm_dw at training, gate/up and
down. Each output is compared with the first source's bit for bit, then
each source is timed with CUDA events in the order a b .. b a. Prints the
card's name and power limit with every line. Imports no JAX.
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
from flash_attention_tpu_torch.ops import moe  # noqa: E402

DIM, FFN, EXPERTS, TOP = 4096, 14336, 8, 2
PREFILL, TRAIN, DECODE = 8 * 2048, 2 * 2048, 8


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


def graph_ms(fn, calls: int = 20) -> float:
    """Device ms per call of ``calls`` calls captured in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, 5) / calls


def load_moe(path: pathlib.Path, name: str):
    """A private copy of a moe module, so each source keeps its kernels."""
    spec = importlib.util.spec_from_file_location(f"ab_moe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_gmm: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    mods = {}
    for name, path in (arg.split("=", 1) for arg in sys.argv[1:]):
        src = pathlib.Path(path).resolve()
        mod = load_moe(src / "moe.py" if (src / "moe.py").exists()
                       else pathlib.Path(moe.__file__), name)
        mod.KERNEL = _build.Kernel(f"ab_{name}_gmm", str(src / "gmm.cu"),
                                   mod.KERNEL.argtypes)
        mod.DW_KERNEL = _build.Kernel(f"ab_{name}_gmm_dw",
                                      str(src / "gmm_dw.cu"),
                                      mod.DW_KERNEL.argtypes)
        mods[name] = mod
    kernels = [k for m in mods.values() for k in (m.KERNEL, m.DW_KERNEL)]
    for name, log in _build.build(kernels, ptxas_verbose=True).items():
        for line in log.splitlines():
            if "Used" in line or "C75" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    def layout(tokens):
        scores = torch.rand((tokens, EXPERTS), generator=g, device=dev)
        _, _, be, n_pad = moe.dispatch(scores.topk(TOP, dim=-1).indices,
                                       EXPERTS)
        return be, n_pad

    w_up = rnd(EXPERTS, DIM, FFN, scale=0.5 * DIM**-0.5)
    w_down = rnd(EXPERTS, FFN, DIM, scale=0.5 * FFN**-0.5)
    cases = []  # (label, fn name, tokens, k, w or the width of dy)
    for label, t in (("prefill", PREFILL), ("train", TRAIN),
                     ("decode", DECODE)):
        cases += [(f"gmm {label} gate/up", "gmm", t, DIM, w_up),
                  (f"gmm {label} down", "gmm", t, FFN, w_down)]
    cases += [("gmm train dx gate/up (w^T by strides)", "gmm", TRAIN, FFN,
               w_up.transpose(1, 2)),
              ("gmm train dx down (w^T by strides)", "gmm", TRAIN, DIM,
               w_down.transpose(1, 2)),
              ("gmm_dw train gate/up", "gmm_dw", TRAIN, DIM, FFN),
              ("gmm_dw train down", "gmm_dw", TRAIN, FFN, DIM)]
    first = next(iter(mods))
    for label, fn, t, k, w in cases:
        be, n_pad = layout(t)
        x = rnd(n_pad, k)
        if fn == "gmm":
            def call(mod, x=x, w=w, be=be):
                return mod.gmm(x, w, be)
        else:
            dy = rnd(n_pad, w, scale=0.5 * (t * TOP // EXPERTS)**-0.5)

            def call(mod, x=x, dy=dy, be=be):
                return mod.gmm_dw(x, dy, be, EXPERTS)
        out = {name: call(mod) for name, mod in mods.items()}
        same = {name: torch.equal(o, out[first]) for name, o in out.items()}
        del out
        decode = t == DECODE
        times = {name: [] for name in mods}
        for name in list(mods) + list(mods)[::-1]:
            fn_ = (lambda mod=mods[name]: call(mod))
            times[name].append(graph_ms(fn_) if decode else time_ms(fn_, 10))
        row = ", ".join(f"{name} {' / '.join(f'{v:.4f}' for v in ts)} ms"
                        for name, ts in times.items())
        print(f"{label}: x ({n_pad}, {k}){' [CUDA graph]' if decode else ''}"
              f": {row}; bit-identical to {first}'s: {same} [{card}]")
        del x, be
    return 0


if __name__ == "__main__":
    sys.exit(main())
