#!/usr/bin/env python3
"""Time sources of the port's quantized matmul against each other on one
card.

    python3 tools/ab_qmm.py NAME=DIR [NAME=DIR ...]

Each DIR holds a ``qmm.cu`` with the C interface ``fat_qmm`` and the headers
it includes. A DIR may also hold the ``quant.py`` that planned for that
source (its variant, tile and k split): its ``plan`` then replaces the
package's while that source runs. To compare with an earlier revision, copy
its files into a directory that git ignores:

    mkdir -p build/old_qmm && for f in qmm.cu gmm_common.cuh \\
        flash_common.cuh hopper_common.cuh; do
      git show REV:flash_attention_tpu_torch/csrc/$f > build/old_qmm/$f; done
    git show REV:flash_attention_tpu_torch/ops/quant.py > build/old_qmm/quant.py
    python3 tools/ab_qmm.py old=build/old_qmm new=flash_attention_tpu_torch/csrc

Every source is built with the port's flags (its ``-Xptxas -v`` register,
spill and C75xx lines printed). At Llama-3-8B's shapes, int8 and int4, bf16
x: prefill (8 x 2048 rows) and decode (8 rows; its weight cold, the calls
rotating in one CUDA graph over copies larger than the L2 together), each
output is compared with the first source's bit for bit, then each source is
timed with CUDA events in the order a b .. b a. Prints the card's name and
power limit with every line. Imports no JAX.
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
from flash_attention_tpu_torch.ops import quant  # noqa: E402

DIM, KV, FFN, VOCAB = 4096, 1024, 14336, 128256
PROJ = {"wq/wo": (DIM, DIM), "wk/wv": (DIM, KV), "gate/up": (DIM, FFN),
        "down": (FFN, DIM)}
CASES = ([(f"prefill {p}", 8 * 2048, k, n) for p, (k, n) in PROJ.items()]
         + [(f"decode {p}", 8, k, n) for p, (k, n) in PROJ.items()]
         + [("decode lm_head", 8, DIM, VOCAB)])
COLD_BYTES = 100e6  # twice the 50 MB L2


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


def cold_ms(x, weights, calls: int = 20) -> float:
    """Device ms per call, rotating over ``weights`` in one CUDA graph."""
    quant.quantized_matmul(x, weights[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n = max(calls, len(weights))
    with torch.cuda.graph(graph):
        for i in range(n):
            quant.quantized_matmul(x, weights[i % len(weights)])
    return time_ms(graph.replay, 5) / n


def load_plan(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"ab_quant_{path.parent.name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.plan


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_qmm: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    sets = {}  # name -> (kernel, plan)
    for name, path in (arg.split("=", 1) for arg in sys.argv[1:]):
        src = pathlib.Path(path).resolve()
        plan = load_plan(src / "quant.py") if (src / "quant.py").exists() \
            else quant.plan
        sets[name] = (_build.Kernel(f"ab_{name}_qmm", str(src / "qmm.cu"),
                                    quant.KERNEL.argtypes), plan)
    for name, log in _build.build([k for k, _ in sets.values()],
                                  ptxas_verbose=True).items():
        for line in log.splitlines():
            if "Used" in line or "C75" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                print(f"  {name}: {line.strip()}")

    def use(name):
        quant.KERNEL, quant.plan = sets[name]

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    first = next(iter(sets))
    for bits in (8, 4):
        quantize = quant.quantize_int8 if bits == 8 else quant.quantize_int4
        for label, m, k, n in CASES:
            w = quantize(torch.randn((k, n), generator=g, device=dev)
                         * k**-0.5)
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            decode = m <= 16
            copies = [w]
            if decode:
                q_bytes = w.values.numel() + 4 * w.scales.numel()
                copies += [quant.QuantizedTensor(w.values.clone(),
                                                 w.scales.clone(), bits)
                           for _ in range(max(2, -(-int(COLD_BYTES)
                                                   // q_bytes)) - 1)]
            out, times = {}, {name: [] for name in sets}
            for name in sets:
                use(name)
                out[name] = quant.quantized_matmul(x, w)
            same = {name: torch.equal(o, out[first]) for name, o in out.items()}
            for name in list(sets) + list(sets)[::-1]:
                use(name)
                times[name].append(cold_ms(x, copies) if decode else time_ms(
                    lambda: quant.quantized_matmul(x, w), 10))
            row = ", ".join(f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                            for name, ts in times.items())
            print(f"int{bits} {label} ({m}, {k}) @ ({k}, {n})"
                  f"{' L2 cold' if decode else ''}: {row}; bit-identical to "
                  f"{first}'s: {same} [{card}]")
            del w, x, copies, out
    use(first)
    return 0


if __name__ == "__main__":
    sys.exit(main())
