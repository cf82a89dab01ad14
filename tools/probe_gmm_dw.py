#!/usr/bin/env python3
"""Where gmm_dw's time goes, by phase, from clock64 counters on one card.

    python3 tools/probe_gmm_dw.py

Writes a copy of ``flash_attention_tpu_torch/csrc/gmm_dw.cu`` with clock64
counters added (under the ignored ``build/probe_gmm_dw/``; every anchor it
patches must be found once, or the tool stops), builds it with the port's
flags and runs it at Mixtral-8x7B's training shapes (top-2 routing of
2 x 2048 tokens over 8 experts from a seed, bf16). For each shape it prints
the kernel's time and, averaged over the CTAs, the cycles of the whole CTA,
of the consumers' mainloop, of their waits for a stage's data inside it,
of their epilogue and of tiles of experts with no rows (consumer 0's
thread 0), and of the producer's waits for a free stage. The counters cost
a few registers and instructions: the time printed is the instrumented
kernel's. Prints the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from flash_attention_tpu_torch.ops import _build, moe  # noqa: E402

OUT = REPO / "build" / "probe_gmm_dw"
MAX_CTAS = 1024
PHASES = ("CTA", "mainloop", "waiting for data", "epilogue", "empty experts",
          "producer waiting for a free stage")
PATCHES = [  # (anchor, replacement); the anchor must occur exactly once
    ("namespace {\n",
     f"__device__ unsigned long long g_prof[{MAX_CTAS}][6];\n\nnamespace {{\n"),
    ("            if (it >= STAGES) hop::mbar_wait(&empty[st], (it / STAGES - 1) & 1);\n",
     "            if (it >= STAGES) {\n"
     "              const long long t0 = clock64();\n"
     "              hop::mbar_wait(&empty[st], (it / STAGES - 1) & 1);\n"
     "              g_prof[blockIdx.x][5] += clock64() - t0;\n"
     "            }\n"),
    ("  int it = 0;\n  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n"
     "    const int e = tile / per_expert;\n",
     "  int it = 0;\n  const long long t_start = clock64();\n"
     "  long long t_main = 0, t_full = 0, t_epi = 0, t_zero = 0;\n"
     "  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n"
     "    const long long t_a = clock64();\n"
     "    const int e = tile / per_expert;\n"),
    ("      continue;\n    }\n#pragma unroll\n",
     "      t_zero += clock64() - t_a;\n      continue;\n    }\n#pragma unroll\n"),
    ("      hop::mbar_wait(&full[st], (it / STAGES) & 1);\n",
     "      const long long t_f = clock64();\n"
     "      hop::mbar_wait(&full[st], (it / STAGES) & 1);\n"
     "      t_full += clock64() - t_f;\n"),
    ("    if (k_row0 < K) {",
     "    const long long t_b = clock64();\n    t_main += t_b - t_a;\n"
     "    if (k_row0 < K) {"),
    ("  }\n  if (tid == 0) hop::tma_store_wait_read<0>();",
     "    t_epi += clock64() - t_b;\n  }\n"
     "  if (tid == 0 && c == 0) {\n"
     "    unsigned long long* p = g_prof[blockIdx.x];\n"
     "    p[0] = clock64() - t_start;\n    p[1] = t_main;\n    p[2] = t_full;\n"
     "    p[3] = t_epi;\n    p[4] = t_zero;\n  }\n"
     "  if (tid == 0) hop::tma_store_wait_read<0>();"),
    ("int fat_gmm_dw_max_experts() { return MAX_EXPERTS; }\n",
     "int fat_gmm_dw_max_experts() { return MAX_EXPERTS; }\n"
     "int fat_probe_read(void* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));\n"
     "}\n"
     "int fat_probe_clear() {\n"
     f"  static unsigned long long z[{MAX_CTAS}][6];\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));\n"
     "}\n"),
]


def instrumented_source() -> pathlib.Path:
    src = (_build.CSRC / "gmm_dw.cu").read_text()
    for anchor, replacement in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"probe_gmm_dw: anchor found {src.count(anchor)} "
                             f"times in gmm_dw.cu:\n{anchor}")
        src = src.replace(anchor, replacement)
    OUT.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    (OUT / "gmm_dw.cu").write_text(src)
    return OUT / "gmm_dw.cu"


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gmm_dw: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    argtypes = dict(moe.DW_KERNEL.argtypes)
    argtypes.update(fat_probe_read=[ctypes.c_void_p], fat_probe_clear=[])
    moe.DW_KERNEL = _build.Kernel("probe_gmm_dw", str(instrumented_source()),
                                  argtypes)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scores = torch.rand((2 * 2048, 8), generator=g, device=dev)
    _, _, be, n_pad = moe.dispatch(scores.topk(2, dim=-1).indices, 8)
    for label, k, n in (("gate/up", 4096, 14336), ("down", 14336, 4096)):
        x = torch.randn((n_pad, k), generator=g, device=dev).to(torch.bfloat16)
        dy = (torch.randn((n_pad, n), generator=g, device=dev)
              * 0.03).to(torch.bfloat16)
        moe.gmm_dw(x, dy, be, 8)  # build, load, warm up
        torch.cuda.synchronize()
        lib = moe.DW_KERNEL.lib()
        lib.fat_probe_clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        moe.gmm_dw(x, dy, be, 8)
        end.record()
        torch.cuda.synchronize()
        prof = np.zeros((MAX_CTAS, 6), np.uint64)
        lib.fat_probe_read(prof.ctypes.data)
        ctas = prof[prof[:, 0] > 0].astype(np.float64)
        mean = ctas.mean(0)
        parts = ", ".join(f"{name} {v:.0f}" for name, v in zip(PHASES, mean))
        print(f"gmm_dw train {label}: x ({n_pad}, {k}), dy ({n_pad}, {n}), "
              f"{len(ctas)} CTAs: {start.elapsed_time(end):.4f} ms; mean "
              f"cycles a CTA: {parts} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
