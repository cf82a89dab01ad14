#!/usr/bin/env python3
"""Where the d-384/512 dQ pair's time goes, by phase, from clock64 counters.

    python3 tools/probe_dq_pair.py

Writes a copy of ``flash_attention_tpu_torch/csrc/flash_bwd_dq_pair.cu``
with clock64 counters added (under the ignored ``build/probe_dq_pair/``;
every anchor it patches must be found once, or the tool stops), builds it
with the port's flags and runs it at h64/1 bf16 causal, d 512: the training
shape b2 s2048 and b1 s4096. For each it prints the kernel's time and,
averaged over each role's CTAs (the S-CTA, rank 0, and the dP-CTA, rank 1)
and over their tiles, the cycles a tile of the score warpgroup (all of it;
waiting for the stage; its chain, the wait included; the dP-CTA waiting for
the peer's buffer; the S-CTA waiting for its own dQ warpgroup's hand-off
buffer), of the dQ warpgroup (all of it; waiting for P or dS; the S-CTA
waiting for dP and for the peer's buffer; waiting for the stage; its
product) and of the producer waiting for a free stage, each as thread 0 of
its warpgroup sees it. The counters cost a few registers and instructions:
the time printed is the instrumented kernel's. Prints the card's name and
power limit. Imports no JAX.
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
from flash_attention_tpu_torch.ops import _build  # noqa: E402
from flash_attention_tpu_torch.ops import flash_bwd as fb  # noqa: E402
from flash_attention_tpu_torch.ops import flash_fwd as fm  # noqa: E402

OUT = REPO / "build" / "probe_dq_pair"
MAX_CTAS = 16384
N = 13
SCORE = ("score warpgroup", "waiting for the stage", "its chain",
         "waiting for the peer's buffer", "waiting for the hand-off buffer")
DQ = ("dQ warpgroup", "waiting for P (S-CTA) or dS (dP-CTA)",
      "waiting for dP", "waiting for the peer's buffer",
      "waiting for the stage", "its product")


def tick(arr: str, i: int, body: str) -> str:
    """``body`` timed into counter i of ``arr`` (pf: the score warpgroup's,
    pq: the dQ warpgroup's)."""
    return (f"{{ const long long t_ = clock64(); {body} "
            f"{arr}[{i}] += clock64() - t_; }}")


PROF = ("g_prof[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
        "blockIdx.x]")
PATCHES = [  # (anchor, replacement); the anchor must occur exactly once
    ("namespace {\n",
     f"__device__ long long g_prof[{MAX_CTAS}][{N}];\n\nnamespace {{\n"),
    ("  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);\n",
     "  long long pe = 0;\n"
     "  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);\n"),
    ("        if (j >= STAGES) hop::mbar_wait(&empty[s], (j / STAGES - 1) & 1);\n"
     "        if (rank == 0) {\n",
     "        if (j >= STAGES) { const long long t_ = clock64(); "
     "hop::mbar_wait(&empty[s], (j / STAGES - 1) & 1); pe += clock64() - t_; }\n"
     "        if (rank == 0) {\n"),
    ("    hop::setmaxnreg_inc<CONSUMER_REGS>();\n    const int w0",
     "    hop::setmaxnreg_inc<CONSUMER_REGS>();\n    long long pf[5] = {};\n"
     "    const int w0"),
    ("      hop::mbar_arrive_remote(hop::mapa(hop::smem_u32(t_free), rank ^ 1));\n"
     "    }\n",
     "      hop::mbar_arrive_remote(hop::mapa(hop::smem_u32(t_free), rank ^ 1));\n"
     "    }\n    const long long t_score = clock64();\n"),
    ("        hop::mbar_wait(&full[s], (j / STAGES) & 1);\n"
     "        const uint32_t st = base + L::stage(s);\n",
     "        " + tick("pf", 1, "hop::mbar_wait(&full[s], (j / STAGES) & 1);")
     + "\n        const uint32_t st = base + L::stage(s);\n"),
    ("        scores(sc, j);\n        hop::wgmma_wait<0>();\n",
     "        " + tick("pf", 2, "scores(sc, j); hop::wgmma_wait<0>();") + "\n"),
    ("        if (j >= NB_X) hop::named_sync(BAR_FREE + xb, 256);\n",
     "        if (j >= NB_X) "
     + tick("pf", 4, "hop::named_sync(BAR_FREE + xb, 256);") + "\n"),
    ("        hop::mbar_wait(&full[s], (j / STAGES) & 1);\n"
     "        const uint32_t v = base",
     "        " + tick("pf", 1, "hop::mbar_wait(&full[s], (j / STAGES) & 1);")
     + "\n        const uint32_t v = base"),
    ("        dpc(sc, j);\n        hop::wgmma_wait<0>();\n",
     "        " + tick("pf", 2, "dpc(sc, j); hop::wgmma_wait<0>();") + "\n"),
    ("        if (j >= NB_X) hop::mbar_wait(&xfree[xb], ((j >> 1) - 1) & 1);\n"
     "        send_words(x_peer + xb * L::XP_BYTES",
     "        if (j >= NB_X) "
     + tick("pf", 3, "hop::mbar_wait(&xfree[xb], ((j >> 1) - 1) & 1);")
     + "\n        send_words(x_peer + xb * L::XP_BYTES"),
    ("  } else {\n    // ---- the dQ warpgroup",
     f"    if (tid == 0) {{\n      long long* p = {PROF};\n"
     "      p[0] = n_tiles;\n      p[1] = clock64() - t_score;\n"
     "      for (int i = 1; i < 5; ++i) p[1 + i] = pf[i];\n    }\n"
     "  } else {\n    // ---- the dQ warpgroup"),
    ("    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;\n",
     "    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;\n"
     "    long long pq[6] = {};\n    const long long t_dq = clock64();\n"),
    ("        hop::named_sync(BAR_READY + xb, 256);\n"
     "        hop::mbar_wait(&xfull[xb], (j >> 1) & 1);\n",
     "        " + tick("pq", 1, "hop::named_sync(BAR_READY + xb, 256);") + "\n"
     "        " + tick("pq", 2, "hop::mbar_wait(&xfull[xb], (j >> 1) & 1);")
     + "\n"),
    ("        if (j >= NB_X) hop::mbar_wait(&xfree[xb], ((j >> 1) - 1) & 1);\n"
     "        send_words(x_peer + xb * L::XD_BYTES",
     "        if (j >= NB_X) "
     + tick("pq", 3, "hop::mbar_wait(&xfree[xb], ((j >> 1) - 1) & 1);")
     + "\n        send_words(x_peer + xb * L::XD_BYTES"),
    ("        hop::mbar_wait(&xfull[xb], (j >> 1) & 1);\n        load_words(fa,",
     "        " + tick("pq", 1, "hop::mbar_wait(&xfull[xb], (j >> 1) & 1);")
     + "\n        load_words(fa,"),
    ("      hop::mbar_wait(&full[s], (j / STAGES) & 1);\n      // this CTA's",
     "      " + tick("pq", 4, "hop::mbar_wait(&full[s], (j / STAGES) & 1);")
     + "\n      // this CTA's"),
    ("      hop::wgmma_commit();\n      hop::wgmma_wait<0>();\n"
     "      hop::fence_regs(acc);\n      hop::fence_regs(fa);\n",
     "      " + tick("pq", 5, "hop::wgmma_commit(); hop::wgmma_wait<0>();")
     + "\n      hop::fence_regs(acc);\n      hop::fence_regs(fa);\n"),
    ("    hop::mbar_wait(t_full, 0);\n#pragma unroll\n    for (int nt = 0;",
     f"    if (tid == 0) {{\n      long long* p = {PROF};\n"
     "      p[6] = clock64() - t_dq;\n"
     "      for (int i = 1; i < 6; ++i) p[6 + i] = pq[i];\n    }\n"
     "    hop::mbar_wait(t_full, 0);\n#pragma unroll\n    for (int nt = 0;"),
    ("  // neither CTA exits while the other may still store or arrive into it\n"
     "  hop::cluster_sync();\n}",
     f"  if (threadIdx.x == 0) {PROF}[12] = pe;\n"
     "  // neither CTA exits while the other may still store or arrive into it\n"
     "  hop::cluster_sync();\n}"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int fat_probe_read(void* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, "
     "sizeof(g_prof)));\n}\n"
     "int fat_probe_clear() {\n"
     f"  static long long z[{MAX_CTAS}][{N}];\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));\n"
     "}\n"),
]


def instrumented_source() -> pathlib.Path:
    src = (_build.CSRC / "flash_bwd_dq_pair.cu").read_text()
    for anchor, replacement in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"probe_dq_pair: anchor found {src.count(anchor)}"
                             f" times in flash_bwd_dq_pair.cu:\n{anchor}")
        src = src.replace(anchor, replacement)
    OUT.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    (OUT / "flash_bwd_dq_pair.cu").write_text(src)
    return OUT / "flash_bwd_dq_pair.cu"


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dq_pair: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    argtypes = dict(fb.DQ_KERNEL.argtypes)
    argtypes.update(fat_probe_read=[ctypes.c_void_p], fat_probe_clear=[])
    fb.DQ_KERNEL = _build.Kernel(
        "flash_bwd_dq", (str(_build.CSRC / "flash_bwd_dq.cu"),
                         str(_build.CSRC / "flash_bwd_dq_wide.cu"),
                         str(instrumented_source())), argtypes)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    h, d = 64, 512
    for b, s in ((2, 2048), (1, 4096)):
        q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for shape in ((b, s, h, d), (b, s, 1, d), (b, s, 1, d),
                                     (b, s, h, d)))
        kw = dict(causal=True, sm_scale=d**-0.5)
        o, lse = fm.flash_fwd(q, k, v, **kw)
        di = fb.flash_bwd_di(o, do)
        fb.flash_bwd_dq(q, k, v, do, lse, di, **kw)  # build, load, warm up
        torch.cuda.synchronize()
        lib = fb.DQ_KERNEL.lib()
        lib.fat_probe_clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fb.flash_bwd_dq(q, k, v, do, lse, di, **kw)
        end.record()
        torch.cuda.synchronize()
        prof = np.zeros((MAX_CTAS, N), np.int64)
        lib.fat_probe_read(prof.ctypes.data)
        ctas = 2 * h * b * (s // 64)
        rows = prof[:ctas].astype(np.float64)
        print(f"dq b{b} s{s} h{h}/1 d{d} causal: "
              f"{start.elapsed_time(end):.4f} ms (instrumented) [{card}]")
        for rank, what in ((0, "S-CTA"), (1, "dP-CTA")):
            r = rows[rank::2]
            tiles = r[:, 0].sum()
            score = ", ".join(f"{name} {r[:, 1 + i].sum() / tiles:.0f}"
                              for i, name in enumerate(SCORE))
            dq = ", ".join(f"{name} {r[:, 6 + i].sum() / tiles:.0f}"
                           for i, name in enumerate(DQ))
            print(f"  {what}, cycles a tile ({tiles:.0f} tiles): {score}; "
                  f"{dq}; producer waiting for a free stage "
                  f"{r[:, 12].sum() / tiles:.0f}")
        del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
