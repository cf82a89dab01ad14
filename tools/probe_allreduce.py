#!/usr/bin/env python3
"""The tensor-parallel all-reduce's cost: two ranks on one card.

    python3 tools/probe_allreduce.py

Spawns two ranks (``parallel.mesh.spawn``: a gloo process group), both on
card 0, lays ``make_mesh(model=2)`` over them and times
``parallel.mesh.psum`` (the CUDA tensor staged through a pinned host
buffer, gloo's all-reduce on the host) at Llama-3-8B's decode shape (8,
4096) and its serving prefill's (8, 2048, 4096), bf16, after checking the
sum. Prints each rank's mean ms a call, and the card's name and power
limit. Imports no JAX.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from flash_attention_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SHAPES = {(8, 4096): 64, (8, 2048, 4096): 8}  # shape -> timed calls


def _rank(rank, world):
    torch.cuda.set_device(0)
    mesh = pmesh.make_mesh(model=world)
    out = {}
    for shape, calls in SHAPES.items():
        x = torch.full(shape, 1.0 + rank, dtype=torch.bfloat16, device="cuda")
        y = pmesh.psum(x, mesh, "model")
        torch.cuda.synchronize()
        assert bool((y == sum(1.0 + r for r in range(world))).all())
        t0 = time.perf_counter()
        for _ in range(calls):
            pmesh.psum(x, mesh, "model")
        torch.cuda.synchronize()
        out[shape] = (time.perf_counter() - t0) / calls * 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_allreduce: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for rank, res in enumerate(pmesh.spawn(_rank, 2)):
        for shape, ms in res.items():
            print(f"rank {rank}: psum of {shape} bf16 {ms:.3f} ms a call "
                  f"(two ranks on one card, gloo, staged through host "
                  f"memory) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
