#!/usr/bin/env python3
"""Cycles of the wide attention kernels' wgmma chains on the card.

    python3 tools/probe_wgmma.py

Builds ``tools/probe_wgmma.cu`` with the port's flags (headers from the
package's ``csrc/``) and runs, on every SM at once (one CTA each) and on
one, each chain of k16 steps over d 512: one m64n32k16 chain (the wide dq
and dK/dV kernels' score chains), two such chains interleaved in one
warpgroup, one m64n64k16 chain (the wide forward's S), one m64n32k16 chain
with A in registers, and four m64n256k16 (a P V or dS K half), each in one
warpgroup alone and in each of two warpgroups at once. Prints the SM
cycles an instruction takes in each (clock64 over 200 reps, the slowest
CTA), beside the tensor cores' dense rate (1024 bf16 FLOP a clock a
tensor core, four an SM), with the card's name and power limit. Imports
no JAX.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from flash_attention_tpu_torch.ops import _build  # noqa: E402

# variant: (what, instructions a rep, FLOP an instruction)
VARIANTS = {0: ("m64n32k16 chain, both operands in shared memory", 32,
                2 * 64 * 32 * 16),
            1: ("two m64n32k16 chains interleaved", 64, 2 * 64 * 32 * 16),
            2: ("m64n64k16 chain, both operands in shared memory", 32,
                2 * 64 * 64 * 16),
            3: ("m64n32k16 chain, A in registers", 32, 2 * 64 * 32 * 16),
            4: ("m64n256k16 x 4, B MN-major", 4, 2 * 64 * 256 * 16)}
REPS = 200
PEAK_FLOP_A_CLOCK = 4096  # dense bf16, an SM


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_wgmma: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    lib_path = _build.BUILD_DIR / "probe_wgmma.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
         f"-I{_build.CSRC}", "-o", str(lib_path),
         str(REPO / "tools" / "probe_wgmma.cu")],
        capture_output=True, text=True)
    if log.returncode:
        print(log.stdout + log.stderr, file=sys.stderr)
        return 1
    for line in log.stderr.splitlines():
        if "spill" in line and " 0 bytes spill" not in line or "C75" in line:
            print(f"  {line.strip()}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.fat_probe_wgmma
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for v, (what, n_ins, flop) in VARIANTS.items():
        for wgs in (1, 2):
            for ctas in (1, sms):
                out = torch.zeros(ctas * 2, dtype=torch.int64, device="cuda")
                fn(v, wgs, ctas, 1, out.data_ptr(), stream)  # warm-up
                assert fn(v, wgs, ctas, REPS, out.data_ptr(), stream) == 0
                torch.cuda.synchronize()
                cyc = out.view(ctas, 2)[:, :wgs].max().item() / REPS
                per = cyc / n_ins
                # both warpgroups' products share the SM's tensor cores
                peak = wgs * n_ins * flop / PEAK_FLOP_A_CLOCK
                print(f"{what}: {wgs} warpgroup(s) a CTA, {ctas} CTA(s): "
                      f"{cyc:.0f} cycles a rep, {per:.1f} an instruction; "
                      f"the tensor cores' rate needs {peak:.0f} "
                      f"({peak / cyc:.0%}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
