#!/usr/bin/env python3
"""Time sets of the port's backward kernels against each other on one card.

    python3 tools/ab_flash_bwd.py [--wide] NAME=DIR [NAME=DIR ...]

Each DIR holds the backward's sources (``flash_bwd_di.cu``,
``flash_bwd_dq.cu``, ``flash_bwd_dq_wide.cu``, ``flash_bwd_dkv.cu``,
``flash_bwd_dkv_wide.cu``) with the C interfaces of those in
``flash_attention_tpu_torch/csrc/`` and the headers they include; a DIR
that lacks one takes the package's. A DIR may also hold the
``ops/flash_bwd.py`` whose wrappers call those interfaces, as
``flash_bwd.py``: its ``flash_bwd`` then runs that set (an earlier
revision's interfaces may differ). To compare with an earlier revision,
copy its sources into a directory that git ignores:

    mkdir -p build/old && for f in flash_bwd_di.cu flash_bwd_dq.cu \\
        flash_bwd_dq_wide.cu flash_bwd_dkv.cu flash_bwd_dkv_wide.cu \\
        flash_bwd_dq_common.cuh flash_bwd_dkv_common.cuh \\
        flash_common.cuh hopper_common.cuh; do
      git show REV:flash_attention_tpu_torch/csrc/$f > build/old/$f; done
    git show REV:flash_attention_tpu_torch/ops/flash_bwd.py \\
        > build/old/flash_bwd.py
    python3 tools/ab_flash_bwd.py old=build/old \\
        new=flash_attention_tpu_torch/csrc

``--wide`` runs only the d-384/512 cells instead: the dQ and dK/dV
kernels at h64/1 bf16 (DeepSeek-V4-Flash's attention geometry), d 512
then 384, at the training shape b2 s2048 causal, b1 s4096 causal and its
window (127, 0), b1 s2048 non-causal and softcap 5, each set held to the
plain versions (``dq_reference`` and ``dkv_reference``, blocked a GQA
group and 512 query rows at a time) at the bf16 backward gates with atol
no tighter than one ulp of the output's largest magnitude (two revisions
may sum in different orders, so not bit for bit; whether dq is
bit-identical to the first set's is printed), two runs bit-identical,
then each kernel timed in turns a b .. b a.

Every set is built with the port's flags (its ``-Xptxas -v`` register,
spill and C75xx lines printed), and its dq, dk and dv are compared with the
first set's bit for bit at b2 s2048 h32/8 d64 and d128 bf16, causal and
not; then
each kernel is timed with CUDA events in the order a b .. b a. Sets whose
wrappers take ``segs`` also run the segmented dq and dkv on 8 packed
sequences of 2048 (one row of 16384 tokens, causal), checked and timed the
same way against the other such sets. Prints the card's name and power
limit with every line. Imports no JAX.
"""

from __future__ import annotations

import importlib.util
import inspect
import math
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from flash_attention_tpu_torch.ops import _build  # noqa: E402
from flash_attention_tpu_torch.ops import flash_bwd as fb  # noqa: E402
from flash_attention_tpu_torch.ops import flash_fwd as fm  # noqa: E402

B, S, H, HK = 2, 2048, 32, 8
SEG_BATCH = 8  # packed sequences of S tokens in the segmented cell
DIMS = (64, 128)  # the head dims whose instances are compared
PARTS = {"di": "DI_KERNEL", "dq": "DQ_KERNEL", "dkv": "DKV_KERNEL"}
# --wide: (label, b, s, causal, window, softcap) of the cells at h64/1,
# and the gates
WIDE_H, WIDE_HK = 64, 1
WIDE_CELLS = (("training shape b2 s2048 causal", 2, 2048, True, None, None),
              ("b1 s4096 causal", 1, 4096, True, None, None),
              ("b1 s4096 window (127, 0)", 1, 4096, True, (127, 0), None),
              ("b1 s2048 non-causal", 1, 2048, False, None, None),
              ("b1 s2048 softcap 5 causal", 1, 2048, True, None, 5.0))
WIDE_DIMS = (512, 384)
BWD_BF16_TOLS = {"atol": 4e-2, "mean_atol": 2e-3, "mean_rtol": 2e-1}


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
    """A private copy of a backward wrapper module, so each set keeps its
    kernels and their interfaces."""
    spec = importlib.util.spec_from_file_location(f"ab_bwd_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_flash_bwd: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    args = sys.argv[1:]
    wide = "--wide" in args
    sets = {}
    for name, path in (a.split("=", 1) for a in args if a != "--wide"):
        src = pathlib.Path(path).resolve()
        wrapper = src / "flash_bwd.py"
        mod = load_wrapper(wrapper if wrapper.exists()
                           else pathlib.Path(fb.__file__), name)
        for attr in PARTS.values():
            pkg = getattr(mod, attr)
            own = tuple(str(src / p.name if (src / p.name).exists() else p)
                        for p in pkg.sources)
            # the package's kernel name (the wrappers derive their C entry
            # points from it), each set's libraries under names of its own
            kern = _build.Kernel(pkg.name, own, pkg.argtypes)
            paths = [p.with_name(f"ab_{name}_{p.name}")
                     for p in kern.lib_paths()]
            kern.lib_paths = lambda paths=paths: paths
            setattr(mod, attr, kern)
        sets[name] = mod
    built = [getattr(m, a) for m in sets.values() for a in PARTS.values()]
    for name, log in _build.build(built, ptxas_verbose=True).items():
        for line in log.splitlines():
            if "Used" in line or "C75" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                print(f"  {name}: {line.strip()}")


    dev = torch.device("cuda")
    if wide:
        return run_wide(sets, dev, card)
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    first = next(iter(sets))
    for d in DIMS:
        q, k, v, do = rnd(B, S, H, d), rnd(B, S, HK, d), rnd(B, S, HK, d), \
            rnd(B, S, H, d)
        for causal in (True, False):
            kw = dict(causal=causal, sm_scale=d**-0.5)
            o, lse = fm.flash_fwd(q, k, v, **kw)
            out = {}
            for name, mod in sets.items():
                out[name] = mod.flash_bwd(q, k, v, o, lse, do, **kw)
                same = all(torch.equal(a, b) for a, b in zip(out[name],
                                                              out[first]))
                print(f"{name} d{d} causal={causal}: dq, dk, dv "
                      f"bit-identical to {first}'s: {same}")
            times = {n: {p: [] for p in PARTS} for n in sets}
            for name in list(sets) + list(sets)[::-1]:
                mod = sets[name]
                di = mod.flash_bwd_di(o, do)
                times[name]["di"].append(time_ms(
                    lambda: mod.flash_bwd_di(o, do)))
                times[name]["dq"].append(time_ms(
                    lambda: mod.flash_bwd_dq(q, k, v, do, lse, di, **kw)))
                times[name]["dkv"].append(time_ms(
                    lambda: mod.flash_bwd_dkv(q, k, v, do, lse, di, **kw)))
            for part in PARTS:
                row = ", ".join(
                    f"{n} {' / '.join(f'{t:.4f}' for t in r[part])} ms"
                    for n, r in times.items())
                print(f"{part} b{B} s{S} h{H}/{HK} d{d} causal={causal}: "
                      f"{row} [{card}]")
        seg_sets = [n for n, m in sets.items()
                    if "segs" in inspect.signature(m.flash_bwd).parameters]
        if not seg_sets:
            continue
        n_tok = SEG_BATCH * S
        seg = (torch.arange(n_tok, device=dev, dtype=torch.int32) // S)[None]
        pos = (torch.arange(n_tok, device=dev, dtype=torch.int32) % S)[None]
        segs = (seg, seg, pos, pos)
        q, k, v, do = rnd(1, n_tok, H, d), rnd(1, n_tok, HK, d), \
            rnd(1, n_tok, HK, d), rnd(1, n_tok, H, d)
        kw = dict(causal=True, sm_scale=d**-0.5, segs=segs)
        o, lse = fm.flash_fwd(q, k, v, **kw)
        ref = sets[seg_sets[0]].flash_bwd(q, k, v, o, lse, do, **kw)
        times = {n: {p: [] for p in ("dq", "dkv")} for n in seg_sets}
        for name in seg_sets:
            same = all(torch.equal(a, b) for a, b in zip(
                sets[name].flash_bwd(q, k, v, o, lse, do, **kw), ref))
            print(f"{name} segmented {SEG_BATCH} x {S} packed d{d}: dq, dk, "
                  f"dv bit-identical to {seg_sets[0]}'s: {same}")
        for name in seg_sets + seg_sets[::-1]:
            mod = sets[name]
            di = mod.flash_bwd_di(o, do)
            times[name]["dq"].append(time_ms(
                lambda: mod.flash_bwd_dq(q, k, v, do, lse, di, **kw)))
            times[name]["dkv"].append(time_ms(
                lambda: mod.flash_bwd_dkv(q, k, v, do, lse, di, **kw)))
        for part in ("dq", "dkv"):
            row = ", ".join(f"{n} {' / '.join(f'{t:.4f}' for t in r[part])} ms"
                            for n, r in times.items())
            print(f"{part} segmented {SEG_BATCH} x {S} packed causal "
                  f"h{H}/{HK} d{d}: {row} [{card}]")
    return 0


def run_wide(sets, dev, card) -> int:
    """The --wide cells: each set's dq, dk and dv against the plain
    versions, then the dQ and dK/dV kernels timed in turns."""
    from flash_attention_tpu_torch.utils.metrics import assert_metrics

    def ulp_tols(ref):
        top = float(ref.abs().max())
        ulp = torch.finfo(ref.dtype).eps * 2.0 ** math.floor(
            math.log2(top)) if top else 0.0
        return {**BWD_BF16_TOLS, "atol": max(BWD_BF16_TOLS["atol"], ulp)}

    g = torch.Generator(device=dev).manual_seed(1)
    first = next(iter(sets))
    for d in WIDE_DIMS:
        for label, b, s, causal, window, cap in WIDE_CELLS:
            q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                           .to(torch.bfloat16)
                           for shape in ((b, s, WIDE_H, d),
                                         (b, s, WIDE_HK, d),
                                         (b, s, WIDE_HK, d),
                                         (b, s, WIDE_H, d)))
            kw = dict(causal=causal, sm_scale=d**-0.5, window=window,
                      softcap=cap)
            o, lse = fm.flash_fwd(q, k, v, **kw)
            di = fb.flash_bwd_di(o, do)
            zero = torch.zeros((b, s), dtype=torch.int32, device=dev)
            pos = torch.arange(s, dtype=torch.int32,
                               device=dev).expand(b, s).contiguous()
            segs = (zero, zero, pos, pos)
            di_r = fb.di_reference(o, do)
            refs = (fb.dq_reference(q, k, v, do, lse, di_r, segs=segs, **kw),
                    *fb.dkv_reference(q, k, v, do, lse, di_r, segs=segs,
                                      **kw))
            cell = f"b{b} s{s} h{WIDE_H}/{WIDE_HK} d{d} {label}"
            dq_first = None
            for name, mod in sets.items():
                got = (mod.flash_bwd_dq(q, k, v, do, lse, di, **kw),
                       *mod.flash_bwd_dkv(q, k, v, do, lse, di, **kw))
                again = (mod.flash_bwd_dq(q, k, v, do, lse, di, **kw),
                         *mod.flash_bwd_dkv(q, k, v, do, lse, di, **kw))
                dq_first = got[0] if dq_first is None else dq_first
                for part, x, ref in zip(("dq", "dk", "dv"), got, refs):
                    m = assert_metrics(f"{name} {cell} {part}", x, ref,
                                       ulp_tols(ref))
                    print(f"{name} {cell} {part}: {m}")
                print(f"{name} {cell}: two runs bit-identical: "
                      f"{all(torch.equal(a, c) for a, c in zip(got, again))};"
                      f" dq bit-identical to {first}'s: "
                      f"{torch.equal(got[0], dq_first)}")
            del refs, di_r
            times = {n: {"dq": [], "dkv": []} for n in sets}
            for name in list(sets) + list(sets)[::-1]:
                mod = sets[name]
                times[name]["dq"].append(time_ms(
                    lambda: mod.flash_bwd_dq(q, k, v, do, lse, di, **kw), 5))
                times[name]["dkv"].append(time_ms(
                    lambda: mod.flash_bwd_dkv(q, k, v, do, lse, di, **kw), 5))
            for part in ("dq", "dkv"):
                row = ", ".join(
                    f"{n} {' / '.join(f'{t:.4f}' for t in r[part])} ms"
                    for n, r in times.items())
                print(f"{part} {cell}: {row} [{card}]", flush=True)
            del q, k, v, do, o, lse, di
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
