#!/usr/bin/env python3
"""Compare the SASS of two revisions of a kernel source, function by function.

    python3 tools/sass_diff.py NAME OLD.cu NEW.cu [--skip REGEX] [--strip REGEX]

Builds both sources with the port's flags (each finds its own headers beside
it), disassembles each library with the toolkit's ``cuobjdump -sass`` and
prints, for every kernel function the two have in common, whether its
instructions are the same (the instruction text with the offsets, comments
and the function's name left out), and the functions only one of them has.
Functions whose template arguments match ``--skip`` (for example
``Li256E``, a head-dim instance only the new revision has) are left out.
``--strip`` removes what it matches from the new revision's template
arguments before they are paired: a template argument that only the new
revision has, at the value that gives the old function (``Lb0E$`` pairs the
instances whose last bool argument, such as SEG, is false with the old ones;
those where it is true are then only in the new revision).
Exits 1 if a common function differs. To take an earlier revision's source,
copy it and its headers into a directory that git ignores, as
``tools/ab_flash_fwd.py`` says. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from flash_attention_tpu_torch.ops import _build  # noqa: E402


def functions(kernel) -> dict[str, list[str]]:
    """Each kernel function's instructions, by its kernel name and template
    arguments."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = "".join(subprocess.run([cuobjdump, "-sass", str(path)],
                                  capture_output=True, text=True,
                                  check=True).stdout
                   for path in kernel.lib_paths())
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split(None, 1)
        # the kernel's name and template arguments: the mangled prefix of
        # an anonymous namespace differs from one source file to another
        m = re.search(r"\d+([a-z_]+_kernel)(I.*)EEv", name)
        plain = re.search(r"\d+([a-z_]+_kernel)E", name)  # not a template
        name = (m.group(1) + m.group(2) if m else
                plain.group(1) if plain else name)
        out[name] = [re.sub(r"/\*[^*]*\*/", "", line).strip()
                     for line in body.splitlines()
                     if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--skip", default=None)
    ap.add_argument("--strip", default=None)
    args = ap.parse_args()
    kernels = [_build.Kernel(f"sass_{args.name}_{tag}",
                             str(pathlib.Path(src).resolve()), {})
               for tag, src in (("old", args.old), ("new", args.new))]
    _build.build(kernels)
    old, new = (functions(k) for k in kernels)
    if args.strip:
        new = {re.sub(args.strip, "", n): body for n, body in new.items()}
    skip = re.compile(args.skip) if args.skip else None
    differ = 0
    for name in sorted(set(old) | set(new)):
        if skip and skip.search(name):
            continue
        if name not in old or name not in new:
            print(f"{args.name} {name}: only in {'new' if name in new else 'old'}")
            continue
        same = old[name] == new[name]
        differ += not same
        print(f"{args.name} {name}: {len(new[name])} instructions, "
              f"{'identical' if same else 'DIFFERENT'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
