"""Build and bind the hand-written CUDA kernels at first use.

Each ``.cu`` file under ``flash_attention_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C interface
and loaded with ``ctypes``. A kernel may span several sources (the d-384/512
instances live in files of their own, and dq's pair of CTAs in another, so
that their ``nvcc`` runs beside the others'): its functions are looked up in
whichever of its libraries exports them. No PyTorch header is included, so
a build takes seconds rather than the minutes a ``torch.utils.
cpp_extension`` build costs.
Libraries land in ``build/torch_port/`` (ignored by git), named by a hash of
the source, the shared headers and the flags, so an edited source or header
is rebuilt and an unchanged one is loaded as it is. Every C entry point returns ``cudaGetLastError()`` after its
launch; :meth:`Kernel.check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import types

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_port"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


class Kernel:
    """One kernel's CUDA sources (one library each), its launch count.

    ``launches`` is a plain integer that the wrapper adds one to each time it
    launches the kernel; ``argtypes`` maps each exported C function to its
    ctypes argument list (pointers and the stream as ``c_void_p``).
    ``source`` is a file name under ``csrc/`` or a tuple of them."""

    def __init__(self, name: str, source, argtypes: dict):
        self.name = name
        names = (source,) if isinstance(source, str) else tuple(source)
        self.sources = tuple(CSRC / s for s in names)
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None

    def lib_paths(self) -> list[pathlib.Path]:
        """Each source's library, named by a hash of the source, every
        header under csrc/ (an edited shared header must not load a library
        built from the old one) and the flags."""
        headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        paths = []
        for i, src in enumerate(self.sources):
            h = hashlib.sha1(src.read_bytes())
            h.update(headers)
            h.update(" ".join(NVCC_FLAGS).encode())
            stem = self.name if i == 0 else f"{self.name}+{src.stem}"
            paths.append(BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so")
        return paths

    def lib(self):
        """The kernel's C functions (and ``fat_error_string``) as attributes,
        each from the library that exports it (one that none exports, as
        an older source built for a comparison, is left out)."""
        if self._lib is None:
            build([self])
            libs = [ctypes.CDLL(str(p)) for p in self.lib_paths()]
            fns = {}
            for fn, args in self.argtypes.items():
                lib = next((lb for lb in libs if hasattr(lb, fn)), None)
                if lib is None:
                    continue
                f = getattr(lib, fn)
                f.argtypes = args
                f.restype = ctypes.c_int
                fns[fn] = f
            err = libs[0].fat_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = types.SimpleNamespace(fat_error_string=err, **fns)
        return self._lib

    def check(self, rc: int) -> None:
        if rc != 0:
            msg = self._lib.fat_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")


def build(kernels, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together. Returns each built kernel's compiler
    output, its sources' in turn (with ``ptxas_verbose``, the register and
    shared-memory use)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        for src, out in zip(k.sources, k.lib_paths()):
            if out.exists() and not ptxas_verbose:
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            if ptxas_verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((k.name, src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    logs = {}
    for name, src, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builds agree
        logs[name] = logs.get(name, "") + log
    return logs
