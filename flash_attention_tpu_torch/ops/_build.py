"""Build and bind the hand-written CUDA kernels at first use.

Each ``.cu`` file under ``flash_attention_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C interface
and loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds rather than the minutes a ``torch.utils.cpp_extension`` build costs.
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
    """One CUDA source, its built library and its launch count.

    ``launches`` is a plain integer that the wrapper adds one to each time it
    launches the kernel; ``argtypes`` maps each exported C function to its
    ctypes argument list (pointers and the stream as ``c_void_p``)."""

    def __init__(self, name: str, source: str, argtypes: dict):
        self.name = name
        self.source = CSRC / source
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None

    def lib_path(self) -> pathlib.Path:
        # every header under csrc/ too: an edited shared header must not
        # load a library built from the old one
        h = hashlib.sha1(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:12]}.so"

    def lib(self):
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(str(self.lib_path()))
            for fn, args in self.argtypes.items():
                f = getattr(lib, fn)
                f.argtypes = args
                f.restype = ctypes.c_int
            lib.fat_error_string.argtypes = [ctypes.c_int]
            lib.fat_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, rc: int) -> None:
        if rc != 0:
            msg = self._lib.fat_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")


def build(kernels, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every kernel whose library is missing, one ``nvcc`` process
    per source, all started together. Returns each built kernel's compiler
    output (with ``ptxas_verbose``, the register and shared-memory use)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k in kernels:
        out = k.lib_path()
        if out.exists() and not ptxas_verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[k.name] = (k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (k, tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k.source}:\n{log}")
        os.replace(tmp, k.lib_path())  # atomic: concurrent builds agree
        logs[name] = log
    return logs
