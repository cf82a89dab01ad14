"""Paged-KV page allocator: a ctypes binding to the native C++ runtime
(``csrc/paged_runtime.cpp`` at the repo root) and a pure-Python mirror with
the identical interface.

The port keeps its own copy of this module. The native library is built with
``g++`` into the port's build directory at first use; which runtime runs is
the caller's explicit choice (``native=True`` or ``False``), and a native
runtime that cannot be built raises instead of falling back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

from flash_attention_tpu_torch.ops._build import BUILD_DIR

_SRC = pathlib.Path(__file__).resolve().parents[2] / "csrc" / "paged_runtime.cpp"
_lib = None


def _load_native():
    """Build (once per source version) and bind the native runtime."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libfat_runtime-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(["g++", "-O2", "-fPIC", "-std=c++17", "-shared",
                              "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {_SRC}:\n{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.fat_runtime_create.restype = ctypes.c_void_p
    lib.fat_runtime_create.argtypes = [ctypes.c_int32] * 3
    lib.fat_runtime_destroy.argtypes = [ctypes.c_void_p]
    for name, args in [
        ("fat_free_pages", [ctypes.c_void_p]),
        ("fat_seq_alloc", [ctypes.c_void_p, ctypes.c_int32]),
        ("fat_seq_alloc_windowed",
         [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]),
        ("fat_seq_release_prefix",
         [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]),
        ("fat_seq_append", [ctypes.c_void_p, ctypes.c_int32]),
        ("fat_seq_truncate",
         [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]),
        ("fat_seq_length", [ctypes.c_void_p, ctypes.c_int32]),
        ("fat_seq_num_pages", [ctypes.c_void_p, ctypes.c_int32]),
        ("fat_can_admit", [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]),
        ("fat_can_admit_windowed",
         [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]),
        ("fat_seq_alloc_prefixed",
         [ctypes.c_void_p, ctypes.c_int32,
          ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]),
        ("fat_page_pin", [ctypes.c_void_p, ctypes.c_int32]),
        ("fat_page_unpin", [ctypes.c_void_p, ctypes.c_int32]),
        ("fat_page_refcount", [ctypes.c_void_p, ctypes.c_int32]),
    ]:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = args
    lib.fat_seq_free.restype = None
    lib.fat_seq_free.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fat_seq_page_table.restype = ctypes.c_int32
    lib.fat_seq_page_table.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
    ]
    _lib = lib
    return lib


class _PyRuntime:
    """Pure-Python mirror of csrc/paged_runtime.cpp."""

    def __init__(self, total_pages: int, page_size: int, max_seqs: int):
        self.page_size = page_size
        self.total_pages = total_pages
        self.free_list = list(range(total_pages - 1, -1, -1))
        self.ref = [0] * total_pages   # per-page refcount (0 = on free_list)
        self.pages = [[] for _ in range(max_seqs)]
        self.length = [0] * max_seqs
        self.live = [False] * max_seqs
        self.free_slots = list(range(max_seqs - 1, -1, -1))

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _release(self, page: int) -> None:
        """Pages are shared (prefix caching) and pinned (prefix registry):
        a page frees only when its LAST reference drops."""
        if page < 0:
            return  # window hole
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self.free_list.append(page)

    def _take(self) -> int:
        p = self.free_list.pop()
        self.ref[p] = 1
        return p

    def free_pages(self) -> int:
        return len(self.free_list)

    def seq_alloc(self, prompt_tokens: int, live_from_page: int = 0) -> int:
        if not self.free_slots:
            return -1
        total = self._pages_for(prompt_tokens)
        live_from = max(0, min(live_from_page, total))
        need = total - live_from
        if need > len(self.free_list):
            return -1
        slot = self.free_slots.pop()
        # the first live_from positional entries are holes (-1): a sliding
        # window guarantees their tokens' KV is never read, so no physical
        # page backs them
        self.pages[slot] = ([-1] * live_from
                            + [self._take() for _ in range(need)])
        self.length[slot] = prompt_tokens
        self.live[slot] = True
        return slot

    def seq_release_prefix(self, slot: int, upto_page: int) -> int:
        """Free the physical pages behind the first ``upto_page`` positional
        entries (the sliding window moved past them); entries become holes so
        the table stays positional. Idempotent. Returns pages freed."""
        if self._bad_slot(slot):
            return -1
        freed = 0
        for j in range(min(upto_page, len(self.pages[slot]))):
            if self.pages[slot][j] >= 0:
                self._release(self.pages[slot][j])
                self.pages[slot][j] = -1
                freed += 1
        return freed

    def _bad_slot(self, slot: int) -> bool:
        # mirror csrc/paged_runtime.cpp::bad_slot so the two backends agree
        # on misuse (slot=-1 of a freed/preempted request must not corrupt
        # the last slot via Python negative indexing)
        return slot < 0 or slot >= len(self.live) or not self.live[slot]

    def seq_append(self, slot: int) -> int:
        if self._bad_slot(slot):
            return -1
        need = self._pages_for(self.length[slot] + 1)
        if need > len(self.pages[slot]):
            if not self.free_list:
                return -1
            self.pages[slot].append(self._take())
        self.length[slot] += 1
        return 0

    def seq_truncate(self, slot: int, new_length: int) -> int:
        """Shrink to ``new_length`` tokens, freeing whole tail pages past the
        boundary (speculative decoding returns its unused reservation here).
        Growing is rejected. Returns pages freed, -1 on bad slot/length."""
        if self._bad_slot(slot):
            return -1
        if new_length < 0 or new_length > self.length[slot]:
            return -1
        keep = self._pages_for(new_length)
        freed = 0
        while len(self.pages[slot]) > keep:
            p = self.pages[slot].pop()
            if p >= 0:
                self._release(p)
                freed += 1
        self.length[slot] = new_length
        return freed

    def seq_free(self, slot: int) -> None:
        if self._bad_slot(slot):
            return
        for p in self.pages[slot]:
            self._release(p)
        self.pages[slot] = []
        self.length[slot] = 0
        self.live[slot] = False
        self.free_slots.append(slot)

    def seq_length(self, slot: int) -> int:
        return -1 if self._bad_slot(slot) else self.length[slot]

    def seq_num_pages(self, slot: int) -> int:
        return -1 if self._bad_slot(slot) else len(self.pages[slot])

    def seq_page_table(self, slot: int, out_len: int, pad: int) -> list[int]:
        if self._bad_slot(slot):
            return [pad] * out_len
        p = [x if x >= 0 else pad for x in self.pages[slot][:out_len]]
        return p + [pad] * (out_len - len(p))

    def can_admit(self, prompt_tokens: int, reserve_pages: int,
                  live_from_page: int = 0) -> bool:
        if not self.free_slots:
            return False
        need = max(0, self._pages_for(prompt_tokens) - live_from_page)
        return need + reserve_pages <= len(self.free_list)

    def seq_alloc_prefixed(self, prompt_tokens: int,
                           shared: list[int]) -> int:
        """Allocate adopting ``shared`` as the first pages (prefix caching:
        their KV is valid for this prompt's prefix; re-referenced, not
        copied). -1 (nothing touched) on bad/free shared ids, too many
        shared pages, or pool/slot exhaustion."""
        if not self.free_slots:
            return -1
        total = self._pages_for(prompt_tokens)
        if len(shared) > total:
            return -1
        for p in shared:
            if p < 0 or p >= self.total_pages or self.ref[p] <= 0:
                return -1
        need = total - len(shared)
        if need > len(self.free_list):
            return -1
        slot = self.free_slots.pop()
        for p in shared:
            self.ref[p] += 1
        self.pages[slot] = list(shared) + [self._take() for _ in range(need)]
        self.length[slot] = prompt_tokens
        self.live[slot] = True
        return slot

    def page_pin(self, page: int) -> int:
        """Registry reference: the page (and its KV) outlives the sequences
        using it. Refuses free pages."""
        if page < 0 or page >= self.total_pages or self.ref[page] <= 0:
            return -1
        self.ref[page] += 1
        return 0

    def page_unpin(self, page: int) -> int:
        if page < 0 or page >= self.total_pages or self.ref[page] <= 0:
            return -1
        self._release(page)
        return 0

    def page_refcount(self, page: int) -> int:
        if page < 0 or page >= self.total_pages:
            return -1
        return self.ref[page]


class PagedRuntime:
    """Paged-KV block allocator + admission bookkeeping.

    Thin facade over the native C++ core (``native=True``) or the
    pure-Python mirror (``native=False``).
    """

    def __init__(self, total_pages: int, page_size: int, max_seqs: int,
                 native: bool):
        lib = _load_native() if native else None
        self._lib = lib
        if native:
            self._h = lib.fat_runtime_create(total_pages, page_size, max_seqs)
            self.is_native = True
        else:
            self._py = _PyRuntime(total_pages, page_size, max_seqs)
            self.is_native = False
        self.total_pages = total_pages
        self.page_size = page_size
        self.max_seqs = max_seqs

    def __del__(self):
        if getattr(self, "is_native", False) and self._lib is not None:
            self._lib.fat_runtime_destroy(self._h)

    def free_pages(self) -> int:
        if self.is_native:
            return self._lib.fat_free_pages(self._h)
        return self._py.free_pages()

    def seq_alloc(self, prompt_tokens: int, live_from_page: int = 0) -> int:
        if self.is_native:
            return self._lib.fat_seq_alloc_windowed(self._h, prompt_tokens,
                                                    live_from_page)
        return self._py.seq_alloc(prompt_tokens, live_from_page)

    def seq_release_prefix(self, slot: int, upto_page: int) -> int:
        if self.is_native:
            return self._lib.fat_seq_release_prefix(self._h, slot, upto_page)
        return self._py.seq_release_prefix(slot, upto_page)

    def seq_append(self, slot: int) -> int:
        if self.is_native:
            return self._lib.fat_seq_append(self._h, slot)
        return self._py.seq_append(slot)

    def seq_truncate(self, slot: int, new_length: int) -> int:
        if self.is_native:
            return self._lib.fat_seq_truncate(self._h, slot, new_length)
        return self._py.seq_truncate(slot, new_length)

    def seq_free(self, slot: int) -> None:
        if self.is_native:
            self._lib.fat_seq_free(self._h, slot)
        else:
            self._py.seq_free(slot)

    def seq_length(self, slot: int) -> int:
        if self.is_native:
            return self._lib.fat_seq_length(self._h, slot)
        return self._py.seq_length(slot)

    def seq_num_pages(self, slot: int) -> int:
        if self.is_native:
            return self._lib.fat_seq_num_pages(self._h, slot)
        return self._py.seq_num_pages(slot)

    def seq_page_table(self, slot: int, out_len: int, pad: int = 0) -> list[int]:
        if self.is_native:
            buf = (ctypes.c_int32 * out_len)()
            self._lib.fat_seq_page_table(self._h, slot, buf, out_len, pad)
            return list(buf)
        return self._py.seq_page_table(slot, out_len, pad)

    def can_admit(self, prompt_tokens: int, reserve_pages: int = 0,
                  live_from_page: int = 0) -> bool:
        if self.is_native:
            return bool(self._lib.fat_can_admit_windowed(
                self._h, prompt_tokens, live_from_page, reserve_pages))
        return self._py.can_admit(prompt_tokens, reserve_pages,
                                  live_from_page)

    def seq_alloc_prefixed(self, prompt_tokens: int,
                           shared: list[int]) -> int:
        if self.is_native:
            buf = (ctypes.c_int32 * max(len(shared), 1))(*shared)
            return self._lib.fat_seq_alloc_prefixed(
                self._h, prompt_tokens, buf, len(shared))
        return self._py.seq_alloc_prefixed(prompt_tokens, shared)

    def page_pin(self, page: int) -> int:
        if self.is_native:
            return self._lib.fat_page_pin(self._h, page)
        return self._py.page_pin(page)

    def page_unpin(self, page: int) -> int:
        if self.is_native:
            return self._lib.fat_page_unpin(self._h, page)
        return self._py.page_unpin(page)

    def page_refcount(self, page: int) -> int:
        if self.is_native:
            return self._lib.fat_page_refcount(self._h, page)
        return self._py.page_refcount(page)
