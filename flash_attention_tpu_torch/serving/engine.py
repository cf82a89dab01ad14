"""Single-host serving engine: continuous batching over the paged KV cache.

The PyTorch counterpart of ``flash_attention_tpu/serving/engine.py`` on its
basic path. Per ``step()``:

 1. admit waiting requests and prefill them in ONE padded batch (dense flash
    attention), then scatter their K/V into freshly allocated pages;
 2. grow every running sequence by one cache slot (preempting on pressure);
 3. one ``decode_step`` for the whole running batch (in-place KV write and
    paged attention per layer), padded to the next power of two with dummy
    length-1 rows aimed at a trash page;
 4. sample (greedy by default; temperature/top-k/top-p keyed by
    (seed, position)) and retire finished sequences.

With a sliding window on every layer (Mistral: ``window_pattern == 1``)
the engine reclaims pages as the JAX engine does: admission allocates the
pages wholly behind the window as holes, and decode frees them as the window
moves, in blocks of 8 pages, so a sequence holds O(window) pages. With
alternating window and global layers (Gemma-2) every page stays live.

With ``chunk_size`` (chunked prefill) a batch whose longest context exceeds
it prefills in chunks of ``chunk_size`` tokens (``llama.prefill_chunk``,
the segmented flash forward over [prefix pages || chunk]), each chunk's K/V
scattered into its pages before the next; under a window, admission holes
only the pages dead to the second chunk's first query, and each chunk
releases the pages behind its own window, by the JAX engine's rules.

The power-of-two batch and bucket padding and the trash page are kept so the
port emits the same tokens as the JAX engine; on the GPU they are not needed
for compilation and may go with CUDA graphs later. A Mixtral (MoE) model
routes every row it is given, pad rows and pad batch entries included, as
the JAX engine does. Weight-only quantized params (``llama.quantize_params``)
serve as they are; the device and the cache dtype come from the bf16
embedding.

``kv_quant=True`` keeps the cache in 8 bits, by the JAX engine's rules:
int8 (the default for any float ``kv_dtype``) or fp8 e4m3
(``kv_dtype=torch.float8_e4m3fn``), page_size 128, with per-token scales in
(L, hk, P, 8, 128) fp32 tiles that start at ones; an 8-bit ``kv_dtype``
without ``kv_quant`` raises ValueError. Tensor parallelism (and expert
parallelism with it), speculative decoding, prefix caching, multi-step
decode and LoRA are outside this slice and raise.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from flash_attention_tpu_torch.models import llama
from flash_attention_tpu_torch.ops.quant import KV_QMAX
from flash_attention_tpu_torch.serving import sampling
from flash_attention_tpu_torch.serving.native import PagedRuntime
from flash_attention_tpu_torch.serving.scheduler import Request, Scheduler
from flash_attention_tpu_torch.utils.options import reject_unported


KERNEL_PPB = 8  # the JAX paged kernel's pages_per_block


def _pow2(n: int) -> int:
    return max(1, 1 << (n - 1).bit_length())


class Engine:
    def __init__(
        self,
        cfg: llama.LlamaConfig,
        params: dict,
        *,
        total_pages: int = 512,
        page_size: int = 64,
        max_batch: int = 8,
        max_seq_len: int = 2048,
        kv_dtype: torch.dtype = torch.bfloat16,
        kv_quant: bool = False,
        native_allocator: bool = False,
        mesh=None,
        tp_axis: str = "model",
        chunk_size: int | None = None,
        draft_cfg=None,
        draft_params=None,
        n_draft: int = 4,
        prefix_cache: bool = False,
        decode_block: int = 1,
        lora_rank: int | None = None,
        lora_targets: tuple = ("wq", "wk", "wv", "wo"),
        max_loras: int = 8,
    ):
        # the JAX engine's errors for chunk_size first, then, in its order,
        # each unported option at a value other than its default raises,
        # naming the option
        if chunk_size is not None and chunk_size % page_size:
            raise ValueError(
                f"chunk_size {chunk_size} must be a multiple of page_size "
                f"{page_size} (chunks scatter whole pages)")
        if chunk_size is not None and prefix_cache:
            raise ValueError("prefix caching with chunked prefill is not "
                             "supported; the prefix path already prefills in "
                             "one suffix chunk")
        if chunk_size is not None and draft_cfg is not None:
            raise ValueError("speculative decoding with chunked prefill is "
                             "not supported yet")
        quant_dtypes = tuple(KV_QMAX)  # int8, fp8 e4m3
        if kv_quant:
            # a float kv_dtype selects the default quantized cache, int8;
            # fp8 e4m3 is chosen explicitly
            if kv_dtype not in quant_dtypes:
                kv_dtype = torch.int8
        elif kv_dtype in quant_dtypes:
            raise ValueError(
                f"kv_dtype={kv_dtype} without kv_quant=True would build an "
                f"unscaled quantized cache; pass kv_quant=True")
        if kv_quant and page_size != 128:
            raise ValueError("kv_quant requires page_size == 128 (scale lane "
                             "= token in page)")
        unsupported = {
            "kv_dtype (the cache holds K/V in the weights' dtype or, with "
            "kv_quant, in 8 bits)":
                kv_dtype not in (torch.bfloat16, params["embed"].dtype,
                                 *quant_dtypes),
            "mesh (tensor parallelism)": mesh is not None,
            "tp_axis (tensor parallelism)": tp_axis != "model",
            "draft_cfg, draft_params (speculative decoding)":
                draft_cfg is not None or draft_params is not None,
            "n_draft (speculative decoding)": n_draft != 4,
            "prefix_cache": prefix_cache,
            "decode_block (multi-step decode)": decode_block != 1,
            "lora_rank (multi-LoRA)": lora_rank is not None,
            "lora_targets (multi-LoRA)":
                tuple(lora_targets) != ("wq", "wk", "wv", "wo"),
            "max_loras (multi-LoRA)": max_loras != 8}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"outside this slice of the PyTorch port: {', '.join(bad)}")
        llama.check_supported(cfg, params)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.chunk_size = chunk_size
        # +1 slot/page budget for the trash page dummy rows write into
        self.rt = PagedRuntime(total_pages, page_size, max_seqs=max_batch + 1,
                               native=native_allocator)
        trash_slot = self.rt.seq_alloc(1)
        assert trash_slot >= 0
        self.trash_page = self.rt.seq_page_table(trash_slot, 1)[0]
        # Sliding-window serving (cfg.sliding_window = W): a token at
        # position n - 1 reads keys [n - W, n). Pages in whole blocks of
        # KERNEL_PPB pages behind the window are never allocated (admission)
        # or freed as the window moves (decode): the JAX engine's rule, so
        # both hold the same pages. Only when EVERY layer slides
        # (window_pattern == 1): a global layer reads the whole cache.
        window = cfg.sliding_window if cfg.window_pattern == 1 else None
        self.window = window

        def live_from_page(tokens: int) -> int:
            """The first page a sequence of ``tokens`` tokens still reads:
            the pages before it lie wholly behind the window, in whole
            blocks of KERNEL_PPB pages (0 without window reclamation). A
            closure over the window, not a method: the scheduler keeps it,
            and a bound method would tie the engine (and its cache) into a
            reference cycle that outlives ``del engine``."""
            if window is None:
                return 0
            blk = KERNEL_PPB * page_size
            return max(tokens - window, 0) // blk * KERNEL_PPB

        self.live_from_page = live_from_page
        sched_live = live_from_page
        if chunk_size is not None:
            # chunked prefill reads mid-prompt prefix K/V back out of the
            # pages, so admission holes only the pages dead to the second
            # chunk's first query (position chunk_size); _prefill_chunked
            # releases the rest as the chunk frontier moves
            def sched_live(tokens: int) -> int:
                return live_from_page(min(tokens, chunk_size + 1))
        self.sched = Scheduler(self.rt, max_batch=max_batch,
                               reserve_pages=max_batch,
                               live_from_page_fn=sched_live)
        # page-table width: one batch row must span max_seq_len
        self.pages_per_seq = -(-max_seq_len // page_size)
        L, hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        # the cache holds K/V in the weights' dtype, or quantized in 8 bits
        self.k_pages = torch.zeros((L, hk, total_pages, page_size, hd),
                                   dtype=kv_dtype if kv_quant
                                   else params["embed"].dtype,
                                   device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        self.k_scales = self.v_scales = None
        if kv_quant:
            self.k_scales = torch.ones((L, hk, total_pages, 8, 128),
                                       dtype=torch.float32,
                                       device=self.device)
            self.v_scales = torch.ones_like(self.k_scales)
        self._uid = 0
        self._last_lps = None  # logprobs of the last _sample_batch's tokens
        self.stats = {"decode_steps": 0, "decode_tokens": 0,
                      "prefill_tokens": 0, "prefill_dispatches": 0,
                      "decode_time": 0.0, "prefill_time": 0.0}

    # ------------------------------------------------------------- requests
    def add_request(self, prompt: list[int], max_new_tokens: int,
                    eos_id: int | None = None, *, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                    lora: str | None = None, stop_ids=(),
                    logprobs: bool = False) -> Request:
        """Queue a request. ``lora`` (an adapter by name) is not ported: a
        value other than None raises NotImplementedError."""
        reject_unported("Engine.add_request", lora=(lora, None))
        total = len(prompt) + max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt+max_new_tokens = {total} exceeds max_seq_len "
                f"{self.max_seq_len}")
        need = -(-total // self.page_size)
        if self.window is not None and self.chunk_size is None:
            # a windowed sequence holds at most the window and one block of
            # not yet reclaimed pages, whatever its length (not with chunked
            # prefill: admission keeps the whole prompt but the first chunk's
            # dead pages live)
            need = min(need, -(-self.window // self.page_size)
                       + KERNEL_PPB + 1)
        budget = self.rt.total_pages - 1 - self.sched.reserve_pages  # -trash
        if need > budget:
            raise ValueError(
                f"request needs {need} pages but the pool can ever free at "
                f"most {budget}; it would wait forever")
        self._uid += 1
        req = Request(self._uid, list(prompt), max_new_tokens, eos_id=eos_id,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, stop_ids=tuple(stop_ids), logprobs=logprobs)
        self.sched.add(req)
        return req

    def add_adapter(self, name: str, adapter) -> int:
        """Register a LoRA adapter: not ported (LoRA serving is a later
        slice), so it raises NotImplementedError."""
        raise NotImplementedError("Engine.add_adapter: LoRA adapters are not "
                                  "ported to the PyTorch port")

    # -------------------------------------------------------------- sampling
    def _sample_batch(self, reqs: list[Request], logits) -> list[int]:
        """Next token per request; row i of ``logits`` belongs to reqs[i]
        (extra rows are ignored). Random bits depend only on
        (req.seed, position), see serving.sampling."""
        n = len(reqs)
        toks = sampling.sample_tokens(
            logits[:n], [r.temperature for r in reqs], [r.top_k for r in reqs],
            [r.top_p for r in reqs], [r.seed for r in reqs],
            [len(r.output) for r in reqs],
            need_filters=any(r.top_k > 0 or r.top_p < 1.0 for r in reqs))
        self._last_lps = (sampling.token_logprobs(logits[:n], toks).tolist()
                          if any(r.logprobs for r in reqs) else None)
        return toks.tolist()

    def _append_token(self, req: Request, i: int, tok: int) -> None:
        req.output.append(tok)
        if req.logprobs and self._last_lps is not None:
            req.token_logprobs.append(float(self._last_lps[i]))

    # -------------------------------------------------------------- prefill
    def _prefill_batch(self, reqs: list[Request]) -> None:
        """ONE padded-batch prefill for every request admitted this step.

        Each row is the request's full context (prompt plus tokens generated
        before a preemption). Lengths pad to a pow2 bucket (min 32) and the
        batch to pow2; pad tokens sit after each context, where causal
        masking keeps them from every real position."""
        t0 = time.perf_counter()
        seqs = [r.prompt + r.output for r in reqs]
        n_max = max(len(s) for s in seqs)
        if self.chunk_size is not None and n_max > self.chunk_size:
            return self._prefill_chunked(reqs, seqs, t0)
        bucket = max(32, _pow2(n_max))
        bsz = _pow2(len(reqs))
        toks = np.zeros((bsz, bucket), np.int64)
        last = np.zeros((bsz,), np.int64)
        for i, s in enumerate(seqs):
            toks[i, : len(s)] = s
            last[i] = len(s) - 1
        logits, ks, vs = llama.prefill(
            self.params, torch.from_numpy(toks).to(self.device), self.cfg,
            logit_rows=torch.from_numpy(last).to(self.device))
        # ONE page-granular scatter for every (request, page) pair; N pads
        # to pow2 with trash-page entries
        dest, src_row, src_page = [], [], []
        for i, req in enumerate(reqs):
            n_pages = self.rt.seq_num_pages(req.slot)
            for j, pid in enumerate(self.rt.seq_page_table(req.slot, n_pages,
                                                           pad=-1)):
                if pid < 0:
                    continue  # a window hole: its KV is never read
                dest.append(pid)
                src_row.append(i)
                src_page.append(j)
            self.stats["prefill_tokens"] += len(seqs[i])
        n_pad = _pow2(len(dest))
        dest += [self.trash_page] * (n_pad - len(dest))
        src_row += [0] * (n_pad - len(src_row))
        src_page += [0] * (n_pad - len(src_page))
        llama.write_prefill_to_pages(
            self.k_pages, self.v_pages, (ks, vs), torch.tensor(dest),
            torch.tensor(src_row), torch.tensor(src_page), self.page_size,
            k_scales=self.k_scales, v_scales=self.v_scales)
        for i, (req, tok) in enumerate(zip(reqs, self._sample_batch(reqs, logits))):
            self._append_token(req, i, tok)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_time"] += time.perf_counter() - t0

    def _prefill_chunked(self, reqs: list[Request], seqs, t0) -> None:
        """Prefill ``reqs`` in chunks of ``chunk_size`` tokens.

        Each chunk is one ``llama.prefill_chunk`` at (batch, chunk_size):
        the chunk's queries attend to [prefix pages || chunk], then its
        whole pages scatter into the cache through ``write_prefill_to_pages``.
        The batch pads to a power of two, and the prefix table to a power of
        two in pages with the trash page (masked off by ``done``), as in the
        JAX engine. Only each row's last context position reaches the
        lm_head (``logit_rows``)."""
        cs, ps = self.chunk_size, self.page_size
        dev = self.device
        n = len(reqs)
        bsz = _pow2(n)
        lens = np.zeros((bsz,), np.int64)
        for i, s in enumerate(seqs):
            lens[i] = len(s)
        n_chunks = -(-int(lens.max()) // cs)
        toks = np.zeros((bsz, n_chunks * cs), np.int64)
        for i, s in enumerate(seqs):
            toks[i, : len(s)] = s
        final = None  # (bsz, vocab) fp32: each row's last-token logits
        for step in range(n_chunks):
            base = step * cs
            done = np.minimum(lens, base)
            clen = np.clip(lens - base, 0, cs)
            if self.window is not None and base:
                # the chunk frontier is the oldest remaining query: release
                # the prefix pages behind its window
                for i, r in enumerate(reqs):
                    self.rt.seq_release_prefix(
                        r.slot, self.live_from_page(min(int(lens[i]), base)
                                                    + 1))
            npp = _pow2(max(1, -(-base // ps)))
            tables = np.full((bsz, npp), self.trash_page, np.int64)
            for i, r in enumerate(reqs):
                row = np.asarray(self.rt.seq_page_table(r.slot, npp, pad=-1))
                tables[i] = np.where(row < 0, self.trash_page, row)
            last = lens - 1
            logits, ks, vs = llama.prefill_chunk(
                self.params, torch.from_numpy(toks[:, base:base + cs]).to(dev),
                torch.from_numpy(done).to(dev), torch.from_numpy(clen).to(dev),
                self.k_pages, self.v_pages, self.k_scales, self.v_scales,
                torch.from_numpy(tables).to(dev), self.cfg,
                logit_rows=torch.from_numpy(np.clip(last - base, 0,
                                                    cs - 1)).to(dev))
            # this chunk's whole pages (chunk_size % page_size == 0, so
            # chunk-local page j holds tokens [base + j ps, ...))
            dest, src_row, src_page = [], [], []
            p0 = base // ps
            for i, r in enumerate(reqs):
                for j in range(-(-int(clen[i]) // ps)):
                    pid = self.rt.seq_page_table(r.slot, p0 + j + 1,
                                                 pad=-1)[p0 + j]
                    if pid < 0:
                        continue  # a window hole: its KV is never read
                    dest.append(pid)
                    src_row.append(i)
                    src_page.append(j)
            if dest:
                n_pad = _pow2(len(dest))
                dest += [self.trash_page] * (n_pad - len(dest))
                src_row += [0] * (n_pad - len(src_row))
                src_page += [0] * (n_pad - len(src_page))
                llama.write_prefill_to_pages(
                    self.k_pages, self.v_pages, (ks, vs), torch.tensor(dest),
                    torch.tensor(src_row), torch.tensor(src_page), ps,
                    k_scales=self.k_scales, v_scales=self.v_scales)
            # rows whose last context token falls in this chunk take its
            # logits
            here = torch.from_numpy((last >= base) & (last < base + clen))
            final = logits if final is None else torch.where(
                here.to(dev)[:, None], logits, final)
            self.stats["prefill_chunks"] = self.stats.get("prefill_chunks",
                                                          0) + 1
        self.stats["prefill_tokens"] += int(lens[:n].sum())
        for i, (req, tok) in enumerate(zip(reqs, self._sample_batch(reqs, final))):
            self._append_token(req, i, tok)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_time"] += time.perf_counter() - t0

    # --------------------------------------------------------------- decode
    def _decode_batch(self, reqs: list[Request], tokens: list[int]):
        """One decode step for ``reqs``; returns the next token per request."""
        t0 = time.perf_counter()
        n = len(reqs)
        bsz = _pow2(n)
        tok = np.zeros((bsz,), np.int64)
        lengths = np.ones((bsz,), np.int32)
        tables = np.full((bsz, self.pages_per_seq), self.trash_page, np.int32)
        wpage = np.full((bsz,), self.trash_page, np.int32)
        woff = np.zeros((bsz,), np.int32)
        for i, (r, t) in enumerate(zip(reqs, tokens)):
            ln = self.rt.seq_length(r.slot)  # already grown for this token
            if self.window is not None:  # pages the window moved past
                self.rt.seq_release_prefix(r.slot, self.live_from_page(ln))
            if ln > self.pages_per_seq * self.page_size:
                raise RuntimeError(
                    f"request {r.uid}: length {ln} exceeds the page-table "
                    f"width {self.pages_per_seq} x page_size {self.page_size}")
            tok[i] = t
            lengths[i] = ln
            tables[i] = self.rt.seq_page_table(r.slot, self.pages_per_seq,
                                               pad=self.trash_page)
            wpage[i] = tables[i][(ln - 1) // self.page_size]
            woff[i] = (ln - 1) % self.page_size
        dev = self.device
        logits, *_ = llama.decode_step(
            self.params, self.k_pages, self.v_pages, self.k_scales,
            self.v_scales,
            torch.from_numpy(tok).to(dev), torch.from_numpy(lengths).to(dev),
            torch.from_numpy(tables).to(dev), torch.from_numpy(wpage).to(dev),
            torch.from_numpy(woff).to(dev), self.cfg)
        out = self._sample_batch(reqs, logits)
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += n
        self.stats["decode_time"] += time.perf_counter() - t0
        return out

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self) -> list[Request]:
        """One engine iteration. Returns requests finished this step.

        An exception from a prefill or decode dispatch fails the requests of
        that dispatch (``req.error`` holds the exception and its traceback,
        pages freed) instead of stopping the engine; later steps keep serving
        the others."""
        finished = []
        admitted = self.sched.admit()
        if admitted:
            try:
                self._prefill_batch(admitted)
            except Exception as e:  # noqa: BLE001 — surfaced on the requests
                tb = traceback.format_exc()
                for req in admitted:
                    self.sched.fail(req, f"prefill failed: {e!r}\n{tb}")
                finished.extend(admitted)

        # retire before decoding (a request may finish on its prefill token)
        for req in list(self.sched.running):
            if req.done:
                self.sched.finish(req)
                finished.append(req)

        batch, feed = [], []
        for req in list(self.sched.running):
            if req.slot < 0:
                continue  # preempted by an earlier grow() in this snapshot
            if self.sched.grow(req):       # reserve the slot for this token
                batch.append(req)
                feed.append(req.output[-1])
        # a later grow() may have preempted an earlier batch member
        live = [(r, t) for r, t in zip(batch, feed) if r.slot >= 0]
        batch, feed = [r for r, _ in live], [t for _, t in live]
        if batch:
            try:
                next_tokens = self._decode_batch(batch, feed)
            except Exception as e:  # noqa: BLE001 — surfaced on the requests
                tb = traceback.format_exc()
                for req in batch:
                    self.sched.fail(req, f"decode failed: {e!r}\n{tb}")
                finished.extend(batch)
                return finished
            for i, (req, nxt) in enumerate(zip(batch, next_tokens)):
                self._append_token(req, i, nxt)
                if req.done:
                    self.sched.finish(req)
                    finished.append(req)
        return finished

    def stream(self, max_steps: int = 10_000):
        """Yield ``(request, new_tokens, finished)`` after every step that
        emitted tokens for a request; a finished request is yielded exactly
        once with finished=True."""
        seen: dict[int, int] = {}
        while self.sched.has_work and max_steps > 0:
            max_steps -= 1
            done = self.step()
            for req in list(self.sched.running) + done:
                n = seen.get(req.uid, 0)
                if len(req.output) > n or req in done:
                    yield req, req.output[n:], req in done
                    seen[req.uid] = len(req.output)

    def run(self, max_steps: int = 10_000, on_step=None) -> list[Request]:
        """Step until no request is left; ``on_step(self)``, when given, is
        called after every step."""
        done = []
        for _ in range(max_steps):
            if not self.sched.has_work:
                break
            done.extend(self.step())
            if on_step is not None:
                on_step(self)
        return done

    def throughput(self) -> dict:
        s = self.stats
        return {
            "decode_tokens_per_s": s["decode_tokens"] / max(s["decode_time"], 1e-9),
            "prefill_tokens_per_s": s["prefill_tokens"] / max(s["prefill_time"], 1e-9),
            **s,
        }
