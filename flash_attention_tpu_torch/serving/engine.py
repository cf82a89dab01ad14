"""Single-host serving engine: continuous batching over the paged KV cache.

The PyTorch counterpart of ``flash_attention_tpu/serving/engine.py`` on its
basic path. Per ``step()``:

 1. admit waiting requests and prefill them in ONE padded batch (dense flash
    attention), then scatter their K/V into freshly allocated pages;
 2. grow every running sequence by ``decode_block`` cache slots (one by
    default; preempting on pressure);
 3. ``decode_block`` ``decode_step``s for the whole running batch through
    ``multistep.decode_rollout`` (in-place KV write and paged attention per
    layer, then the sample: greedy by default, temperature/top-k/top-p
    keyed by (seed, position)), padded to the next power of two with dummy
    length-1 rows aimed at a trash page, and ONE readback of the tokens;
 4. commit the tokens and retire finished sequences.

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
without ``kv_quant`` raises ValueError.

The decode-side options, by the JAX engine's rules and with its errors:

* ``decode_block=k`` (multi-step decode): k decode steps a step, one
  readback for the block; rows stopping inside it drop the tail and
  ``seq_truncate`` returns its slots. The JAX engine keeps a separate
  single-step path for k = 1; here k = 1 is the same rollout of one step.
* ``prefix_cache=True``: requests adopt the pages of a cached prompt prefix
  (``prefix.PrefixCache``, chain-hashed whole pages with allocator pins)
  and prefill only their suffix in one ``prefill_chunk``.
* ``draft_cfg``/``draft_params``/``n_draft`` (speculative decoding): the
  draft proposes ``n_draft`` tokens (``spec.draft_rollout``, its own page
  pools on the shared page tables), the target verifies them in one
  ``prefill_chunk``, ``llama.write_chunk_to_pages`` commits the chunk's K/V
  token by token and ``sampling.spec_accept`` keeps the accepted prefix and
  one more token.

Multi-LoRA (``Engine(lora_rank=, lora_targets=, max_loras=)``, by the JAX
engine's rules): ``max_loras + 1`` adapter slots stacked in the weights'
dtype (slot 0 the base model), ``add_adapter`` writes one, and
``add_request(lora=name)`` puts the request's slot id on its row in every
prefill and decode dispatch (padding rows on slot 0), so one dispatch
serves a batch that mixes adapters. The prefix registry salts its digests
with the slot, so adapters never share cached pages.

Tensor parallelism (``Engine(mesh=make_mesh(model=tp), tp_axis="model")``,
by the JAX engine's rules): the weights are sharded by
``parallel.tp_inference.shard_params`` (column- and row-parallel
projections; Mixtral's experts by the expert axis) once, and every dispatch
runs the single-device function on them with the local config and
``tp_axis=(mesh, tp_axis)`` (what ``tp_prefill``, ``tp_prefill_chunk``,
``multistep.tp_decode_rollout`` and ``spec.tp_draft_rollout`` run), each
rank's cache holding its ``n_kv_heads / tp`` kv heads. The port is SPMD where the JAX engine is one controller:
every rank builds the same engine, receives the same requests and takes the
same scheduling decisions, and the sampling draws by (seed, position) from
replicated logits, so every rank emits the same tokens. A dispatch that
raises on one rank only leaves the ranks out of step. ``kv_quant``,
``chunk_size``, ``decode_block``, ``prefix_cache`` and speculative decoding
run with a mesh; ``lora_rank`` with a mesh raises, as in JAX.

The cache is allocated at the kernels' head dim (``ops.attention.
kernel_head_dim``: a d-96 model's K/V zero-padded to 128, a d-320 one's to
384), so every head dim the prefill takes also decodes on the card.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from flash_attention_tpu_torch.models import llama, lora as lora_lib
from flash_attention_tpu_torch.ops.attention import kernel_head_dim
from flash_attention_tpu_torch.ops.quant import KV_QMAX
from flash_attention_tpu_torch.parallel import tp_inference
from flash_attention_tpu_torch.parallel.mesh import axis_size
from flash_attention_tpu_torch.serving import multistep, sampling
from flash_attention_tpu_torch.serving import spec as spec_mod
from flash_attention_tpu_torch.serving.native import PagedRuntime
from flash_attention_tpu_torch.serving.prefix import PrefixCache
from flash_attention_tpu_torch.serving.scheduler import Request, Scheduler


KERNEL_PPB = 8  # the JAX paged kernel's pages_per_block


def _pow2(n: int) -> int:
    return max(1, 1 << (n - 1).bit_length())


def _cache_width(head_dim: int) -> int:
    """The cache's head dim: the kernels' (zero-padded; d 320 at 384), or
    the model's own above 512, which only the CPU's plain versions run."""
    return head_dim if head_dim > 512 else kernel_head_dim(head_dim)


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
        # the JAX engine's errors in its order; then each unported option at
        # a value other than its default raises, naming the option
        if chunk_size is not None and chunk_size % page_size:
            raise ValueError(
                f"chunk_size {chunk_size} must be a multiple of page_size "
                f"{page_size} (chunks scatter whole pages)")
        # with window_pattern == 1 the engine reclaims the pages behind the
        # window (Mistral); a global layer reads every page (Gemma-2)
        window = cfg.sliding_window if cfg.window_pattern == 1 else None
        if prefix_cache:
            if window is not None:
                raise ValueError("prefix caching with sliding-window page "
                                 "reclamation is not supported")
            if chunk_size is not None:
                raise ValueError("prefix caching with chunked prefill is not "
                                 "supported; the prefix path already "
                                 "prefills in one suffix chunk")
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
        if (draft_cfg is None) != (draft_params is None):
            raise ValueError("draft_cfg and draft_params come together")
        self.spec = draft_cfg is not None
        if self.spec:
            if n_draft < 1:
                raise ValueError("n_draft must be >= 1")
            if chunk_size is not None:
                raise ValueError("speculative decoding with chunked prefill "
                                 "is not supported yet")
            if window is not None:
                # the verification chunk's prefix gather and the truncation
                # of rejected slots assume a prefix without holes
                raise ValueError("speculative decoding with sliding-window "
                                 "page reclamation is not supported yet")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}")
        if int(decode_block) < 1:
            raise ValueError("decode_block must be >= 1")
        if int(decode_block) > 1 and self.spec:
            raise ValueError("decode_block with speculative decoding is not "
                             "supported; a spec step already emits up to "
                             "n_draft+1 tokens per dispatch")
        if lora_rank is not None:
            if mesh is not None:
                raise ValueError("multi-LoRA with tensor parallelism is not "
                                 "supported yet")
            if self.spec:
                raise ValueError("multi-LoRA with speculative decoding is "
                                 "not supported yet")
        if kv_dtype not in (torch.bfloat16, params["embed"].dtype,
                            *quant_dtypes):
            raise NotImplementedError(
                "outside this slice of the PyTorch port: kv_dtype (the cache "
                "holds K/V in the weights' dtype or, with kv_quant, in 8 "
                "bits)")
        llama.check_supported(cfg, params)
        if self.spec:
            llama.check_supported(draft_cfg, draft_params)
        # tensor parallelism: this rank's part of the weights (the draft
        # sharded like the target) and its kv heads of the caches
        # and the local configs every dispatch runs with tp_axis=self._tp
        self.mesh, self.tp_axis = mesh, tp_axis
        tp, self._tp = 1, None
        if mesh is not None:
            tp, self._tp = axis_size(mesh, tp_axis), (mesh, tp_axis)
            params = tp_inference.shard_params(params, cfg, mesh, tp_axis)
            if self.spec:
                draft_params = tp_inference.shard_params(
                    draft_params, draft_cfg, mesh, tp_axis)
        self._cfg = tp_inference.local_config(cfg, tp)
        self._draft_cfg = (tp_inference.local_config(draft_cfg, tp)
                           if self.spec else None)
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
        # prefix caching: admission counts the cached pages a request
        # adopts, and evicts registry-only pages under pressure
        self.prefix = PrefixCache(self.rt, page_size) if prefix_cache \
            else None
        self.sched = Scheduler(
            self.rt, max_batch=max_batch, reserve_pages=max_batch,
            live_from_page_fn=sched_live,
            can_admit_fn=self._prefix_can_admit if prefix_cache else None,
            alloc_fn=self._prefix_alloc if prefix_cache else None)
        # page-table width: one batch row must span max_seq_len
        self.pages_per_seq = -(-max_seq_len // page_size)
        L, hd = cfg.n_layers, _cache_width(cfg.head_dim)
        hk = self._cfg.n_kv_heads
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
        # the draft model's own pools, on the same page ids
        self.draft_cfg, self.draft_params = draft_cfg, draft_params
        self.n_draft = n_draft
        self.k_pages_d = self.v_pages_d = None
        self.k_scales_d = self.v_scales_d = None
        if self.spec:
            hkd = self._draft_cfg.n_kv_heads
            self.k_pages_d = torch.zeros(
                (draft_cfg.n_layers, hkd, total_pages, page_size,
                 _cache_width(draft_cfg.head_dim)), dtype=self.k_pages.dtype,
                device=self.device)
            self.v_pages_d = torch.zeros_like(self.k_pages_d)
            if kv_quant:
                self.k_scales_d = torch.ones(
                    (draft_cfg.n_layers, hkd, total_pages, 8, 128),
                    dtype=torch.float32, device=self.device)
                self.v_scales_d = torch.ones_like(self.k_scales_d)
        self.decode_block = int(decode_block)
        # multi-LoRA: fixed-capacity stacks, slot 0 the base model
        self.lora_rank = lora_rank
        self.lora_targets = tuple(lora_targets)
        self.lora_stacks = None
        self._lora_map: dict = {None: 0}
        if lora_rank is not None:
            self.lora_stacks = lora_lib.stack_adapters(
                cfg, [], lora_rank, self.lora_targets, n_slots=max_loras + 1,
                dtype=params["embed"].dtype, device=self.device)
        self._uid = 0
        self._last_lps = None  # logprobs of the last _sample_batch's tokens
        self.stats = {"decode_steps": 0, "decode_tokens": 0,
                      "prefill_tokens": 0, "prefill_dispatches": 0,
                      "decode_time": 0.0, "prefill_time": 0.0,
                      "spec_steps": 0, "spec_proposed": 0, "spec_accepted": 0}

    # ------------------------------------------------------------- requests
    def add_request(self, prompt: list[int], max_new_tokens: int,
                    eos_id: int | None = None, *, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                    lora: str | None = None, stop_ids=(),
                    logprobs: bool = False) -> Request:
        """Queue a request; ``lora`` names an adapter registered with
        ``add_adapter`` (None: the base model)."""
        total = len(prompt) + max_new_tokens
        if self.spec:
            if top_k > 0 or top_p < 1.0:
                # rejection sampling is exact only against the draft's
                # unfiltered distribution
                raise ValueError("speculative decoding does not support "
                                 "top-k/top-p filtered requests")
            # a spec step reserves n_draft slots past the committed frontier
            total += self.n_draft
        # a multi-step block reserves decode_block - 1 slots past it
        total += self.decode_block - 1
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
        if lora is not None and lora not in self._lora_map:
            raise ValueError(f"unknown adapter {lora!r}; register it with "
                             f"add_adapter first")
        self._uid += 1
        req = Request(self._uid, list(prompt), max_new_tokens, eos_id=eos_id,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, lora_id=self._lora_map.get(lora, 0),
                      stop_ids=tuple(stop_ids), logprobs=logprobs)
        self.sched.add(req)
        return req

    # ----------------------------------------------------------------- lora
    def add_adapter(self, name: str, adapter) -> int:
        """Register a LoRA adapter ({target: (A (L, din, r), B (L, r,
        dout))}, e.g. ``models.lora.init_adapter``) under ``name``; requests
        select it with ``add_request(..., lora=name)``. Writes the next
        stack slot in place and returns its id."""
        if self.lora_rank is None:
            raise ValueError("engine built without lora_rank")
        if name in self._lora_map:
            raise ValueError(f"adapter {name!r} already registered")
        slot = len(self._lora_map)
        n_slots = self.lora_stacks[self.lora_targets[0]][0].shape[1]
        if slot >= n_slots:
            raise ValueError(f"adapter capacity {n_slots - 1} exhausted")
        for t in adapter:
            if t not in self.lora_targets:
                raise ValueError(f"adapter targets {t!r}; engine was built "
                                 f"for {self.lora_targets}")
        lora_lib.set_slot(self.lora_stacks, slot, adapter, self.lora_targets)
        self._lora_map[name] = slot
        return slot

    def _model_params(self):
        """Params as dispatched: the base weights plus the LoRA stacks."""
        if self.lora_stacks is None:
            return self.params
        return {**self.params, "lora": self.lora_stacks}

    def _lora_ids(self, reqs: list[Request], bsz: int):
        """(bsz,) adapter slot per row on the card (padding rows on slot 0,
        the base model), moved as the other per-row host inputs are; None
        when the engine has no LoRA."""
        if self.lora_stacks is None:
            return None
        ids = np.zeros((bsz,), np.int64)
        for i, r in enumerate(reqs):
            ids[i] = r.lora_id
        return torch.from_numpy(ids).to(self.device)

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

    # ------------------------------------------------------- prefix caching
    def _prefix_can_admit(self, req: Request) -> bool:
        """Admission counting cached-prefix reuse: a request needs pages
        only for its uncached context, and registry-only cached pages may
        be evicted to make room (least recently used first, never the pages
        this request is about to adopt)."""
        cap = req.context_len - 1  # >= 1 suffix token for its logits
        shared = len(self.prefix.lookup(req.prompt, cap, salt=req.lora_id))
        need = (-(-(req.context_len + 1) // self.page_size) - shared
                + self.sched.reserve_pages)
        shortfall = need - self.rt.free_pages()
        if shortfall > 0:
            keep = self.prefix.keep_set(req.prompt, cap, salt=req.lora_id)
            if self.prefix.evict(shortfall, keep=keep) < shortfall:
                return False
        return self.rt.can_admit(req.context_len + 1 - shared * self.page_size,
                                 self.sched.reserve_pages)

    def _prefix_alloc(self, req: Request) -> int:
        pages = self.prefix.lookup(req.prompt, req.context_len - 1,
                                   salt=req.lora_id)
        slot = self.rt.seq_alloc_prefixed(req.context_len, pages)
        if slot >= 0:
            req.cached_tokens = len(pages) * self.page_size
            self.stats["prefix_reused_tokens"] = (
                self.stats.get("prefix_reused_tokens", 0)
                + req.cached_tokens)
        return slot

    # -------------------------------------------------------------- prefill
    def _scatter_args(self, dest, src_row, src_page):
        """(page ids, source rows, source pages) of a page scatter as
        tensors, padded to a power of two with trash-page entries as the
        JAX engine pads them."""
        n_pad = _pow2(len(dest)) - len(dest)
        return (torch.tensor(dest + [self.trash_page] * n_pad),
                torch.tensor(src_row + [0] * n_pad),
                torch.tensor(src_page + [0] * n_pad))

    def _prefill_batch(self, reqs: list[Request]) -> None:
        """ONE padded-batch prefill for every request admitted this step.

        Each row is the request's full context (prompt plus tokens generated
        before a preemption). Lengths pad to a pow2 bucket (min 32) and the
        batch to pow2; pad tokens sit after each context, where causal
        masking keeps them from every real position."""
        t0 = time.perf_counter()
        seqs = [r.prompt + r.output for r in reqs]
        n_max = max(len(s) for s in seqs)
        if self.prefix is not None:
            return self._prefill_prefix(reqs, seqs, t0)
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
            self._model_params(), torch.from_numpy(toks).to(self.device),
            self._cfg, tp_axis=self._tp, lora_ids=self._lora_ids(reqs, bsz),
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
        dest, src_row, src_page = self._scatter_args(dest, src_row, src_page)
        llama.write_prefill_to_pages(
            self.k_pages, self.v_pages, (ks, vs), dest, src_row, src_page,
            self.page_size, k_scales=self.k_scales, v_scales=self.v_scales)
        if self.spec:
            # the draft mirrors the target's context in its own pools, on
            # the same page ids
            _, ks_d, vs_d = llama.prefill(
                self.draft_params, torch.from_numpy(toks).to(self.device),
                self._draft_cfg, tp_axis=self._tp,
                logit_rows=torch.from_numpy(last).to(self.device))
            llama.write_prefill_to_pages(
                self.k_pages_d, self.v_pages_d, (ks_d, vs_d), dest, src_row,
                src_page, self.page_size, k_scales=self.k_scales_d,
                v_scales=self.v_scales_d)
        self._finish_prefill(reqs, logits, t0)

    def _finish_prefill(self, reqs: list[Request], logits, t0) -> None:
        """Sample each request's next token from its row of ``logits`` and
        count the dispatch. Under speculation a re-admitted request keeps
        its last output as the next token to feed: a spec step emitted it
        and the prefill just wrote its K/V, so the completion resumes
        exactly (the spec draws are keyed by output position)."""
        for i, (req, tok) in enumerate(zip(reqs, self._sample_batch(reqs, logits))):
            if self.spec and req.output:
                continue
            self._append_token(req, i, tok)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_time"] += time.perf_counter() - t0

    def _prefill_prefix(self, reqs: list[Request], seqs, t0) -> None:
        """Prefill with prefix-cache reuse: one ``prefill_chunk`` over each
        row's uncached suffix (``done`` = its adopted tokens, page-aligned),
        attending to [cached prefix pages || suffix], then the suffix's
        whole pages scattered into the cache. Each prompt's full pages are
        then registered, so later requests sharing the prefix adopt them.
        Rows with no cache hit run here too (done = 0). The batch, the
        suffix bucket and the prefix table's width are padded to powers of
        two as in the JAX engine."""
        ps, dev = self.page_size, self.device
        n = len(reqs)
        bsz = _pow2(n)
        done = np.zeros((bsz,), np.int64)
        clen = np.zeros((bsz,), np.int64)
        for i, (r, s) in enumerate(zip(reqs, seqs)):
            done[i] = r.cached_tokens   # page-aligned, <= context - 1
            clen[i] = len(s) - r.cached_tokens
        c = max(32, _pow2(int(clen.max())))
        toks = np.zeros((bsz, c), np.int64)
        for i, s in enumerate(seqs):
            toks[i, : clen[i]] = s[done[i]:]
        npp = _pow2(int(done.max()) // ps) if done.max() > 0 else 1
        tables = np.full((bsz, npp), self.trash_page, np.int64)
        for i, r in enumerate(reqs):
            row = np.asarray(self.rt.seq_page_table(r.slot, npp, pad=-1))
            tables[i] = np.where(row < 0, self.trash_page, row)
        args = (torch.from_numpy(toks).to(dev), torch.from_numpy(done).to(dev),
                torch.from_numpy(clen).to(dev))
        tables = torch.from_numpy(tables).to(dev)
        last = torch.from_numpy(np.maximum(clen - 1, 0)).to(dev)
        logits, ks, vs = llama.prefill_chunk(
            self._model_params(), *args, self.k_pages, self.v_pages,
            self.k_scales, self.v_scales, tables, self._cfg, self._tp,
            self._lora_ids(reqs, bsz), logit_rows=last)
        # chunk-local page j of row i lands at the row's page done // ps + j
        dest, src_row, src_page = [], [], []
        for i, r in enumerate(reqs):
            p0 = int(done[i]) // ps
            n_pages = -(-int(clen[i]) // ps)
            row = self.rt.seq_page_table(r.slot, p0 + n_pages, pad=-1)
            for j in range(n_pages):
                if row[p0 + j] < 0:
                    continue
                dest.append(row[p0 + j])
                src_row.append(i)
                src_page.append(j)
            self.stats["prefill_tokens"] += int(clen[i])
        dest, src_row, src_page = self._scatter_args(dest, src_row, src_page)
        llama.write_prefill_to_pages(
            self.k_pages, self.v_pages, (ks, vs), dest, src_row, src_page, ps,
            k_scales=self.k_scales, v_scales=self.v_scales)
        if self.spec:
            # adopted pages hold the draft's prefix K/V too (written when
            # the prefix was first prefilled): the draft skips the same
            # cached tokens
            _, ks_d, vs_d = llama.prefill_chunk(
                self.draft_params, *args, self.k_pages_d, self.v_pages_d,
                self.k_scales_d, self.v_scales_d, tables, self._draft_cfg,
                self._tp, logit_rows=last)
            llama.write_prefill_to_pages(
                self.k_pages_d, self.v_pages_d, (ks_d, vs_d), dest, src_row,
                src_page, ps, k_scales=self.k_scales_d,
                v_scales=self.v_scales_d)
        # register the prompts' full pages, now written; a re-admitted
        # request's pages are usually there already
        for r in reqs:
            full = len(r.prompt) // ps
            if full:
                self.prefix.register(
                    r.prompt, self.rt.seq_page_table(r.slot, full, pad=-1),
                    salt=r.lora_id)
        self._finish_prefill(reqs, logits, t0)

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
        params, ids = self._model_params(), self._lora_ids(reqs, bsz)
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
                params, torch.from_numpy(toks[:, base:base + cs]).to(dev),
                torch.from_numpy(done).to(dev), torch.from_numpy(clen).to(dev),
                self.k_pages, self.v_pages, self.k_scales, self.v_scales,
                torch.from_numpy(tables).to(dev), self._cfg, self._tp, ids,
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
                llama.write_prefill_to_pages(
                    self.k_pages, self.v_pages, (ks, vs),
                    *self._scatter_args(dest, src_row, src_page), ps,
                    k_scales=self.k_scales, v_scales=self.v_scales)
            # rows whose last context token falls in this chunk take its
            # logits
            here = torch.from_numpy((last >= base) & (last < base + clen))
            final = logits if final is None else torch.where(
                here.to(dev)[:, None], logits, final)
            self.stats["prefill_chunks"] = self.stats.get("prefill_chunks",
                                                          0) + 1
        self.stats["prefill_tokens"] += int(lens[:n].sum())
        self._finish_prefill(reqs, final, t0)

    # --------------------------------------------------------------- decode
    def _block_inputs(self, reqs: list[Request], ahead: int, what: str):
        """The device inputs of a decode or a spec step: per row
        the fed token (output[-1]), the committed length including it, and
        the page table; padded to a power of two with length-1 rows on the
        trash page. ``ahead`` slots past the frontier must fit the table."""
        ps = self.page_size
        bsz = _pow2(len(reqs))
        tok = np.zeros((bsz,), np.int64)
        lens = np.ones((bsz,), np.int32)
        tables = np.full((bsz, self.pages_per_seq), self.trash_page, np.int32)
        for i, r in enumerate(reqs):
            c_len = r.context_len
            if c_len + ahead > self.pages_per_seq * ps:
                raise RuntimeError(
                    f"request {r.uid}: context {c_len} + {what} exceeds the "
                    f"page-table width {self.pages_per_seq} x page_size {ps}")
            tok[i] = r.output[-1]
            lens[i] = c_len
            tables[i] = self.rt.seq_page_table(r.slot, self.pages_per_seq,
                                               pad=self.trash_page)
        return tok, lens, tables

    def _commit(self, reqs: list[Request], toks, lps, n_emit) -> list[int]:
        """Append row i's first ``n_emit[i]`` tokens (and logprobs) to each
        request, stopping where it is done (eos, stop ids, max_new_tokens),
        and shrink its reservation to the committed frontier: the cache
        holds K/V through the token before the next fed one. Returns the
        tokens appended to each request."""
        used = []
        for i, r in enumerate(reqs):
            u = 0
            while u < n_emit[i] and not r.done:
                r.output.append(int(toks[i][u]))
                if r.logprobs and lps is not None:
                    r.token_logprobs.append(float(lps[i][u]))
                u += 1
            used.append(u)
            self.rt.seq_truncate(r.slot, r.context_len - 1)
        return used

    def _decode_batch(self, reqs: list[Request]) -> None:
        """One decode step of the engine: ``decode_block`` model decode
        steps (1 by default) through ``multistep.decode_rollout`` and ONE
        readback of the (b, k) tokens (and their logprobs, when a request
        asks). Each request arrives with ``seq_length == context_len +
        decode_block - 1`` (the step() grow loop): fed token j writes at
        position context_len - 1 + j."""
        t0 = time.perf_counter()
        k = self.decode_block
        if self.window is not None:
            # release the pages the window moved past at the block's first
            # length: never early
            for r in reqs:
                self.rt.seq_release_prefix(r.slot,
                                           self.live_from_page(r.context_len))
        tok, lens, tables = self._block_inputs(reqs, k - 1,
                                               f"decode_block {k} - 1")
        bsz, dev = tok.shape[0], self.device
        pad = bsz - len(reqs)
        want_lps = any(r.logprobs for r in reqs)
        args = (self._model_params(), self.k_pages, self.v_pages,
                self.k_scales, self.v_scales, torch.from_numpy(tok).to(dev),
                torch.from_numpy(lens).to(dev),
                torch.from_numpy(tables).to(dev),
                [r.temperature for r in reqs] + [0.0] * pad,
                [r.top_k for r in reqs] + [0] * pad,
                [r.top_p for r in reqs] + [1.0] * pad,
                [r.seed for r in reqs] + [0] * pad,
                [len(r.output) for r in reqs] + [0] * pad)
        need_filters = any(r.temperature > 0.0 and (r.top_k > 0
                                                    or r.top_p < 1.0)
                           for r in reqs)
        toks, lps, *_ = multistep.decode_rollout(
            *args, self._lora_ids(reqs, bsz), self._cfg, k, need_filters,
            want_lps, tp_axis=self._tp)
        if want_lps:  # token ids are exact in fp32 (vocab < 2^24)
            toks, lps = torch.stack([toks.float(), lps]).tolist()
        else:
            toks, lps = toks.tolist(), None
        used = self._commit(reqs, toks, lps, [k] * len(reqs))
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += sum(used)
        self.stats["decode_time"] += time.perf_counter() - t0

    def _spec_decode_batch(self, reqs: list[Request]) -> None:
        """One speculative step: the draft's rollout, the target's
        verification of [fed token || n_draft proposals] in one
        ``prefill_chunk``, the token-granular commit of the chunk's K/V
        (``llama.write_chunk_to_pages``; rejected positions land in the
        row's reserved slots) and ``sampling.spec_accept``, with ONE
        readback. Appends 1..n_draft+1 tokens per request and shrinks its
        reservation to the committed frontier. Each request arrives with
        ``seq_length == context_len + n_draft`` (the step() grow loop)."""
        t0 = time.perf_counter()
        g, ps, dev = self.n_draft, self.page_size, self.device
        n = len(reqs)
        tok, lens, tables = self._block_inputs(reqs, g, f"n_draft {g}")
        pad = tok.shape[0] - n
        temps = [r.temperature for r in reqs] + [0.0] * pad
        seeds = [r.seed for r in reqs] + [0] * pad
        pos = [len(r.output) for r in reqs] + [0] * pad
        tok_d, lens_d = torch.from_numpy(tok).to(dev), \
            torch.from_numpy(lens).to(dev)
        tables_d = torch.from_numpy(tables).to(dev)
        rollout_args = (self.draft_params, self.k_pages_d, self.v_pages_d,
                        self.k_scales_d, self.v_scales_d, tok_d, lens_d,
                        tables_d, temps, seeds, pos)
        d_toks, d_logits, *_ = spec_mod.draft_rollout(
            *rollout_args, self._draft_cfg, g, tp_axis=self._tp)
        # the prefix table's width rounds up to a power of two (trash
        # padded, masked off by done), as in the JAX engine
        npp = _pow2(-(-int(lens.max() - 1) // ps)) if lens.max() > 1 else 1
        ptab = np.full((tables.shape[0], npp), self.trash_page, np.int32)
        w = min(npp, self.pages_per_seq)
        ptab[:, :w] = tables[:, :w]
        chunk = torch.cat([tok_d[:, None], d_toks], dim=1)
        clen = torch.full((tok.shape[0],), g + 1, device=dev)
        logits, ks, vs = llama.prefill_chunk(
            self.params, chunk, lens_d - 1, clen, self.k_pages, self.v_pages,
            self.k_scales, self.v_scales, torch.from_numpy(ptab).to(dev),
            self._cfg, self._tp)
        llama.write_chunk_to_pages(self.k_pages, self.v_pages, (ks, vs),
                                   lens_d - 1, clen, tables_d, self.k_scales,
                                   self.v_scales)
        out, n_emit = sampling.spec_accept(logits, d_logits, d_toks, temps,
                                           seeds, pos)
        c = g + 1
        want_lps = any(r.logprobs for r in reqs)
        if want_lps:
            # the raw target logprob of every emitted token, off the
            # verification logits; one readback (ids exact in fp32)
            lps = torch.log_softmax(logits, dim=-1).gather(
                -1, out[..., None])[..., 0]
            host = torch.cat([out.float(), n_emit[:, None].float(), lps],
                             dim=1).tolist()
        else:
            host = torch.cat([out, n_emit[:, None]], dim=1).tolist()
        used = self._commit(reqs, [h[:c] for h in host],
                            [h[c + 1:] for h in host] if want_lps else None,
                            [int(h[c]) for h in host])
        self.stats["spec_accepted"] += sum(max(u - 1, 0) for u in used)
        self.stats["decode_tokens"] += sum(used)
        self.stats["spec_steps"] += 1
        self.stats["spec_proposed"] += g * n
        self.stats["decode_steps"] += 1
        self.stats["decode_time"] += time.perf_counter() - t0

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

        # reserve through the step's last write: the fed token and n_draft
        # proposals (spec), or decode_block - 1 slots past the fed token; a
        # fresh admission grows once more than a re-admitted spec request,
        # whose fed token's K/V the prefill wrote
        ahead = self.n_draft if self.spec else self.decode_block - 1
        run = self._spec_decode_batch if self.spec else self._decode_batch
        batch = []
        for req in list(self.sched.running):
            if req.slot < 0:
                continue  # preempted by an earlier grow() in this snapshot
            # grow() fails only by preempting req itself (slot -1)
            while (req.slot >= 0 and self.rt.seq_length(req.slot)
                   < req.context_len + ahead):
                self.sched.grow(req)
            if req.slot >= 0:
                batch.append(req)
        batch = [r for r in batch if r.slot >= 0]  # late preemptions
        if batch:
            try:
                run(batch)
            except Exception as e:  # noqa: BLE001 — surfaced on the requests
                tb = traceback.format_exc()
                what = "spec decode" if self.spec else "decode"
                for req in batch:
                    self.sched.fail(req, f"{what} failed: {e!r}\n{tb}")
                finished.extend(batch)
                return finished
            for req in batch:
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
