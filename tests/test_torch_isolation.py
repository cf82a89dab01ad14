"""The port stands alone: no module of ``flash_attention_tpu_torch``, not
``chip_smoke.py`` and not the port's tools (the A/B tools ``tools/ab_*.py``,
``tools/sass_diff.py`` and the probes ``tools/probe_*.py``) import JAX or the JAX package, and CPU
calls never launch (or count) a CUDA kernel."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch import (Engine, bwd, fwd, paged_attention,
                                       quantize_int4, quantized_matmul,
                                       write_token_kv)
from flash_attention_tpu_torch.models import checkpoint, llama
from flash_attention_tpu_torch.ops import flash_bwd, flash_fwd, kv_update, moe
from flash_attention_tpu_torch.ops import quant
from flash_attention_tpu_torch.ops import paged_attention as pa_mod

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "flash_attention_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "sass_diff.py"] + \
    sorted((ROOT / "tools").glob("ab_*.py")) + \
    sorted((ROOT / "tools").glob("probe_*.py"))
FORBIDDEN = ("jax", "jaxlib", "flash_attention_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"engine.py", "llama.py", "attention.py", "chip_smoke.py",
            "quant.py", "checkpoint.py", "ab_flash_fwd.py", "ab_flash_bwd.py",
            "ab_qmm.py", "ab_gmm.py", "ab_paged.py", "probe_gmm_dw.py",
            "sass_diff.py", "options.py"} <= names


def test_cpu_calls_launch_no_kernel(tmp_path):
    kernels = (flash_fwd.KERNEL, kv_update.KERNEL, pa_mod.KERNEL,
               *flash_bwd.KERNELS, *moe.KERNELS, quant.KERNEL)
    for k in kernels:
        k.launches = 0
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 64), dtype=np.float32))
    o, lse = fwd(q, q, q, True)
    bwd(q, q, q, o, lse, q, True)
    kp = torch.zeros((2, 1, 4, 16, 64))
    lens = torch.tensor([3], dtype=torch.int32)
    write_token_kv(kp, kp.clone(), None, None, q[:, 0, :1], q[:, 0, :1], None,
                   None, lens, lens, layer=1)
    paged_attention(q[:, 0], kp, kp, lens, torch.tensor([[0, 1]],
                                                        dtype=torch.int32),
                    layer=1)
    cfg = llama.LlamaConfig.tiny(n_layers=1, vocab_size=64, dim=128,
                                 hidden_dim=256)
    eng = Engine(cfg, llama.init_params(cfg, device="cpu",
                                        dtype=torch.float32),
                 total_pages=16, page_size=16, max_batch=2, max_seq_len=64)
    req = eng.add_request([1, 2, 3], max_new_tokens=3)
    eng.run()
    assert req.error is None and len(req.output) == 3
    params = llama.init_params(cfg, device="cpu", dtype=torch.float32)
    for p in params.values():
        p.requires_grad_()
    toks = torch.tensor([[1, 2, 3, 4]])
    llama.train_loss(params, toks, toks.roll(-1, 1), cfg).backward()
    assert all(p.grad is not None for p in params.values())
    moe_cfg = llama.LlamaConfig.tiny_moe(n_layers=1, vocab_size=64, dim=128,
                                         hidden_dim=256)
    params = llama.init_params(moe_cfg, device="cpu", dtype=torch.float32)
    for p in params.values():
        p.requires_grad_()
    llama.train_loss(params, toks, toks.roll(-1, 1), moe_cfg).backward()
    assert all(p.grad is not None for p in params.values())
    # weight-only quantized serving, and its checkpoint
    quantized_matmul(q[0, :, 0], quantize_int4(torch.ones((64, 16))))
    qparams = llama.quantize_params(llama.init_params(cfg, device="cpu"),
                                    bits=8)
    checkpoint.save_checkpoint(str(tmp_path / "q.npz"), qparams)
    qparams = checkpoint.load_checkpoint(str(tmp_path / "q.npz"),
                                         device="cpu")
    eng = Engine(cfg, qparams, total_pages=16, page_size=16, max_batch=2,
                 max_seq_len=64)
    req = eng.add_request([1, 2, 3], max_new_tokens=3)
    eng.run()
    assert req.error is None and len(req.output) == 3
    assert [k.launches for k in kernels] == [0] * 9
