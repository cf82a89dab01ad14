"""The port's HF import against the JAX package's and against transformers.

The six tiny randomly initialised ``transformers`` models of
``tests/test_hf_import.py`` (Llama, Mistral with its window, Gemma-2 with
every one of its extras, Llama-3.1's RoPE remap, Qwen-2 with random QKV
biases, Mixtral's experts; nothing is downloaded), each imported by
``models.import_hf`` on the CPU in fp32: its config equals the JAX
import's field by field, every tensor equals the JAX import's exactly, and
the port's plain prefill logits match transformers' at rtol/atol 2e-3.
The tied lm_head is a copy, not a view of the embedding, and the module
imports no ``transformers``.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from flash_attention_tpu.models import import_hf as jimport
from flash_attention_tpu_torch.models import import_hf, llama

torch.set_num_threads(2)

COMMON = dict(vocab_size=128, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=512,
              tie_word_embeddings=False)


def _llama():
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **COMMON, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False))


def _mistral():
    # window 16 < the prompt, so the window mask is live in HF too
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        **COMMON, rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=16))


def _gemma2():
    # alternating sliding/global layers, (1 + w) norms, sandwich norms,
    # GeGLU-tanh, both softcaps, query_pre_attn_scalar, the embed scale and
    # tied embeddings; eager attention (SDPA drops the attention softcap)
    return transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        vocab_size=128, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=128, max_position_embeddings=512, rms_norm_eps=1e-6,
        rope_theta=10000.0, sliding_window=16, query_pre_attn_scalar=128,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        attn_implementation="eager"))


def _llama31():
    # original_max_position_embeddings 16 puts all three remap bands in use
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **COMMON, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 16}))


def _qwen2():
    model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **COMMON, rms_norm_eps=1e-6, rope_theta=1e6, sliding_window=None))
    # HF zero-initialises the QKV biases: random ones put the bias path in
    # use
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("proj.bias"):
                p.normal_(0.0, 0.5)
    return model


def _mixtral():
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **COMMON, num_local_experts=4, num_experts_per_tok=2,
        rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=None))


# name -> (builder, torch seed, prompt length)
MODELS = {"llama": (_llama, 0, 33), "mistral": (_mistral, 1, 33),
          "gemma2": (_gemma2, 2, 33), "llama31": (_llama31, 2, 49),
          "qwen2": (_qwen2, 5, 37), "mixtral": (_mixtral, 3, 33)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def imported(request):
    """(name, HF model, port params, port cfg, JAX params, JAX cfg)."""
    build, seed, _ = MODELS[request.param]
    torch.manual_seed(seed)
    model = build().eval()
    params, cfg = import_hf.from_hf(model, dtype=torch.float32, device="cpu")
    jcfg = jimport.config_from_hf(model.config)
    jparams = jimport.from_hf_state_dict(model.state_dict(), jcfg,
                                         dtype=jnp.float32)
    return request.param, model, params, cfg, jparams, jcfg


def test_config_matches_jax(imported):
    name, _, _, cfg, _, jcfg = imported
    assert isinstance(cfg, llama.LlamaConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    expect = {"gemma2": dict(window_pattern=2, post_norms=True),
              "mistral": dict(sliding_window=16, window_pattern=1),
              "llama31": dict(rope_scaling=(8.0, 1.0, 4.0, 16)),
              "qwen2": dict(attn_bias=True),
              "mixtral": dict(n_experts=4, n_experts_per_tok=2)}
    for field, value in expect.get(name, {}).items():
        assert getattr(cfg, field) == value, field


def test_params_equal_jax_import(imported):
    """Every tensor, fp32, bit for bit."""
    _, _, params, _, jparams, _ = imported
    assert sorted(params) == sorted(jparams)
    for k, v in params.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu", k
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]),
                                      err_msg=k)


def test_prefill_logits_match_transformers(imported):
    name, model, params, cfg, _, _ = imported
    toks = np.random.default_rng(3).integers(0, 128, (2, MODELS[name][2]))
    with torch.no_grad():
        want = model(torch.from_numpy(toks)).logits.numpy()
        got, _, _ = llama.prefill(params, torch.from_numpy(toks), cfg,
                                  return_kv=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_tied_lm_head_is_a_copy():
    """A state dict without lm_head.weight ties it to the embedding, as
    JAX's import does, but as its own contiguous tensor: writing to one
    leaves the other as it was."""
    torch.manual_seed(0)
    model = _llama().eval()
    sd = dict(model.state_dict())
    del sd["lm_head.weight"]
    cfg = import_hf.config_from_hf(model.config)
    params = import_hf.from_hf_state_dict(sd, cfg, dtype=torch.float32,
                                          device="cpu")
    want = jimport.from_hf_state_dict(sd, jimport.config_from_hf(
        model.config), dtype=jnp.float32)
    head, embed = params["lm_head"], params["embed"]
    np.testing.assert_array_equal(head.numpy(), np.asarray(want["lm_head"]))
    assert head.is_contiguous() and head.shape == (cfg.dim, cfg.vocab_size)
    assert head.untyped_storage().data_ptr() != \
        embed.untyped_storage().data_ptr()
    before = embed.clone()
    head.sub_(1.0)
    assert torch.equal(embed, before)


def test_bf16_import_rounds_once():
    """In bf16 each weight is the fp32 source rounded once (the JAX
    import's result too), the Gemma norms shifted by 1 in fp32 first."""
    torch.manual_seed(2)
    model = _gemma2().eval()
    params, cfg = import_hf.from_hf(model, device="cpu")
    jcfg = jimport.config_from_hf(model.config)
    want = jimport.from_hf_state_dict(model.state_dict(), jcfg)
    for k, v in params.items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(want[k], np.float32),
                                      err_msg=k)


def test_module_imports_no_transformers():
    src = pathlib.Path(import_hf.__file__)
    tree = ast.parse(src.read_text(), filename=str(src))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "transformers" not in names and "jax" not in names, names
