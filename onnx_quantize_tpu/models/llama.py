"""Llama/Qwen-family causal LMs on the shared decoder.

The reference quantizes any ONNX model with MatMul/Gemm sites — it is not
Gemma-specific — so this framework's model zoo should not be either. The
Llama architecture is the Gemma-3 decoder with a handful of conventions
flipped (no QK-norm, pre-norm only, SiLU MLP, unscaled embeddings, plain-w
RMSNorm, single rope theta with optional llama3 frequency scaling, no
sliding window): :func:`llama_config` expresses those as
``Gemma3Config`` variant switches, so the ENTIRE stack — quantizer, Pallas
kernels, engine (int8 KV, serve rounds), fusion, TP localization — serves
Llama models with zero new execution code.

``load_llama_hf`` maps ``LlamaForCausalLM`` safetensors onto the param tree
(verified against transformers' implementation on random-init checkpoints,
``tests/models/test_llama.py``).
"""

from __future__ import annotations

import jax.numpy as jnp

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu.models.import_hf import _read_safetensors

logger = get_logger(__name__)

__all__ = [
    "llama_config", "Llama", "LLAMA32_1B", "LLAMA32_3B", "QWEN25_05B",
    "load_llama_hf",
]

# The decoder class is shared; the config carries the family differences.
Llama = Gemma3


def llama_config(
    *,
    vocab_size: int,
    hidden_size: int,
    intermediate_size: int,
    num_layers: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int | None = None,
    rope_theta: float = 500_000.0,
    rope_scaling: tuple | None = None,
    rms_norm_eps: float = 1e-5,
    tie_lm_head: bool = True,
    attn_bias: bool = False,
    dtype: str = "float32",
) -> Gemma3Config:
    """A Gemma3Config expressing Llama conventions (see module docstring).

    ``attn_bias=True`` adds q/k/v projection biases (the Qwen-2 convention;
    those sites become "Gemm" sites for the quantizer, exercising the
    reference's bias-quantization path on a real family).
    """
    head_dim = head_dim or hidden_size // num_heads
    return Gemma3Config(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        intermediate_size=intermediate_size,
        num_layers=num_layers,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        rope_theta=rope_theta,
        rope_local_base=rope_theta,  # unused: every layer is global
        sliding_window=0,
        sliding_pattern=1,  # (i+1) % 1 == 0 -> all layers global attention
        rms_norm_eps=rms_norm_eps,
        query_pre_attn_scalar=float(head_dim),  # 1/sqrt(head_dim)
        use_qk_norm=False,
        sandwich_norms=False,
        mlp_activation="silu",
        scale_embeddings=False,
        rms_one_plus=False,
        tie_lm_head=tie_lm_head,
        rope_scaling=rope_scaling,
        attn_bias=attn_bias,
        dtype=dtype,
    )


# Llama-3.2 text configs (HF ``config.json`` values). Both tie lm_head to
# the embedding and use llama3 rope scaling (factor 32, low 1, high 4,
# original context 8192).
LLAMA32_1B = llama_config(
    vocab_size=128_256, hidden_size=2048, intermediate_size=8192,
    num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
    rope_scaling=(32.0, 1.0, 4.0, 8192),
)

LLAMA32_3B = llama_config(
    vocab_size=128_256, hidden_size=3072, intermediate_size=8192,
    num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
    rope_scaling=(32.0, 1.0, 4.0, 8192),
)

# Qwen-2.5-0.5B (HF config.json): GQA with q/k/v biases, theta 1e6, tied head.
QWEN25_05B = llama_config(
    vocab_size=151_936, hidden_size=896, intermediate_size=4864,
    num_layers=24, num_heads=14, num_kv_heads=2, head_dim=64,
    rope_theta=1_000_000.0, rms_norm_eps=1e-6, attn_bias=True,
)


def tiny_llama_config(**kw) -> Gemma3Config:
    """Scaled-down Llama-convention config for tests."""
    base = dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10_000.0,
    )
    base.update(kw)
    return llama_config(**base)


def load_llama_hf(model, directory: str, dtype=jnp.float32) -> dict:
    """Build the framework param tree from a local HF Llama checkpoint dir."""
    import numpy as np

    hf = _read_safetensors(directory)

    def get(name: str) -> np.ndarray:
        for candidate in (name, f"model.{name}", name.replace("model.", "")):
            if candidate in hf:
                return np.asarray(hf[candidate])
        raise KeyError(f"HF tensor {name!r} not found; have e.g. {list(hf)[:5]}")

    def proj(name: str):
        return jnp.asarray(get(name).T, dtype=dtype)  # (out,in) -> (in,out)

    cfg = model.cfg
    params: dict = {
        "embed": {"w": jnp.asarray(get("model.embed_tokens.weight"), dtype=dtype)},
        "final_norm": {"w": jnp.asarray(get("model.norm.weight"), dtype=dtype)},
    }
    def site(name: str, bias: bool):
        entry = {"w": proj(f"{name}.weight")}
        if bias:
            entry["b"] = jnp.asarray(get(f"{name}.bias"), dtype=dtype)
        return entry

    ab = cfg.attn_bias
    for i in range(cfg.num_layers):
        prefix = f"model.layers.{i}"
        params[f"layers.{i}"] = {
            "attn": {
                "q_proj": site(f"{prefix}.self_attn.q_proj", ab),
                "k_proj": site(f"{prefix}.self_attn.k_proj", ab),
                "v_proj": site(f"{prefix}.self_attn.v_proj", ab),
                "o_proj": {"w": proj(f"{prefix}.self_attn.o_proj.weight")},
            },
            "mlp": {
                "gate_proj": {"w": proj(f"{prefix}.mlp.gate_proj.weight")},
                "up_proj": {"w": proj(f"{prefix}.mlp.up_proj.weight")},
                "down_proj": {"w": proj(f"{prefix}.mlp.down_proj.weight")},
            },
            "input_norm": {
                "w": jnp.asarray(get(f"{prefix}.input_layernorm.weight"), dtype=dtype)
            },
            "pre_ffn_norm": {
                "w": jnp.asarray(
                    get(f"{prefix}.post_attention_layernorm.weight"), dtype=dtype
                )
            },
        }

    if any(k.startswith("lm_head") for k in hf):
        params["lm_head"] = {"w": proj("lm_head.weight")}
    else:
        params["lm_head"] = {"w": params["embed"]["w"].T}
        logger.info("lm_head tied to embedding (no separate HF tensor)")
    return params
