"""Mixture-of-Experts causal LMs on the shared decoder (Mixtral / Qwen-MoE).

The reference quantizes any ONNX model's MatMul/Gemm sites — MoE models are
simply models with E× more of them (per-expert gate/up/down projections plus
a tiny router). This module expresses the two public MoE families as
``Gemma3Config`` variant switches (``num_experts`` and friends), so the
ENTIRE stack — planner, calibration taps, RTN/GPTQ/HQQ/AWQ/SmoothQuant,
Pallas W4/W8 kernels, engine (int8 KV, serve rounds), fusion — serves MoE
models with zero new execution code. See ``Gemma3MoEMLP`` (models/gemma3.py)
for the dense-masked routing scheme and why it is decode-bandwidth-optimal.

Engine layout: :func:`stack_moe_experts` converts per-expert subtrees into
stacked site dicts (leading axis = expert). Stacking is applied at engine
load AFTER ``fuse_gemma3_projections`` / ``prepare_kernel_scales`` and is
what makes expert parallelism a plain ``PartitionSpec``: the leading axis
shards over the mesh's model axis and ONE psum combines the expert outputs
(``Gemma3.tp_localize`` emits the rules when ``num_experts > 0``).
"""

from __future__ import annotations

import numpy as np

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu.models.import_hf import _read_safetensors
from onnx_quantize_tpu.models.llama import llama_config
from onnx_quantize_tpu.nn.qtensor import QTensor

logger = get_logger(__name__)

__all__ = [
    "moe_config", "MoE", "tiny_moe_config", "stack_moe_experts",
    "fuse_moe_experts",
    "QWEN15_MOE_A27B", "MIXTRAL_8X7B", "load_qwen_moe_hf", "load_mixtral_hf",
]

# The decoder class is shared; the config carries the MoE structure.
MoE = Gemma3


def moe_config(
    *,
    num_experts: int,
    num_experts_per_tok: int,
    moe_intermediate_size: int,
    shared_expert_size: int = 0,
    norm_topk_prob: bool = True,
    **llama_kwargs,
) -> Gemma3Config:
    """A Llama-convention decoder config with an MoE MLP."""
    import dataclasses

    base = llama_config(**llama_kwargs)
    return dataclasses.replace(
        base,
        num_experts=num_experts,
        num_experts_per_tok=num_experts_per_tok,
        moe_intermediate_size=moe_intermediate_size,
        shared_expert_size=shared_expert_size,
        norm_topk_prob=norm_topk_prob,
    )


# Qwen1.5-MoE-A2.7B (HF config.json): 60 experts, top-4, no top-k renorm,
# sigmoid-gated shared expert, GQA-free attention with q/k/v biases.
QWEN15_MOE_A27B = moe_config(
    num_experts=60, num_experts_per_tok=4, moe_intermediate_size=1408,
    shared_expert_size=5632, norm_topk_prob=False,
    vocab_size=151_936, hidden_size=2048, intermediate_size=5632,
    num_layers=24, num_heads=16, num_kv_heads=16, head_dim=128,
    rope_theta=1_000_000.0, rms_norm_eps=1e-6, attn_bias=True,
    tie_lm_head=False,
)

# Mixtral-8x7B (HF config.json): 8 experts, top-2 with renormalization.
MIXTRAL_8X7B = moe_config(
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=14336,
    shared_expert_size=0, norm_topk_prob=True,
    vocab_size=32_000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    rope_theta=1_000_000.0, rms_norm_eps=1e-5, tie_lm_head=False,
)


def tiny_moe_config(**kw) -> Gemma3Config:
    """Scaled-down MoE config for tests."""
    base = dict(
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=96,
        shared_expert_size=0, norm_topk_prob=True,
        vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10_000.0,
    )
    base.update(kw)
    return moe_config(**base)


# ── engine layout: expert stacking ──────────────────────────────────────────

def _stack_leaves(leaves: list):
    """Stack one site-key position across experts (None stays None)."""
    if all(v is None for v in leaves):
        return None
    if any(v is None for v in leaves):
        raise ValueError("experts disagree on which qparams are present")
    return np.stack([np.asarray(v) for v in leaves])


def _stack_sites(sites: list[dict]) -> dict:
    """Stack per-expert Linear-site param dicts along a new leading axis."""
    keys = set(sites[0])
    for s in sites[1:]:
        if set(s) != keys:
            raise ValueError(f"experts disagree on site keys: {set(s)} vs {keys}")
    if "b" in keys:
        raise ValueError("stacked MoE experts do not support biased projections")
    out: dict = {}
    for key in keys:
        leaves = [s[key] for s in sites]
        if isinstance(leaves[0], QTensor):
            meta = leaves[0].meta
            for qt in leaves[1:]:
                if not isinstance(qt, QTensor) or qt.meta != meta:
                    raise ValueError(
                        "experts must be quantized identically to stack "
                        f"(site {key!r} differs)"
                    )
            children = [qt.tree_flatten()[0] for qt in leaves]
            stacked = tuple(
                _stack_leaves([ch[i] for ch in children])
                for i in range(len(children[0]))
            )
            out[key] = QTensor.tree_unflatten(meta, stacked)
        elif any(isinstance(v, QTensor) for v in leaves):
            raise ValueError(f"experts mix quantized and fp weights at {key!r}")
        else:
            out[key] = _stack_leaves(leaves)
    return out


def stack_moe_experts(params: dict) -> dict:
    """Engine-load transform: per-expert subtrees -> stacked site dicts.

    Apply AFTER quantization, ``fuse_gemma3_projections`` and (for packed
    weights on the single-chip path) ``engine.prepare_kernel_scales`` — the
    scale-baking prep skips leaves whose data already carries the leading
    expert axis. Returns a new params tree; the original is left untouched.
    """
    from onnx_quantize_tpu.utils import copy_tree

    params = copy_tree(params)
    site_map = {
        "gate_up": "_fused_gate_up",
        "gate": "gate_proj",
        "up": "up_proj",
        "down": "down_proj",
    }
    for layer in params.values():
        if not (isinstance(layer, dict) and "attn" in layer):
            continue
        mlp = layer.get("mlp")
        if not isinstance(mlp, dict):
            continue
        expert_keys = sorted(
            (k for k in mlp if k.startswith("experts.")),
            key=lambda s: int(s.split(".", 1)[1]),
        )
        if not expert_keys:
            continue
        subs = [mlp[k] for k in expert_keys]
        stacked = {}
        for out_key, in_key in site_map.items():
            if in_key in subs[0]:
                stacked[out_key] = _stack_sites([s[in_key] for s in subs])
        for k in expert_keys:
            del mlp[k]
        mlp["_stacked_experts"] = stacked
    return params


# ── engine layout: expert concatenation (the decode-fast layout) ────────────

def _concat_k_sites(sites: list[dict]) -> dict:
    """Concatenate per-expert down-projections along K (rows).

    Valid because the routing weight folds into each expert's activation
    BEFORE the matmul (``down`` is linear), so one deep-K matmul computes the
    weighted sum over experts inside its accumulator. GROUP-quantized only:
    group scales concatenate along the group axis; each expert's K must hold
    an even number of groups so the pair packing stays aligned.
    """
    import dataclasses

    leaves = [s["w"] for s in sites]
    if any(set(s) - {"w"} for s in sites):
        raise ValueError("K-concat sites must be bare weights (no bias/prescale)")
    if not isinstance(leaves[0], QTensor):
        if any(isinstance(w, QTensor) for w in leaves):
            raise ValueError("experts mix quantized and fp weights")
        return {"w": np.concatenate([np.asarray(w) for w in leaves], axis=0)}
    first = leaves[0]
    for qt in leaves[1:]:
        if not isinstance(qt, QTensor) or qt.meta != first.meta:
            raise ValueError("experts must be quantized identically to concat")
    if first.meta.strat.value != "group":
        raise ValueError(
            "expert K-concat requires GROUP strategy (channel/tensor scales "
            "cannot concatenate along K)"
        )
    # Output quant would apply to the COMBINED sum instead of each expert's
    # output (the loop path's semantics); dynamic input quant would compute
    # one amax over the concatenated row instead of per expert. Both change
    # numerics — reject so fuse_moe_experts falls back to the loop layout.
    if first.meta.output_quant.mode != "none":
        raise ValueError(
            "expert K-concat cannot apply per-expert output quantization to "
            "the combined accumulator"
        )
    if first.meta.input_quant.mode == "dynamic":
        raise ValueError(
            "expert K-concat would merge per-expert dynamic input "
            "quantization grids"
        )
    if first.meta.packed:
        gs = first.meta.pack_group
        K_e = first.meta.shape[0]
        if K_e % gs != 0 or (K_e // gs) % 2 != 0:
            raise ValueError(
                f"expert K={K_e} must be an even multiple of group_size={gs} "
                "for pair-aligned K-concat"
            )
    for attr in ("input_scale", "input_zero_point"):
        vals = [getattr(w, attr) for w in leaves]
        if any(v is not None for v in vals):
            arrs = [np.asarray(v) for v in vals]
            if any(not np.allclose(arrs[0], a) for a in arrs[1:]):
                raise ValueError(
                    "per-expert static input scales differ; K-concat would "
                    "merge their quantization grids"
                )

    def cat0(vals):
        if vals[0] is None:
            return None
        return np.concatenate([np.asarray(v) for v in vals], axis=0)

    K_total = sum(w.meta.shape[0] for w in leaves)
    meta = dataclasses.replace(first.meta, shape=(K_total, first.meta.shape[1]))
    return {"w": QTensor(
        data=cat0([w.data for w in leaves]),
        scale=cat0([w.scale for w in leaves]),
        zero_point=cat0([w.zero_point for w in leaves]),
        meta=meta,
        input_scale=first.input_scale,
        input_zero_point=first.input_zero_point,
        output_scale=None,
        output_zero_point=None,
    )}


def fuse_moe_experts(params: dict) -> dict:
    """Engine-load transform: concatenate ALL experts into TWO matmul sites.

    The dense-masked per-expert loop runs 2E small matmuls per layer; on
    decode shapes those are too small to stream weights at full bandwidth.
    Concatenation moves both ops into fat, bandwidth-friendly shapes with 2
    launches total:

      * ``gate_up``: per-expert fused [gate|up] blocks concatenate along N
        (all experts share the input) -> one fat-N matmul,
      * ``down``: expert blocks concatenate along K and the routing weight
        folds into each expert's activation segment -> one deep-K matmul
        whose accumulator performs the combine sum.

    Under expert parallelism this layout IS the Megatron column->row pair:
    the gate_up N-shard and down K-shard are expert-aligned, and the down
    psum is the cross-device combine.

    Requires ``fuse_gemma3_projections`` first (per-expert gate/up fused) and
    no per-expert prescales/biases; layers not meeting that keep their
    per-expert subtrees (the loop path). Apply after
    ``engine.prepare_kernel_scales`` on the single-chip path (concat keeps
    the baked layout).
    """
    from onnx_quantize_tpu.nn.fuse import fuse_sites
    from onnx_quantize_tpu.utils import copy_tree

    params = copy_tree(params)
    for name, layer in params.items():
        if not (isinstance(layer, dict) and "attn" in layer):
            continue
        mlp = layer.get("mlp")
        if not isinstance(mlp, dict):
            continue
        expert_keys = sorted(
            (k for k in mlp if k.startswith("experts.")),
            key=lambda s: int(s.split(".", 1)[1]),
        )
        if not expert_keys:
            continue
        subs = [mlp[k] for k in expert_keys]
        if any(set(s) != {"_fused_gate_up", "down_proj"} for s in subs):
            logger.debug(
                "%s: experts not in fused gate_up+down form; keeping the "
                "per-expert loop layout", name,
            )
            continue
        try:
            from onnx_quantize_tpu.nn.fuse import can_fuse

            gu_sites = [s["_fused_gate_up"] for s in subs]
            if not can_fuse(gu_sites):
                raise ValueError("per-expert gate_up sites not fuse-compatible")
            gu_w = gu_sites[0]["w"]
            if (
                isinstance(gu_w, QTensor)
                and gu_w.meta.output_quant.mode == "dynamic"
            ):
                # Dynamic output quant computes one amax per TENSOR — over
                # the expert concat it would merge per-expert grids.
                raise ValueError(
                    "per-expert dynamic output quantization cannot concat"
                )
            gate_up, _ = fuse_sites(gu_sites)
            down = _concat_k_sites([s["down_proj"] for s in subs])
        except ValueError as exc:
            logger.debug("%s: expert concat not applicable (%s)", name, exc)
            continue
        for k in expert_keys:
            del mlp[k]
        mlp["_fused_experts"] = {"gate_up": {"w": gate_up}, "down": down}
    return params


# ── HF checkpoint import ─────────────────────────────────────────────────────

def _decoder_common(get, proj, cfg, norm) -> dict:
    """Attention + norms shared by both MoE loaders (Llama-shaped)."""
    def site(name: str, bias: bool):
        entry = {"w": proj(f"{name}.weight")}
        if bias:
            entry["b"] = np.asarray(get(f"{name}.bias"), np.float32)
        return entry

    layers = {}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        layers[f"layers.{i}"] = {
            "attn": {
                "q_proj": site(f"{p}.self_attn.q_proj", cfg.attn_bias),
                "k_proj": site(f"{p}.self_attn.k_proj", cfg.attn_bias),
                "v_proj": site(f"{p}.self_attn.v_proj", cfg.attn_bias),
                "o_proj": {"w": proj(f"{p}.self_attn.o_proj.weight")},
            },
            "input_norm": norm(f"{p}.input_layernorm.weight"),
            "pre_ffn_norm": norm(f"{p}.post_attention_layernorm.weight"),
        }
    return layers


def _load_moe_hf(model, directory: str, mlp_fn) -> dict:
    """Shared loader skeleton; ``mlp_fn(prefix)`` builds one layer's MLP tree."""
    hf = _read_safetensors(directory)

    def get(name: str) -> np.ndarray:
        for candidate in (name, f"model.{name}", name.replace("model.", "")):
            if candidate in hf:
                return np.asarray(hf[candidate])
        raise KeyError(f"HF tensor {name!r} not found; have e.g. {list(hf)[:5]}")

    def proj(name: str) -> np.ndarray:
        return np.asarray(get(name).T, np.float32)  # (out,in) -> (in,out)

    def norm(name: str) -> dict:
        return {"w": np.asarray(get(name), np.float32)}

    cfg = model.cfg
    params: dict = {
        "embed": {"w": np.asarray(get("model.embed_tokens.weight"), np.float32)},
        "final_norm": norm("model.norm.weight"),
    }
    params.update(_decoder_common(get, proj, cfg, norm))
    for i in range(cfg.num_layers):
        params[f"layers.{i}"]["mlp"] = mlp_fn(f"model.layers.{i}", get, proj)
    if any(k.startswith("lm_head") for k in hf):
        params["lm_head"] = {"w": proj("lm_head.weight")}
    else:
        params["lm_head"] = {"w": params["embed"]["w"].T}
        logger.info("lm_head tied to embedding (no separate HF tensor)")
    return params


def load_qwen_moe_hf(model, directory: str) -> dict:
    """Param tree from a local HF Qwen-MoE checkpoint dir (Qwen1.5/2-MoE names:
    ``mlp.gate`` router, ``mlp.experts.{e}.*_proj``, sigmoid-gated
    ``mlp.shared_expert``)."""
    cfg = model.cfg

    def mlp_fn(prefix, get, proj):
        mlp = {"router": {"w": proj(f"{prefix}.mlp.gate.weight")}}
        for e in range(cfg.num_experts):
            ep = f"{prefix}.mlp.experts.{e}"
            mlp[f"experts.{e}"] = {
                "gate_proj": {"w": proj(f"{ep}.gate_proj.weight")},
                "up_proj": {"w": proj(f"{ep}.up_proj.weight")},
                "down_proj": {"w": proj(f"{ep}.down_proj.weight")},
            }
        if cfg.shared_expert_size:
            sp = f"{prefix}.mlp.shared_expert"
            mlp["shared"] = {
                "gate_proj": {"w": proj(f"{sp}.gate_proj.weight")},
                "up_proj": {"w": proj(f"{sp}.up_proj.weight")},
                "down_proj": {"w": proj(f"{sp}.down_proj.weight")},
            }
            mlp["shared_gate"] = {
                "w": proj(f"{prefix}.mlp.shared_expert_gate.weight")
            }
        return mlp

    return _load_moe_hf(model, directory, mlp_fn)


def load_mixtral_hf(model, directory: str) -> dict:
    """Param tree from a local HF Mixtral checkpoint dir
    (``block_sparse_moe.gate`` router; experts ``w1``=gate, ``w3``=up,
    ``w2``=down)."""
    cfg = model.cfg

    def mlp_fn(prefix, get, proj):
        mlp = {"router": {"w": proj(f"{prefix}.block_sparse_moe.gate.weight")}}
        for e in range(cfg.num_experts):
            ep = f"{prefix}.block_sparse_moe.experts.{e}"
            mlp[f"experts.{e}"] = {
                "gate_proj": {"w": proj(f"{ep}.w1.weight")},
                "up_proj": {"w": proj(f"{ep}.w3.weight")},
                "down_proj": {"w": proj(f"{ep}.w2.weight")},
            }
        return mlp

    return _load_moe_hf(model, directory, mlp_fn)
