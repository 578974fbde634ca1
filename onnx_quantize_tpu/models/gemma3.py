"""Gemma-3 text model (JAX, built on the framework's module system).

The flagship model family, mirroring the reference's Gemma-3-270M example
(``/root/reference/examples/gemma3/gemma3_rtn.py:47-59``): every attention and
MLP projection is a ``Linear`` site (MatMul, no bias) the quantizer targets;
the tied lm_head is its own site so the planner's untying (the reference's
DuplicateInitializersPass analogue) lets it be quantized — or ignored via the
``ignore=["lm_head"]`` pattern the reference example uses.

Architecture (Gemma-3 text): RMSNorm (1+w gain, f32), QK-norm, GQA with
dual-theta RoPE (local layers use ``rope_local_base``), 5-local:1-global
sliding-window attention pattern, GeGLU MLP (tanh gelu), sandwich norms around
both attention and MLP, scaled embeddings, weight-tied lm_head.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from onnx_quantize_tpu import nn
from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.core.enums import QFormat
from onnx_quantize_tpu.nn.layers import Embedding, RMSNorm, apply_rope
from onnx_quantize_tpu.nn.module import Context, InputSpec

logger = get_logger(__name__)

__all__ = [
    "Gemma3Config", "Gemma3", "Gemma3MoEMLP",
    "GEMMA3_270M", "GEMMA3_1B", "GEMMA3_4B",
]


@dataclasses.dataclass(frozen=True)
class Gemma3Config:
    vocab_size: int = 262_144
    hidden_size: int = 640
    intermediate_size: int = 2048
    num_layers: int = 18
    num_heads: int = 4
    num_kv_heads: int = 1
    head_dim: int = 256
    rope_theta: float = 1_000_000.0  # global layers
    rope_local_base: float = 10_000.0  # sliding-window layers
    sliding_window: int = 512
    sliding_pattern: int = 6  # every Nth layer is global
    rms_norm_eps: float = 1e-6
    query_pre_attn_scalar: float = 256.0
    dtype: str = "float32"
    # Architecture-variant switches (defaults = Gemma-3 semantics). Flipping
    # them per the Llama/Qwen conventions reuses this whole decoder — and its
    # engine/TP/fusion/kernel paths — for those families (models/llama.py):
    # no QK-norm, pre-norm only, SiLU MLP, unscaled embeddings, plain-w
    # RMSNorm gain, optionally untied lm_head, every layer global
    # (sliding_pattern=1), llama3 rope frequency scaling.
    use_qk_norm: bool = True
    sandwich_norms: bool = True
    mlp_activation: str = "gelu_tanh"  # "gelu_tanh" | "silu"
    scale_embeddings: bool = True
    rms_one_plus: bool = True
    tie_lm_head: bool = True
    # llama3-style rope scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings), or None.
    rope_scaling: tuple | None = None
    # Qwen-2 convention: q/k/v projections carry biases (Gemma/Llama do not).
    attn_bias: bool = False
    # Mixture-of-Experts (Mixtral/Qwen-MoE convention; models/moe.py).
    # num_experts == 0 keeps the dense MLP. When > 0 the block's MLP becomes
    # a Gemma3MoEMLP: softmax router + top-k expert selection, every expert a
    # full gate/up/down Linear-site trio the quantizer targets.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int | None = None  # None -> intermediate_size
    # Qwen-MoE shared expert: a dense MLP of this intermediate size applied to
    # every token, sigmoid-gated by a (hidden, 1) projection. 0 disables.
    shared_expert_size: int = 0
    # Renormalize the top-k routing probabilities to sum to 1 (Mixtral: True;
    # Qwen1.5-MoE: False).
    norm_topk_prob: bool = True

    def is_global_layer(self, idx: int) -> bool:
        return (idx + 1) % self.sliding_pattern == 0

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    @classmethod
    def tiny(cls, **kw) -> "Gemma3Config":
        """A scaled-down config for tests."""
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=2, num_kv_heads=1, head_dim=32, sliding_window=16,
            sliding_pattern=2,
        )
        base.update(kw)
        return cls(**base)


GEMMA3_270M = Gemma3Config()

# Larger text-model configs in the family (same architecture knobs).
GEMMA3_1B = Gemma3Config(
    hidden_size=1152,
    intermediate_size=6912,
    num_layers=26,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
)

GEMMA3_4B = Gemma3Config(
    hidden_size=2560,
    intermediate_size=10240,
    num_layers=34,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    sliding_window=1024,
)


class Gemma3Attention(nn.Module):
    def __init__(self, cfg: Gemma3Config, layer_idx: int):
        super().__init__()
        self.cfg = cfg
        self.layer_idx = layer_idx
        self.is_global = cfg.is_global_layer(layer_idx)
        d = cfg.hidden_size
        dt = cfg.jnp_dtype
        ab = cfg.attn_bias
        self.q_proj = nn.Linear(d, cfg.num_heads * cfg.head_dim, use_bias=ab, dtype=dt)
        self.k_proj = nn.Linear(d, cfg.num_kv_heads * cfg.head_dim, use_bias=ab, dtype=dt)
        self.v_proj = nn.Linear(d, cfg.num_kv_heads * cfg.head_dim, use_bias=ab, dtype=dt)
        self.o_proj = nn.Linear(cfg.num_heads * cfg.head_dim, d, use_bias=False, dtype=dt)
        if cfg.use_qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps, dtype=dt,
                                  one_plus=cfg.rms_one_plus)
            self.k_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps, dtype=dt,
                                  one_plus=cfg.rms_one_plus)
        # Tensor-parallel replicate-slice markers (set by tp_localize when
        # 1 < num_kv_heads < tp): the K/V projections stay replicated and
        # produce ``kv_proj_heads`` heads; each device then slices the ONE
        # KV head its query shard attends to (head = axis_index // kv_dup).
        self.kv_proj_heads: int | None = None  # None => cfg.num_kv_heads
        self.kv_slice: tuple[str, int] | None = None  # (axis_name, dup)
        # Context-parallel marker set by parallel.cp.cp_localize:
        # (mesh axis name, axis size, "ring" | "gather"). When set (and no KV
        # cache is in play) attention runs over sequence-sharded K/V blocks.
        self.cp_spec: tuple[str, int, str] | None = None
        # QuaRot R3 (prepasses/rotate.py): per-head orthogonal transform
        # applied ONLINE to q and k post-RoPE. Scores are exactly invariant
        # ((qR)(kR)ᵀ = qkᵀ) while the cached K rows become outlier-spread —
        # the int8/int4 KV-quantization relief RoPE prevents folding.
        self.qk_rot: np.ndarray | None = None

    def _qkv(self, params, x, positions, ctx):
        cfg = self.cfg
        B, T, _ = x.shape
        # Under replicate-slice TP the K/V projections emit all global KV
        # heads; attention (and the KV cache) use cfg.num_kv_heads local ones.
        kv_proj_heads = self.kv_proj_heads or cfg.num_kv_heads
        if "_fused_qkv" in params:
            # Engine-load horizontal fusion (see nn/fuse.py): one kernel call.
            from onnx_quantize_tpu.ops import quantized_matmul

            w = params["_fused_qkv"]["w"]
            if isinstance(w, nn.QTensor):
                qkv = quantized_matmul(x, w)
            else:
                qkv = jnp.matmul(x, w, preferred_element_type=jnp.float32)
            qkv = qkv.astype(x.dtype)  # keep the activation stream in x.dtype
            n_q = cfg.num_heads * cfg.head_dim
            n_k = kv_proj_heads * cfg.head_dim
            q = qkv[..., :n_q]
            k = qkv[..., n_q : n_q + n_k]
            v = qkv[..., n_q + n_k :]
        else:
            q = self.q_proj(params["q_proj"], x, ctx=ctx)
            k = self.k_proj(params["k_proj"], x, ctx=ctx)
            v = self.v_proj(params["v_proj"], x, ctx=ctx)
        q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
        k = k.reshape(B, T, kv_proj_heads, cfg.head_dim)
        v = v.reshape(B, T, kv_proj_heads, cfg.head_dim)
        if self.kv_slice is not None and kv_proj_heads != cfg.num_kv_heads:
            # GQA replicate-slice: this shard's query heads all attend to one
            # global KV head — keep only that one (contiguous query sharding
            # guarantees the shard's heads map into a single KV group).
            axis_name, dup = self.kv_slice
            head = jax.lax.axis_index(axis_name) // dup
            k = jax.lax.dynamic_slice_in_dim(k, head, cfg.num_kv_heads, axis=2)
            v = jax.lax.dynamic_slice_in_dim(v, head, cfg.num_kv_heads, axis=2)
        if cfg.use_qk_norm:
            q = self.q_norm(params["q_norm"], q)
            k = self.k_norm(params["k_norm"], k)
        base = cfg.rope_theta if self.is_global else cfg.rope_local_base
        q = apply_rope(q, positions, base, scaling=cfg.rope_scaling)
        k = apply_rope(k, positions, base, scaling=cfg.rope_scaling)
        q = q * (cfg.query_pre_attn_scalar ** -0.5)
        if self.qk_rot is not None:
            r = jnp.asarray(self.qk_rot, q.dtype)
            q = jnp.einsum("...d,de->...e", q, r)
            k = jnp.einsum("...d,de->...e", k, r.astype(k.dtype))
        return q, k, v

    def __call__(self, params, x, positions, mask, ctx: Context | None = None,
                 kv_write=None):
        """mask: (B, 1, T, S) additive f32 mask (0 / -inf)."""
        cfg = self.cfg
        B, T, _ = x.shape
        q, k, v = self._qkv(params, x, positions, ctx)

        if self.cp_spec is not None and kv_write is None:
            # Context-parallel scoring: K/V blocks are sequence-sharded across
            # the mesh axis; the ring (or gathered) attend consumes GLOBAL
            # positions carried in ``positions`` and ignores ``mask`` (each
            # ring step rebuilds the causal/window mask for the block it
            # currently holds). Decode-with-cache stays on the TP engine.
            # The decoder passes mask=None when CP is active; warn (at trace
            # time) if an external caller hands us a custom mask that would
            # be silently dropped — CP only reproduces the causal/window mask.
            if mask is not None:
                logger.warning(
                    "Gemma3Attention: context-parallel attend ignores the "
                    "supplied mask and rebuilds the causal/sliding-window "
                    "mask per ring block; custom (e.g. padding) masks are "
                    "not applied under CP."
                )
            from onnx_quantize_tpu.parallel.cp import cp_attend

            cp_axis, cp_size, cp_mode = self.cp_spec
            out = cp_attend(
                q, k, v, positions, cfg=cfg, is_global=self.is_global,
                axis=cp_axis, size=cp_size, mode=cp_mode,
            )
            out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
            return self.o_proj(params["o_proj"], out.astype(x.dtype), ctx=ctx)

        if kv_write is not None:
            # Engine path: merge with cached K/V (see engine/kv_cache.py).
            kv = kv_write(self.layer_idx, k, v)
            from onnx_quantize_tpu.engine.kv_cache import QuantizedKV

            if isinstance(kv, QuantizedKV):
                # Scale-folded XLA attend on the raw int8 cache: the per-
                # (token, head) K scale is a column scale of the score matrix
                # and the V scale folds into the attention weights, so the
                # einsums consume plain int8->bf16 casts (fused into the dot
                # reads by XLA) and no dequantized (B, S, H, D) array exists:
                #   scores = (q @ K_i8^T) * ks[s];  out = (p * vs[s]) @ V_i8.
                S = kv.k.shape[1]
                group = cfg.num_heads // cfg.num_kv_heads
                qg = q.reshape(B, T, cfg.num_kv_heads, group, cfg.head_dim)
                logits = jnp.einsum(
                    "btkgh,bskh->bkgts", qg, kv.k_ints().astype(q.dtype)
                )
                ks = jnp.transpose(kv.k_scale, (0, 2, 1))  # (B, Hkv, S) f32
                logits = (
                    logits.astype(jnp.float32) * ks[:, :, None, None, :]
                    + mask[:, :, None, :, :S].astype(jnp.float32)
                )
                probs = jax.nn.softmax(logits, axis=-1)
                vs = jnp.transpose(kv.v_scale, (0, 2, 1))
                pv = (probs * vs[:, :, None, None, :]).astype(q.dtype)
                out = jnp.einsum("bkgts,bskh->btkgh", pv, kv.v_ints().astype(q.dtype))
                out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
                return self.o_proj(params["o_proj"], out.astype(x.dtype), ctx=ctx)
            k, v = kv
        S = k.shape[1]

        group = cfg.num_heads // cfg.num_kv_heads
        qg = q.reshape(B, T, cfg.num_kv_heads, group, cfg.head_dim)
        logits = jnp.einsum("btkgh,bskh->bkgts", qg, k.astype(q.dtype))
        logits = logits.astype(jnp.float32) + mask[:, :, None, :, :S].astype(jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        out = jnp.einsum("bkgts,bskh->btkgh", probs, v)
        out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
        return self.o_proj(params["o_proj"], out, ctx=ctx)


class Gemma3MLP(nn.Module):
    def __init__(self, cfg: Gemma3Config):
        super().__init__()
        dt = cfg.jnp_dtype
        self.activation = cfg.mlp_activation
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, use_bias=False, dtype=dt)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, use_bias=False, dtype=dt)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, use_bias=False, dtype=dt)
        # QuaRot R4 (prepasses/rotate.py): blockwise Hadamard applied ONLINE
        # to the down input (Hᵀ folded into down_proj's rows — exact), set by
        # apply_online_rotations. Spreads the GeGLU-output outliers that
        # dominate activation-quantization error at this site.
        self.down_rot: np.ndarray | None = None

    def __call__(self, params, x, ctx: Context | None = None):
        if "_fused_gate_up" in params:
            from onnx_quantize_tpu.ops import quantized_matmul

            w = params["_fused_gate_up"]["w"]
            if isinstance(w, nn.QTensor):
                gu = quantized_matmul(x, w)
            else:
                gu = jnp.matmul(x, w, preferred_element_type=jnp.float32)
            gu = gu.astype(x.dtype)  # keep the activation stream in x.dtype
            n_gate = gu.shape[-1] // 2  # gate and up are both intermediate_size
            gate, up = gu[..., :n_gate], gu[..., n_gate:]
        else:
            gate = self.gate_proj(params["gate_proj"], x, ctx=ctx)
            up = self.up_proj(params["up_proj"], x, ctx=ctx)
        if self.activation == "silu":
            act = jax.nn.silu(gate) * up
        else:
            act = jax.nn.gelu(gate, approximate=True) * up
        if self.down_rot is not None:
            r = jnp.asarray(self.down_rot, act.dtype)
            blk = r.shape[0]
            shp = act.shape
            act = act.reshape(*shp[:-1], shp[-1] // blk, blk)
            act = jnp.einsum("...gb,bc->...gc", act, r).reshape(shp)
        return self.down_proj(params["down_proj"], act, ctx=ctx)


def _expert_slice(site: dict, e: int) -> dict:
    """Per-expert view of a stacked site dict (leading axis = local expert)."""
    out = {}
    for key, leaf in site.items():
        if isinstance(leaf, nn.QTensor):
            children, meta = leaf.tree_flatten()
            children = tuple(None if c is None else c[e] for c in children)
            out[key] = nn.QTensor.tree_unflatten(meta, children)
        elif leaf is None:
            out[key] = None
        else:
            out[key] = leaf[e]
    return out


def apply_site(site: dict, x):
    """Linear-site semantics on an engine-layout site dict (prescale multiply,
    QTensor-vs-dense dispatch, caller-dtype stream). The ONE definition shared
    by the MoE module's stacked/fused paths and the a2a EP schedule
    (``parallel/ep.py``) — expert-execution semantics must not fork."""
    from onnx_quantize_tpu.ops import quantized_matmul

    dt = x.dtype
    prescale = site.get("prescale")
    if prescale is not None:
        x = (x * prescale).astype(dt)
    w = site["w"]
    if isinstance(w, nn.QTensor):
        y = quantized_matmul(x, w)
    else:
        y = jnp.matmul(x, w, preferred_element_type=jnp.float32)
    return y.astype(dt)


def glu_activation(gate, up, activation: str):
    if activation == "silu":
        return jax.nn.silu(gate) * up
    return jax.nn.gelu(gate, approximate=True) * up


def stacked_expert_mlp(stacked: dict, e: int, x, activation: str):
    """One expert's gated MLP from a stacked site dict (engine layout)."""
    if "gate_up" in stacked:
        gu = apply_site(_expert_slice(stacked["gate_up"], e), x)
        n = gu.shape[-1] // 2
        gate, up = gu[..., :n], gu[..., n:]
    else:
        gate = apply_site(_expert_slice(stacked["gate"], e), x)
        up = apply_site(_expert_slice(stacked["up"], e), x)
    act = glu_activation(gate, up, activation)
    return apply_site(_expert_slice(stacked["down"], e), act)


class Gemma3MoEMLP(nn.Module):
    """Sparse Mixture-of-Experts MLP (Mixtral / Qwen-MoE convention).

    Routing: softmax over the router logits, top-k expert selection, optional
    renormalization of the selected probabilities (``cfg.norm_topk_prob``).
    Every expert is a full :class:`Gemma3MLP`, so each expert projection is an
    ordinary Linear site the quantizer targets (the reference quantizes every
    MatMul site it finds — MoE experts are just more of them), and the router
    itself is a (tiny) MatMul site usually excluded via ``ignore``.

    Execution is the *dense-masked* scheme: each expert runs
    over the full token set with unrouted rows zeroed, outputs combine with
    the routing weights. At decode (the memory-bound phase) this is
    bandwidth-optimal — all resident expert weights stream from HBM once per
    step regardless of routing, which is the physics of batched MoE decode
    anyway — and it is exact: zeroed rows produce zeroed expert outputs
    (act(0) * 0 == 0 through the gated MLP) that the combine weights ignore.
    Zeroing the rows (rather than only zero-weighting the outputs) also makes
    the per-expert activation taps calibration-exact: GPTQ Hessians (X^T X),
    SmoothQuant channel maxima, and AWQ means see only the tokens actually
    routed to that expert.

    Two parameter layouts:

    * quantization/oracle layout — per-expert subtrees ``experts.{e}`` (what
      ``init`` builds and ``quantize`` transforms),
    * engine layout — ``_stacked_experts`` site dicts with a leading local-
      expert axis (built by :func:`onnx_quantize_tpu.models.moe.stack_moe_experts`
      after fusion/scale-baking). Stacking is what makes expert parallelism a
      plain ``PartitionSpec``: the leading axis shards over the model mesh
      axis, each device loops its local experts, and ONE psum combines
      (``ep_axis`` is set by ``tp_localize``).
    """

    def __init__(self, cfg: Gemma3Config):
        super().__init__()
        self.cfg = cfg
        dt = cfg.jnp_dtype
        self.activation = cfg.mlp_activation
        expert_cfg = dataclasses.replace(
            cfg, intermediate_size=cfg.moe_intermediate_size or cfg.intermediate_size
        )
        self.router = nn.Linear(cfg.hidden_size, cfg.num_experts, use_bias=False, dtype=dt)
        self.experts: list[Gemma3MLP] = []
        for e in range(cfg.num_experts):
            mlp = Gemma3MLP(expert_cfg)
            setattr(self, f"experts.{e}", mlp)
            self.experts.append(mlp)
        if cfg.shared_expert_size:
            shared_cfg = dataclasses.replace(
                cfg, intermediate_size=cfg.shared_expert_size
            )
            self.shared = Gemma3MLP(shared_cfg)
            self.shared_gate = nn.Linear(cfg.hidden_size, 1, use_bias=False, dtype=dt)
        # Expert parallelism marker (set by tp_localize): psum the combined
        # expert outputs over this axis; the local expert count is the stacked
        # leading dim and the global expert index offset is axis_index * local.
        self.ep_axis: str | None = None
        # Prefill dispatch: at large M the dense-masked scheme pays E/top_k x
        # the routed MLP FLOPs (fine at decode where bytes dominate; waste in
        # the compute-bound prefill regime). True forces the sorted
        # ragged_dot path (compute proportional to routed tokens), False the
        # dense-masked one. "auto" takes dense-masked: on the H100, at the
        # bench MoE config in bf16, ragged_dot was slower at M = 8192
        # (chip_smoke.py's MoE phase; PERF.md).
        self.use_ragged_prefill: bool | str = "auto"

    @staticmethod
    def _ragged_compatible(layout: dict) -> bool:
        """The ragged path runs plain fp grouped matmuls on dequantized
        weights — only valid for weight-only QDQ sites. Activation-quant or
        QLinear configs must keep the dense-masked path, whose per-expert
        ``quantized_matmul`` applies the input/output fake-quant and
        full-integer semantics."""
        for site in layout.values():
            w = site.get("w")
            if isinstance(w, nn.QTensor):
                m = w.meta
                if (
                    m.fmt != QFormat.QDQ
                    or m.input_quant.mode != "none"
                    or m.output_quant.mode != "none"
                ):
                    return False
        return True

    def _ragged_ok(self, layout) -> bool:
        if self.use_ragged_prefill is not True or layout is None:
            return False
        return self.ep_axis is None and self._ragged_compatible(layout)

    @staticmethod
    def _dense_stack(site: dict, dtype):
        """Stacked site -> dense (E, K, N) weights in the stream dtype (the
        dequantize-once trade of the prefill regime, matching the W4 kernel's
        M-routing: exact nibbles, bf16-rounded weights under a bf16 stream)."""
        from onnx_quantize_tpu.ops.reference import dequantize_weight

        w = site["w"]
        if isinstance(w, nn.QTensor):
            n_local = w.data.shape[0]
            dense = [dequantize_weight(_expert_slice(site, e)["w"])
                     for e in range(n_local)]
            return jnp.stack(dense).astype(dtype)
        return w.astype(dtype)

    def _experts_ragged(self, stacked: dict, x, top_p, top_i):
        """Sorted grouped-matmul expert execution (exact routing, compute
        proportional to routed tokens): flatten the (token, choice) pairs,
        sort by expert, one ``lax.ragged_dot`` per projection against the
        stacked expert weights, scatter-add back with the routing weights."""
        cfg = self.cfg
        orig_shape = x.shape
        d = orig_shape[-1]
        M = int(np.prod(orig_shape[:-1]))
        k = cfg.num_experts_per_tok
        x2 = x.reshape(M, d)
        flat_e = top_i.reshape(-1)
        flat_w = top_p.reshape(-1)
        tok = jnp.repeat(jnp.arange(M, dtype=jnp.int32), k)
        order = jnp.argsort(flat_e, stable=True)
        st, sw = tok[order], flat_w[order]
        xs = x2[st]
        group_sizes = jnp.bincount(flat_e, length=cfg.num_experts)

        def prescaled(site, xin):
            ps = site.get("prescale")
            if ps is None:
                return xin
            se = flat_e[order]
            return (xin * ps[se]).astype(xin.dtype)

        if "gate_up" in stacked:
            w_gu = self._dense_stack(stacked["gate_up"], x.dtype)
            gu = jax.lax.ragged_dot(
                prescaled(stacked["gate_up"], xs), w_gu, group_sizes
            ).astype(x.dtype)
            n = gu.shape[-1] // 2
            gate, up = gu[..., :n], gu[..., n:]
        else:
            w_g = self._dense_stack(stacked["gate"], x.dtype)
            w_u = self._dense_stack(stacked["up"], x.dtype)
            gate = jax.lax.ragged_dot(
                prescaled(stacked["gate"], xs), w_g, group_sizes
            ).astype(x.dtype)
            up = jax.lax.ragged_dot(
                prescaled(stacked["up"], xs), w_u, group_sizes
            ).astype(x.dtype)
        act = glu_activation(gate, up, self.activation)
        w_d = self._dense_stack(stacked["down"], x.dtype)
        ys = jax.lax.ragged_dot(
            prescaled(stacked["down"], act), w_d, group_sizes
        )
        out = jnp.zeros((M, d), jnp.float32)
        out = out.at[st].add(ys.astype(jnp.float32) * sw[..., None])
        return out.reshape(orig_shape[:-1] + (d,))

    def _routing(self, params, x, ctx):
        cfg = self.cfg
        logits = self.router(params["router"], x, ctx=ctx).astype(jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        top_p, top_i = jax.lax.top_k(probs, cfg.num_experts_per_tok)
        if cfg.norm_topk_prob:
            top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
        return top_p, top_i

    @staticmethod
    def _combine_weights(top_p, top_i, num_experts):
        """(..., E) combine weights: routing prob where selected, else 0."""
        return jnp.sum(
            jax.nn.one_hot(top_i, num_experts, dtype=jnp.float32)
            * top_p[..., None],
            axis=-2,
        )

    def _expert_stacked(self, stacked: dict, e: int, x):
        return stacked_expert_mlp(stacked, e, x, self.activation)

    def _experts_fused(self, fused: dict, x, combine):
        """Two-matmul expert execution (the decode-fast layout, see
        ``models.moe.fuse_moe_experts``): one fat-N gate_up over the expert
        concat, routing weights folded into the activation segments, one
        deep-K down whose accumulator performs the combine sum. Under EP the
        two sites are exactly the Megatron column->row pair and the psum is
        the cross-device combine."""
        cfg = self.cfg
        inter = cfg.moe_intermediate_size or cfg.intermediate_size
        gu = apply_site(fused["gate_up"], x)  # (..., E_local*2I)
        n_local = gu.shape[-1] // (2 * inter)
        if self.ep_axis is not None:
            base = jax.lax.axis_index(self.ep_axis) * n_local
            seg = jax.lax.dynamic_slice_in_dim(combine, base, n_local, axis=-1)
        else:
            seg = combine
        gu = gu.reshape(*gu.shape[:-1], n_local, 2 * inter)
        gate, up = gu[..., :inter], gu[..., inter:]
        act = glu_activation(gate, up, self.activation)
        act = act * seg[..., None].astype(act.dtype)
        act = act.reshape(*x.shape[:-1], n_local * inter)
        out = apply_site(fused["down"], act)
        if self.ep_axis is not None:
            out = jax.lax.psum(out.astype(jnp.float32), self.ep_axis)
        return out.astype(x.dtype)

    @staticmethod
    def _fused_to_stacked_dense(fused: dict, inter: int):
        """Per-expert dense views of the concatenated layout (ragged path)."""
        from onnx_quantize_tpu.ops.reference import dequantize_weight

        def dense(site):
            w = site["w"]
            return dequantize_weight(w) if isinstance(w, nn.QTensor) else w

        gu = dense(fused["gate_up"])  # (K, E*2I)
        K = gu.shape[0]
        gu = gu.reshape(K, -1, 2 * inter).transpose(1, 0, 2)  # (E, K, 2I)
        dn = dense(fused["down"])  # (E*I, d)
        dn = dn.reshape(-1, inter, dn.shape[-1])  # (E, I, d)
        return {"gate_up": {"w": gu}, "down": {"w": dn}}

    def __call__(self, params, x, ctx: Context | None = None):
        cfg = self.cfg
        top_p, top_i = self._routing(params, x, ctx)
        stacked = params.get("_stacked_experts")
        fused = params.get("_fused_experts")
        ragged_src = stacked if stacked is not None else fused
        if self._ragged_ok(ragged_src):
            if stacked is None:
                inter = cfg.moe_intermediate_size or cfg.intermediate_size
                ragged_src = self._fused_to_stacked_dense(fused, inter)
            out = self._experts_ragged(ragged_src, x, top_p, top_i)
            out = out.astype(x.dtype)
            return self._shared_out(params, x, out, ctx)
        combine = self._combine_weights(top_p, top_i, cfg.num_experts)  # f32
        if fused is not None:
            out = self._experts_fused(fused, x, combine)
            return self._shared_out(params, x, out, ctx)
        out = jnp.zeros(x.shape[:-1] + (cfg.hidden_size,), jnp.float32)
        if stacked is not None:
            down_w = stacked["down"]["w"]
            n_local = (
                down_w.data.shape[0] if isinstance(down_w, nn.QTensor)
                else down_w.shape[0]
            )
            base = (
                jax.lax.axis_index(self.ep_axis) * n_local
                if self.ep_axis is not None else 0
            )
            for e in range(n_local):
                w_e = jax.lax.dynamic_index_in_dim(
                    combine, base + e, axis=-1, keepdims=False
                )
                xe = x * (w_e > 0).astype(x.dtype)[..., None]
                ye = self._expert_stacked(stacked, e, xe)
                out = out + ye.astype(jnp.float32) * w_e[..., None]
            if self.ep_axis is not None:
                out = jax.lax.psum(out, self.ep_axis)
        else:
            for e in range(cfg.num_experts):
                w_e = combine[..., e]
                xe = x * (w_e > 0).astype(x.dtype)[..., None]
                ye = self.experts[e](params[f"experts.{e}"], xe, ctx=ctx)
                out = out + ye.astype(jnp.float32) * w_e[..., None]
        out = out.astype(x.dtype)
        return self._shared_out(params, x, out, ctx)

    def _shared_out(self, params, x, out, ctx):
        if self.cfg.shared_expert_size:
            gate = self.shared_gate(params["shared_gate"], x, ctx=ctx)
            shared = self.shared(params["shared"], x, ctx=ctx)
            out = out + (
                jax.nn.sigmoid(gate.astype(jnp.float32))
                * shared.astype(jnp.float32)
            ).astype(x.dtype)
        return out


class Gemma3Block(nn.Module):
    def __init__(self, cfg: Gemma3Config, layer_idx: int):
        super().__init__()
        dt = cfg.jnp_dtype
        self.attn = Gemma3Attention(cfg, layer_idx)
        self.mlp = Gemma3MoEMLP(cfg) if cfg.num_experts > 0 else Gemma3MLP(cfg)
        one_plus = cfg.rms_one_plus
        self.sandwich = cfg.sandwich_norms
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dt,
                                  one_plus=one_plus)
        self.pre_ffn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dt,
                                    one_plus=one_plus)
        if self.sandwich:
            self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                          dtype=dt, one_plus=one_plus)
            self.post_ffn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                         dtype=dt, one_plus=one_plus)

    def __call__(self, params, x, positions, mask, ctx: Context | None = None,
                 kv_write=None):
        h = self.input_norm(params["input_norm"], x)
        h = self.attn(params["attn"], h, positions, mask, ctx=ctx, kv_write=kv_write)
        if self.sandwich:
            h = self.post_attn_norm(params["post_attn_norm"], h)
        x = x + h
        h = self.pre_ffn_norm(params["pre_ffn_norm"], x)
        h = self.mlp(params["mlp"], h, ctx=ctx)
        if self.sandwich:
            h = self.post_ffn_norm(params["post_ffn_norm"], h)
        return x + h


def make_attention_valid(cfg: Gemma3Config, positions, kv_positions, is_global: bool):
    """Boolean visibility (B, 1, T, S): causal, plus sliding window on local
    layers. Single source of truth for both the additive mask and any
    block-skip predicates (parallel/cp.py derives its fully-masked-block skip
    from this tensor, never from the additive values)."""
    valid = kv_positions[:, None, :] <= positions[:, :, None]  # causal
    if not is_global:
        valid &= kv_positions[:, None, :] > positions[:, :, None] - cfg.sliding_window
    return valid[:, None, :, :]


def make_attention_mask(cfg: Gemma3Config, positions, kv_positions, is_global: bool):
    """Additive mask (B, 1, T, S): 0 where visible, -1e30 where masked."""
    valid = make_attention_valid(cfg, positions, kv_positions, is_global)
    return jnp.where(valid, 0.0, -1e30).astype(jnp.float32)


def fuse_gemma3_projections(params: dict) -> dict:
    """Engine-load transform: fuse q/k/v and gate/up per layer when eligible.

    Apply after quantization (and never before calibration — fused sites skip
    activation taps). Returns a new params tree; original left untouched.
    """
    from onnx_quantize_tpu.nn.fuse import can_fuse, fuse_sites
    from onnx_quantize_tpu.utils import copy_tree

    params = copy_tree(params)
    for name, layer in params.items():
        if not (isinstance(layer, dict) and "attn" in layer):
            continue
        attn = layer["attn"]
        trio = [attn.get("q_proj"), attn.get("k_proj"), attn.get("v_proj")]
        if all(trio) and can_fuse(trio):
            fused, _ = fuse_sites(trio)
            attn["_fused_qkv"] = {"w": fused}
            for key in ("q_proj", "k_proj", "v_proj"):
                del attn[key]
        mlp = layer.get("mlp")
        if mlp is not None:
            # Dense MLP, every MoE expert, and the MoE shared expert all carry
            # the same gate/up pair — fuse each independently.
            subs = [mlp] + [
                v for k, v in mlp.items()
                if isinstance(v, dict) and (k.startswith("experts.") or k == "shared")
            ]
            for sub in subs:
                duo = [sub.get("gate_proj"), sub.get("up_proj")]
                if all(duo) and can_fuse(duo):
                    fused, _ = fuse_sites(duo)
                    sub["_fused_gate_up"] = {"w": fused}
                    for key in ("gate_proj", "up_proj"):
                        del sub[key]
    return params


class Gemma3(nn.Module):
    """Full Gemma-3 causal LM. ``__call__`` returns logits (B, T, vocab)."""

    def __init__(self, cfg: Gemma3Config = GEMMA3_270M):
        super().__init__()
        self.cfg = cfg
        dt = cfg.jnp_dtype
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dt)
        self.blocks = []
        for i in range(cfg.num_layers):
            block = Gemma3Block(cfg, i)
            setattr(self, f"layers.{i}", block)
            self.blocks.append(block)
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dt,
                                  one_plus=cfg.rms_one_plus)
        # The lm_head site; by default tied to the embedding at init
        # (quantize() unties it automatically when both are quantized).
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, use_bias=False, dtype=dt)
        self.input_specs = [InputSpec("input_ids", (8,), np.int32)]
        # Tensor-parallel marker set by tp_localize: all-gather the
        # vocab-sharded logits over this axis at the very end.
        self._tp_gather_logits: str | None = None
        self.finalize()

    def init(self, rng: jax.Array) -> dict:
        params = super().init(rng)
        if self.cfg.tie_lm_head:
            # Tie lm_head to the embedding (transposed view shares the buffer;
            # untie_params copies it if both end up quantized).
            params["lm_head"] = {"w": params["embed"]["w"].T}
        return params

    def hidden_states(self, params, input_ids, ctx=None, positions=None, kv_write=None,
                      kv_positions=None):
        cfg = self.cfg
        B, T = input_ids.shape
        if positions is None:
            positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None, :], (B, T))
        if kv_positions is None:
            kv_positions = positions

        x = self.embed(params["embed"], input_ids)
        if cfg.scale_embeddings:
            x = x * math.sqrt(cfg.hidden_size)
        x = x.astype(cfg.jnp_dtype)

        # Under context parallelism (kv_write=None and cp_spec stamped on the
        # attention layers) each ring step rebuilds its own causal/window mask
        # from global positions — don't build (and silently drop) one here.
        cp_active = (
            kv_write is None
            and bool(self.blocks)
            and getattr(self.blocks[0].attn, "cp_spec", None) is not None
        )
        if cp_active:
            mask_local = mask_global = None
        else:
            mask_local = make_attention_mask(cfg, positions, kv_positions, is_global=False)
            mask_global = make_attention_mask(cfg, positions, kv_positions, is_global=True)

        for i, block in enumerate(self.blocks):
            mask = mask_global if cfg.is_global_layer(i) else mask_local
            x = block(params[f"layers.{i}"], x, positions, mask, ctx=ctx,
                      kv_write=kv_write)

        return self.final_norm(params["final_norm"], x)

    def __call__(self, params, input_ids, ctx: Context | None = None, positions=None,
                 kv_write=None, kv_positions=None):
        x = self.hidden_states(
            params, input_ids, ctx=ctx, positions=positions, kv_write=kv_write,
            kv_positions=kv_positions,
        )
        logits = self.lm_head(params["lm_head"], x, ctx=ctx)
        if self._tp_gather_logits is not None:
            # Column-parallel lm_head: one tiled all-gather of the
            # vocab-sharded logits — the only gather in the whole TP forward.
            logits = jax.lax.all_gather(
                logits, self._tp_gather_logits, axis=logits.ndim - 1, tiled=True
            )
        return logits

    def tp_localize(self, tp: int, axis: str = "model"):
        """Per-shard model instance + sharding rules for whole-model TP.

        Returns ``(local_model, rules)``: the local model has ``num_heads/tp``
        query heads (KV heads shard too when divisible, else replicate — valid
        only for MQA ``num_kv_heads == 1`` since GQA grouping is positional),
        row-parallel psum markers on o_proj/down_proj, a vocab-sharded
        embedding lookup, and the lm_head logits gather. Use its ``__call__``
        *inside* ``shard_map`` with params localized by
        ``parallel.tp.localize_params``.
        """
        cfg = self.cfg
        if tp == 1:
            rules = [(r".*", "replicate")]
            return self, rules
        if cfg.num_heads % tp != 0:
            raise ValueError(f"num_heads={cfg.num_heads} not divisible by tp={tp}")
        # KV-head placement:
        #   * num_kv_heads % tp == 0  -> shard KV heads (column-parallel k/v),
        #   * 1 < num_kv_heads < tp, tp % num_kv_heads == 0 -> replicate k/v
        #     and slice: each device keeps the one KV head its query shard
        #     attends to (contiguous query sharding keeps GQA groups aligned
        #     because the global group size H/Hkv is a multiple of H/tp),
        #   * num_kv_heads == 1 (MQA) -> plain replication.
        kv_sharded = cfg.num_kv_heads % tp == 0
        kv_sliced = (
            not kv_sharded
            and cfg.num_kv_heads > 1
            and tp % cfg.num_kv_heads == 0
        )
        if not kv_sharded and not kv_sliced and cfg.num_kv_heads != 1:
            raise ValueError(
                f"num_kv_heads={cfg.num_kv_heads} must divide tp, be divisible "
                f"by tp, or equal 1 (got tp={tp}: GQA groups would straddle "
                "device boundaries)"
            )
        local_kv = cfg.num_kv_heads // tp if kv_sharded else (
            1 if kv_sliced else cfg.num_kv_heads
        )
        local_cfg = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // tp, num_kv_heads=local_kv,
        )
        local = Gemma3(local_cfg)
        moe = cfg.num_experts > 0
        if moe and cfg.num_experts % tp != 0:
            raise ValueError(
                f"num_experts={cfg.num_experts} not divisible by tp={tp}"
            )
        for block in local.blocks:
            block.attn.o_proj.tp_reduce = axis
            if moe:
                # Expert parallelism: stacked experts shard their leading
                # axis over `axis` (see stack_moe_experts); each device
                # computes its local experts and ONE psum combines. The
                # shared expert runs Megatron column->row TP like a dense MLP.
                block.mlp.ep_axis = axis
                if cfg.shared_expert_size:
                    block.mlp.shared.down_proj.tp_reduce = axis
            else:
                block.mlp.down_proj.tp_reduce = axis
            if kv_sliced:
                block.attn.kv_proj_heads = cfg.num_kv_heads
                block.attn.kv_slice = (axis, tp // cfg.num_kv_heads)
        local.embed.tp_vocab_axis = axis
        local._tp_gather_logits = axis
        kv_kind = "column" if kv_sharded else "replicate"
        # Fused-site kinds carry their segment layout so localize_params can
        # permute the concatenated columns into per-device [q_i|k_i|v_i]
        # chunks (duplicating replicated KV segments when sliced).
        n_q = cfg.num_heads * cfg.head_dim
        n_kv = cfg.num_kv_heads * cfg.head_dim
        qkv_fused = ("fused_column",
                     ((n_q, "column"), (n_kv, kv_kind), (n_kv, kv_kind)))
        gu_fused = ("fused_column",
                    ((cfg.intermediate_size, "column"),
                     (cfg.intermediate_size, "column")))
        rules = [
            (r"\.attn\._fused_qkv$", qkv_fused),
            (r"\.attn\.q_proj$", "column"),
            (r"\.attn\.(k_proj|v_proj)$", kv_kind),
            (r"\.attn\.o_proj$", "row"),
            (r"^lm_head$", "column"),
            (r"^embed$", "vocab"),
        ]
        if moe:
            shared_fused = ("fused_column",
                            ((cfg.shared_expert_size, "column"),
                             (cfg.shared_expert_size, "column")))
            rules += [
                # Concatenated experts (fuse_moe_experts) ARE the Megatron
                # pair: gate_up column-shards N (expert-aligned chunks), down
                # row-shards K, and the psum in _experts_fused is the
                # cross-device combine.
                (r"\.mlp\._fused_experts\.gate_up$", "column"),
                (r"\.mlp\._fused_experts\.down$", "row"),
                # Stacked experts shard the leading (expert) axis; the router,
                # the shared-expert gate, and any UNstacked per-expert
                # subtrees replicate (replicated experts need no collective —
                # every device computes the identical full combine).
                (r"\.mlp\._stacked_experts", "expert"),
                (r"\.mlp\.router$", "replicate"),
                (r"\.mlp\.shared_gate$", "replicate"),
                (r"\.mlp\.shared\._fused_gate_up$", shared_fused),
                (r"\.mlp\.shared\.(gate_proj|up_proj)$", "column"),
                (r"\.mlp\.shared\.down_proj$", "row"),
                (r"\.mlp\.experts\.", "replicate"),
            ]
        else:
            rules += [
                (r"\.mlp\._fused_gate_up$", gu_fused),
                (r"\.mlp\.(gate_proj|up_proj)$", "column"),
                (r"\.mlp\.down_proj$", "row"),
            ]
        return local, rules
