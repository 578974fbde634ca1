"""Tests for the HF -> framework Gemma-3 weight importer.

``models/import_hf.py`` once had zero coverage — a wrong
transpose or a slipped (1+w) RMSNorm convention here silently invalidates any
future real-weights parity run. Two tiers:

1. Mapping unit tests against a hand-built synthetic safetensors directory
   (name-prefix fallbacks, transposes, tied/untied lm_head, shard merging,
   error paths).
2. A gold end-to-end parity test: a tiny random-init HF
   ``Gemma3ForCausalLM`` (torch, f32) saved with ``save_pretrained`` and
   re-imported must reproduce the HF model's logits — this pins transposes,
   (1+w) RMSNorm, QK-norm, dual-theta RoPE, sliding pattern, embedding
   scaling, and the GeGLU activation all at once (the reference's analogous
   risk surface is integration-tested on real exports,
   ``/root/reference/test/integration/conftest.py:30-41``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu.models.import_hf import load_gemma3_hf

safetensors_numpy = pytest.importorskip("safetensors.numpy")


CFG = Gemma3Config.tiny(
    vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
    num_heads=2, num_kv_heads=1, head_dim=16, sliding_window=8,
    sliding_pattern=2,
)


def _synthetic_hf_tensors(cfg: Gemma3Config, rng, prefix="model.",
                          tied=True) -> dict:
    """Hand-built HF-convention tensor dict: projections are (out, in)."""
    d, hd = cfg.hidden_size, cfg.head_dim

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tensors = {
        f"{prefix}embed_tokens.weight": t(cfg.vocab_size, d),
        f"{prefix}norm.weight": t(d),
    }
    for i in range(cfg.num_layers):
        p = f"{prefix}layers.{i}"
        tensors.update({
            f"{p}.self_attn.q_proj.weight": t(cfg.num_heads * hd, d),
            f"{p}.self_attn.k_proj.weight": t(cfg.num_kv_heads * hd, d),
            f"{p}.self_attn.v_proj.weight": t(cfg.num_kv_heads * hd, d),
            f"{p}.self_attn.o_proj.weight": t(d, cfg.num_heads * hd),
            f"{p}.self_attn.q_norm.weight": t(hd),
            f"{p}.self_attn.k_norm.weight": t(hd),
            f"{p}.mlp.gate_proj.weight": t(cfg.intermediate_size, d),
            f"{p}.mlp.up_proj.weight": t(cfg.intermediate_size, d),
            f"{p}.mlp.down_proj.weight": t(d, cfg.intermediate_size),
            f"{p}.input_layernorm.weight": t(d),
            f"{p}.post_attention_layernorm.weight": t(d),
            f"{p}.pre_feedforward_layernorm.weight": t(d),
            f"{p}.post_feedforward_layernorm.weight": t(d),
        })
    if not tied:
        tensors["lm_head.weight"] = t(cfg.vocab_size, d)
    return tensors


def _save(tensors: dict, directory, shards=1):
    directory.mkdir(parents=True, exist_ok=True)
    names = sorted(tensors)
    per = -(-len(names) // shards)
    for s in range(shards):
        chunk = {k: tensors[k] for k in names[s * per:(s + 1) * per]}
        if chunk:
            safetensors_numpy.save_file(
                chunk, str(directory / f"model-{s:05d}.safetensors")
            )


def test_import_maps_every_site_with_transpose(tmp_path):
    rng = np.random.default_rng(0)
    tensors = _synthetic_hf_tensors(CFG, rng)
    _save(tensors, tmp_path / "ckpt")
    model = Gemma3(CFG)
    params = load_gemma3_hf(model, str(tmp_path / "ckpt"))

    # Embedding and norms import untransposed; projections transpose to (in, out).
    np.testing.assert_array_equal(
        np.asarray(params["embed"]["w"]), tensors["model.embed_tokens.weight"]
    )
    np.testing.assert_array_equal(
        np.asarray(params["final_norm"]["w"]), tensors["model.norm.weight"]
    )
    for i in range(CFG.num_layers):
        layer = params[f"layers.{i}"]
        p = f"model.layers.{i}"
        for ours, hf_name in [
            (layer["attn"]["q_proj"], f"{p}.self_attn.q_proj.weight"),
            (layer["attn"]["k_proj"], f"{p}.self_attn.k_proj.weight"),
            (layer["attn"]["v_proj"], f"{p}.self_attn.v_proj.weight"),
            (layer["attn"]["o_proj"], f"{p}.self_attn.o_proj.weight"),
            (layer["mlp"]["gate_proj"], f"{p}.mlp.gate_proj.weight"),
            (layer["mlp"]["up_proj"], f"{p}.mlp.up_proj.weight"),
            (layer["mlp"]["down_proj"], f"{p}.mlp.down_proj.weight"),
        ]:
            np.testing.assert_array_equal(np.asarray(ours["w"]), tensors[hf_name].T)
        for ours, hf_name in [
            (layer["attn"]["q_norm"], f"{p}.self_attn.q_norm.weight"),
            (layer["attn"]["k_norm"], f"{p}.self_attn.k_norm.weight"),
            (layer["input_norm"], f"{p}.input_layernorm.weight"),
            (layer["post_attn_norm"], f"{p}.post_attention_layernorm.weight"),
            (layer["pre_ffn_norm"], f"{p}.pre_feedforward_layernorm.weight"),
            (layer["post_ffn_norm"], f"{p}.post_feedforward_layernorm.weight"),
        ]:
            np.testing.assert_array_equal(np.asarray(ours["w"]), tensors[hf_name])

    # Tied checkpoint: lm_head is the embedding transposed.
    np.testing.assert_array_equal(
        np.asarray(params["lm_head"]["w"]),
        tensors["model.embed_tokens.weight"].T,
    )

    # The imported tree must actually run.
    ids = np.array([[1, 2, 3]], np.int32)
    logits = model(params, jnp.asarray(ids))
    assert np.isfinite(np.asarray(logits)).all()


def test_import_untied_lm_head(tmp_path):
    rng = np.random.default_rng(1)
    tensors = _synthetic_hf_tensors(CFG, rng, tied=False)
    _save(tensors, tmp_path / "ckpt")
    params = load_gemma3_hf(Gemma3(CFG), str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(
        np.asarray(params["lm_head"]["w"]), tensors["lm_head.weight"].T
    )


def test_import_name_prefix_fallback(tmp_path):
    """Checkpoints without the ``model.`` prefix resolve via the candidates."""
    rng = np.random.default_rng(2)
    tensors = _synthetic_hf_tensors(CFG, rng, prefix="")
    # get("model.norm.weight") must find "norm.weight" via the stripped variant.
    _save(tensors, tmp_path / "ckpt")
    params = load_gemma3_hf(Gemma3(CFG), str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(
        np.asarray(params["final_norm"]["w"]), tensors["norm.weight"]
    )


def test_import_merges_shards(tmp_path):
    rng = np.random.default_rng(3)
    tensors = _synthetic_hf_tensors(CFG, rng)
    _save(tensors, tmp_path / "ckpt", shards=3)
    params = load_gemma3_hf(Gemma3(CFG), str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(
        np.asarray(params["embed"]["w"]), tensors["model.embed_tokens.weight"]
    )


def test_import_errors(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="No .safetensors"):
        load_gemma3_hf(Gemma3(CFG), str(tmp_path / "empty"))

    rng = np.random.default_rng(4)
    tensors = _synthetic_hf_tensors(CFG, rng)
    del tensors["model.layers.1.mlp.up_proj.weight"]
    _save(tensors, tmp_path / "missing")
    with pytest.raises(KeyError, match="up_proj"):
        load_gemma3_hf(Gemma3(CFG), str(tmp_path / "missing"))


def test_import_reproduces_hf_logits(tmp_path):
    """Gold parity: import a random-init HF Gemma3ForCausalLM checkpoint and
    match its logits. Pins every convention at once — a wrong transpose, a
    missed (1+w), a swapped rope theta, or a broken sliding mask all fail."""
    torch = pytest.importorskip("torch")
    tfm = pytest.importorskip("transformers")

    hf_cfg = tfm.Gemma3TextConfig(
        vocab_size=CFG.vocab_size,
        hidden_size=CFG.hidden_size,
        intermediate_size=CFG.intermediate_size,
        num_hidden_layers=CFG.num_layers,
        num_attention_heads=CFG.num_heads,
        num_key_value_heads=CFG.num_kv_heads,
        head_dim=CFG.head_dim,
        rope_theta=CFG.rope_theta,
        rope_local_base_freq=CFG.rope_local_base,
        sliding_window=CFG.sliding_window,
        sliding_window_pattern=CFG.sliding_pattern,
        rms_norm_eps=CFG.rms_norm_eps,
        query_pre_attn_scalar=int(CFG.query_pre_attn_scalar),
        tie_word_embeddings=True,
        attention_dropout=0.0,
    )
    # HF layer_types convention must agree with ours before comparing.
    assert [
        t == "full_attention" for t in hf_cfg.layer_types
    ] == [CFG.is_global_layer(i) for i in range(CFG.num_layers)]

    torch.manual_seed(0)
    hf_model = tfm.Gemma3ForCausalLM(hf_cfg).eval().to(torch.float32)
    hf_model.save_pretrained(tmp_path / "hf", safe_serialization=True)

    ids = np.array([[3, 17, 91, 4, 4, 55, 18, 2, 77, 30]], np.int32)
    with torch.no_grad():
        ref = hf_model(torch.from_numpy(ids).long()).logits.float().numpy()

    model = Gemma3(CFG)
    params = load_gemma3_hf(model, str(tmp_path / "hf"))
    ours = np.asarray(model(params, jnp.asarray(ids)), np.float32)

    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-4)
    # And greedy decisions agree everywhere.
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
