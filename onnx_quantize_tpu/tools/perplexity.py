"""Sliding-window perplexity evaluation (HF method).

Parity with the reference tool (``/root/reference/tools/perplexity.py:25-83``):
wikitext-2 joined with double newlines, window ``max_length=2048`` advanced by
``stride=512``, log-softmax over shifted logits, counting only the
newly-revealed tokens of each window, final ``ppl = exp(total_nll / tokens)``.

The executor is a jit'd JAX forward of a framework model (quantized params run
through ``ops.quantized_matmul``) instead of an ORT session. Token sources:
a HF dataset (when network/cache is available), a plain text file + tokenizer,
or a pre-tokenized ``.npy`` array — the last two keep the tool usable in
air-gapped environments.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np

import jax
import jax.numpy as jnp

from onnx_quantize_tpu._logging import get_logger

logger = get_logger(__name__)

__all__ = ["perplexity_eval", "perplexity_from_tokens"]


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x_max = x.max(axis=-1, keepdims=True)
    x = x - x_max
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def load_wikitext_tokens(model_id: str | None = None, tokenizer=None) -> np.ndarray:
    """Tokenize wikitext-2-raw test split (requires network/datasets cache)."""
    from datasets import load_dataset  # gated import: optional dependency

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_id)
    text = "\n\n".join(load_dataset("wikitext", "wikitext-2-raw-v1", split="test")["text"])
    return tokenizer(text, return_tensors="np").input_ids[0]


def perplexity_from_tokens(
    model,
    params,
    input_ids: np.ndarray,
    max_length: int = 2048,
    stride: int = 512,
    mesh=None,
    cp_mode: str = "ring",
) -> float:
    """Sliding-window perplexity of a framework causal LM over a token stream.

    ``mesh``: a context-parallel ``jax.sharding.Mesh`` (axis "seq") shards
    each window's tokens across devices and scores it with ring attention
    (``parallel/cp.py``) — windows longer than one chip's activation budget
    become scoreable, and per-device attention memory drops to O(T/C). The
    windowing/NLL math is unchanged; one shard_map program is compiled and
    reused for every window.
    """
    seq_len = len(input_ids)

    if mesh is not None:
        from onnx_quantize_tpu.parallel.cp import make_cp_forward

        shards = mesh.shape[mesh.axis_names[0]]
        layout = "zigzag" if max_length % (2 * shards) == 0 else "contiguous"
        forward = make_cp_forward(
            model, mesh, max_length, axis=mesh.axis_names[0], mode=cp_mode,
            layout=layout,
        )
    else:
        @functools.partial(jax.jit, static_argnums=())
        def forward(p, ids):
            return model(p, ids)

    total_nll = 0.0
    total_tokens = 0
    prev_end = 0

    for begin in range(0, seq_len, stride):
        end = min(begin + max_length, seq_len)
        trg_len = end - prev_end

        chunk = np.asarray(input_ids[begin:end])[None, :].astype(np.int32)
        # Pad to max_length so every window reuses one compiled program; the
        # pad region sits past `end` and is never counted.
        pad = max_length - chunk.shape[1]
        padded = np.pad(chunk, ((0, 0), (0, pad))) if pad else chunk
        logits = np.asarray(forward(params, jnp.asarray(padded))[0], dtype=np.float32)
        logits = logits[: chunk.shape[1]]

        log_probs = _log_softmax(logits[:-1])
        targets = chunk[0, 1:]

        loss_targets = targets[-trg_len:]
        lp = log_probs[-trg_len:]
        nll = -lp[np.arange(len(loss_targets)), loss_targets]

        total_nll += float(nll.sum())
        total_tokens += len(nll)
        logger.info(
            "ppl window [%d, %d): running ppl %.4f",
            begin, end, float(np.exp(total_nll / total_tokens)),
        )

        prev_end = end
        if end == seq_len:
            break

    ppl = float(np.exp(total_nll / total_tokens))
    logger.info("perplexity: %s", ppl)
    return ppl


def perplexity_eval(
    model,
    params,
    model_id: str | None = None,
    tokens_path: str | None = None,
    text_path: str | None = None,
    max_length: int = 2048,
    stride: int = 512,
    mesh=None,
) -> float:
    """Resolve a token stream (dataset / text file / .npy) and evaluate."""
    if tokens_path is not None:
        input_ids = np.load(tokens_path)
    elif text_path is not None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_id)
        text = open(text_path).read()
        input_ids = tokenizer(text, return_tensors="np").input_ids[0]
    else:
        input_ids = load_wikitext_tokens(model_id)
    return perplexity_from_tokens(model, params, input_ids, max_length, stride,
                                  mesh=mesh)


def main():
    parser = argparse.ArgumentParser()
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--checkpoint",
                        help="Path to a framework checkpoint (see checkpoint.py).")
    source.add_argument("--hf-weights",
                        help="HF safetensors dir for google/gemma-3-270m: "
                             "score the fp32 model without a checkpoint.")
    parser.add_argument("--model-id", default="google/gemma-3-270m")
    parser.add_argument("--tokens", default=None, help="Pre-tokenized .npy file.")
    parser.add_argument("--text", default=None, help="Raw text file to tokenize.")
    parser.add_argument("--max-length", type=int, default=2048)
    parser.add_argument("--stride", type=int, default=512)
    parser.add_argument("--cpu", action="store_true",
                        help="Force the CPU backend (some environments pin an "
                             "accelerator platform before env vars are read).")
    args = parser.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    if args.hf_weights:
        from onnx_quantize_tpu.models.gemma3 import GEMMA3_270M, Gemma3
        from onnx_quantize_tpu.models.import_hf import load_gemma3_hf

        model = Gemma3(GEMMA3_270M)
        params = load_gemma3_hf(model, args.hf_weights)
    else:
        from onnx_quantize_tpu.checkpoint import load_checkpoint

        model, params = load_checkpoint(args.checkpoint)
    ppl = perplexity_eval(
        model, params, model_id=args.model_id, tokens_path=args.tokens,
        text_path=args.text, max_length=args.max_length, stride=args.stride,
    )
    # Explicit print: under ``python -m`` this module's logger is named
    # __main__ (outside the package logging config), so INFO lines are silent.
    print(f"perplexity: {ppl:.4f}")


if __name__ == "__main__":
    main()
