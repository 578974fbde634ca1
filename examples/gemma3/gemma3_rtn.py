"""Quantize Gemma-3-270M with RTN int8 group-128, lm_head ignored.

Mirror of the reference example (``examples/gemma3/gemma3_rtn.py:47-59``)
on the JAX stack: instead of exporting ONNX via onnxruntime-genai and rewriting
the graph, we load (or randomly initialize) the JAX Gemma-3 params, run
``quantize()``, and save a framework checkpoint the engine can serve.

Usage:
    python examples/gemma3/gemma3_rtn.py --output qgemma3_rtn [--hf-weights DIR]
"""

import argparse

import jax

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.checkpoint import save_checkpoint
from onnx_quantize_tpu.models.gemma3 import GEMMA3_270M, Gemma3


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", default="qgemma3_rtn")
    parser.add_argument(
        "--hf-weights", default=None,
        help="Directory with HF safetensors for google/gemma-3-270m; random init if omitted.",
    )
    args = parser.parse_args()

    model = Gemma3(GEMMA3_270M)
    if args.hf_weights:
        from onnx_quantize_tpu.models.import_hf import load_gemma3_hf

        params = load_gemma3_hf(model, args.hf_weights)
    else:
        params = model.init(jax.random.key(0))

    qconfig = oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=128),
        ignore=["lm_head"],
    )
    qparams, plan = oqt.quantize(model, params, qconfig)
    save_checkpoint(args.output, model, qparams, plan)
    print(f"saved quantized checkpoint to {args.output}")


if __name__ == "__main__":
    main()
