"""ONE command for the real-weights wikitext-2 parity gate.

Reproduces the reference's headline accuracy table
(``/root/reference/examples/gemma3/README.md:27-33``) on google/gemma-3-270m:

    fp32            16.77
    RTN  int8 g128  16.79   (ignore lm_head)
    AWQ  uint4 g128 21.24

against BASELINE.md's gate (quantized ppl within 0.1 of the reference's
quantized ppl at matched config). Usage, once a checkpoint is reachable:

    PYTHONPATH=/root/repo python scripts/parity_gemma3_ppl.py \
        --hf-weights /path/to/gemma-3-270m \
        [--tokens wikitext2_test.npy] [--cpu] [--limit-windows N]

Token source: ``--tokens`` (pre-tokenized .npy, air-gap friendly) or the
wikitext-2 HF dataset when a network/cache is available. The AWQ arm needs
calibration text; it reuses the evaluation stream's first windows (the
reference calibrates on wikitext train — note the difference in the output).

No gemma-3-270m checkpoint ships with the repo, so this command has not
produced numbers yet. Everything up to the checkpoint is verified: the
importer reproduces HF logits bit-for-argmax
(tests/models/test_import_hf.py::test_import_reproduces_hf_logits).
"""

import argparse
import json

import numpy as np

import jax


REFERENCE = {  # /root/reference/examples/gemma3/README.md:27-33
    "fp32": 16.77,
    "rtn_int8_g128": 16.79,
    "awq_uint4_g128": 21.24,
}
GATE = 0.1  # BASELINE.md: quantized ppl within 0.1 at matched config


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--hf-weights", required=True,
                        help="Local HF safetensors dir for google/gemma-3-270m.")
    parser.add_argument("--tokens", default=None,
                        help="Pre-tokenized wikitext-2 test .npy (else HF dataset).")
    parser.add_argument("--model-id", default="google/gemma-3-270m")
    parser.add_argument("--max-length", type=int, default=2048)
    parser.add_argument("--stride", type=int, default=512)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--limit-windows", type=int, default=None,
                        help="Evaluate only the first N windows (smoke runs).")
    parser.add_argument("--calib-windows", type=int, default=4,
                        help="Leading eval windows reused as AWQ calibration.")
    parser.add_argument("--config", default="270m", choices=["270m", "tiny"],
                        help="'tiny' runs the whole command on a test-sized "
                             "model (smoke/CI; gates are not meaningful).")
    args = parser.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import onnx_quantize_tpu as oqt
    from onnx_quantize_tpu.models.gemma3 import GEMMA3_270M, Gemma3
    from onnx_quantize_tpu.models.import_hf import load_gemma3_hf
    from onnx_quantize_tpu.tools.perplexity import (
        load_wikitext_tokens, perplexity_from_tokens,
    )

    if args.tokens:
        tokens = np.load(args.tokens)
    else:
        tokens = load_wikitext_tokens(args.model_id)
    if args.limit_windows is not None:
        tokens = tokens[: args.stride * args.limit_windows + args.max_length]

    if args.config == "270m":
        cfg = GEMMA3_270M
    else:
        cfg = type(GEMMA3_270M).tiny(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=2, num_kv_heads=1, head_dim=16, sliding_window=8,
            sliding_pattern=2,
        )

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        model = Gemma3(cfg)
        params = load_gemma3_hf(model, args.hf_weights)

        # Reference configs (examples/gemma3/gemma3_{rtn,awq}.py).
        q_rtn, _ = oqt.quantize(model, params, oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="int8", group_size=128),
            ignore=["lm_head"],
        ))
        seq = 256  # AWQ calibration sample length (examples/gemma3/gemma3_awq.py)
        calib = tokens[: seq * 8 * args.calib_windows]
        calib = calib[: len(calib) - len(calib) % seq]
        calib_ids = calib.reshape(-1, seq).astype(np.int32)
        q_awq, _ = oqt.quantize(model, params, oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", group_size=128),
            preprocessors=[oqt.AwqConfig()],
            ignore=["lm_head"],
            calibration_data=calib_ids,
            calibration_params=oqt.CalibrationParams(
                num_samples=len(calib_ids), batch_size=4
            ),
        ))

    dev = jax.devices()[0]
    rows = []
    for name, p in (("fp32", params), ("rtn_int8_g128", q_rtn),
                    ("awq_uint4_g128", q_awq)):
        p_dev = jax.tree.map(lambda a: jax.device_put(a, dev), p)
        ppl = perplexity_from_tokens(model, p_dev, tokens,
                                     max_length=args.max_length,
                                     stride=args.stride)
        full_run = args.limit_windows is None
        row = {
            "config": name,
            "ppl": round(float(ppl), 4),
            "reference_ppl": REFERENCE[name],
            "delta": round(float(ppl) - REFERENCE[name], 4),
            "gate_abs": GATE,
            "gate_pass": bool(abs(ppl - REFERENCE[name]) <= GATE) if full_run else None,
            "note": None if full_run else f"partial run ({args.limit_windows} windows)",
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"probe": "gemma3_270m_wikitext2_parity", "rows": rows}))


if __name__ == "__main__":
    main()
