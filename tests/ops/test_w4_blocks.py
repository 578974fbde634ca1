"""Shape sweep for the W4 kernel's launch-geometry picker.

``matmul_w4.pick_blocks`` chooses (bm, bn, bk, split_k, stages) for the
Triton route. These tests pin it against the full model-zoo shape family
(Gemma-3 270M/1B/4B sites x group sizes x decode/prefill M) so the next shape
family cannot silently mis-size a block:

* every block fits Hopper's 227 KB of shared memory per block;
* block sizes are powers of two, with >= 16 rows for the tensor cores;
* the grid covers all of N and all group pairs exactly once;
* at decode, the grid fills the card's 132 SMs wherever the shape allows.
"""

import pytest

from onnx_quantize_tpu.models.gemma3 import GEMMA3_1B, GEMMA3_4B, GEMMA3_270M
from onnx_quantize_tpu.ops.kernels.matmul_w4 import (
    NUM_SMS,
    SMEM_LIMIT,
    pick_blocks,
    smem_bytes,
)


def zoo_shapes():
    """(label, K, N) for every Linear site in the Gemma-3 family."""
    out = []
    for name, cfg in [("270m", GEMMA3_270M), ("1b", GEMMA3_1B), ("4b", GEMMA3_4B)]:
        h, inter = cfg.hidden_size, cfg.intermediate_size
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sites = {
            "q": (h, hq * d),
            "kv": (h, hkv * d),
            "qkv_fused": (h, (hq + 2 * hkv) * d),
            "o": (hq * d, h),
            "gate_up": (h, 2 * inter),
            "down": (inter, h),
            "lm_head": (h, cfg.vocab_size),
        }
        out.extend((f"{name}/{site}", K, N) for site, (K, N) in sites.items())
    return out


def _pow2(n):
    return n > 0 and n & (n - 1) == 0


def _n_pairs(K, gs):
    return -(-K // (2 * gs))


@pytest.mark.parametrize("label,K,N", zoo_shapes())
@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("M", [8, 32, 64, 256])
def test_zoo_choices_fit_smem(label, K, N, gs, M):
    n_pairs = _n_pairs(K, gs)
    for itemsize in (2, 4):  # bf16 and f32 activations
        b = pick_blocks(M, N, gs, n_pairs, itemsize)
        assert smem_bytes(b, itemsize) <= SMEM_LIMIT
        assert all(_pow2(v) for v in (b.bm, b.bn, b.bk))
        assert b.bm >= 16 and b.bk >= 16 and b.bn >= 32
        assert gs % b.bk == 0
        assert N % b.bn == 0  # the N blocks tile all of N
        assert n_pairs % b.split_k == 0  # each pair in exactly one split
        assert b.num_stages >= 2


@pytest.mark.parametrize("label,K,N", zoo_shapes())
def test_decode_grid_fills_the_card(label, K, N):
    """At decode (M = 32, bf16) the grid has at least one block per SM
    unless the shape has no more to give (every group pair in its own
    split)."""
    gs = 128
    n_pairs = _n_pairs(K, gs)
    b = pick_blocks(32, N, gs, n_pairs, 2)
    blocks = (N // b.bn) * b.split_k
    assert blocks >= NUM_SMS or b.split_k == n_pairs
