// Native host-side kernels for onnx_quantize_tpu.
//
// The reference delegates its native compute to ONNX Runtime's C++ kernels
// (SURVEY.md §2B); on this build the *device* compute path is XLA/Pallas,
// and this library covers the host-side runtime work that would otherwise be
// slow Python/numpy: 4-bit group-pair nibble packing for multi-hundred-MB
// weight tensors at checkpoint save/load time, and the per-row min/max
// reductions the calibrator and RTN planner run over large activations.
//
// Built as a plain C ABI shared object consumed through ctypes
// (onnx_quantize_tpu/native.py); no pybind11 dependency.

#include <cstdint>
#include <cstring>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Pack (K, N) int8 container values (4-bit range) into the group-pair nibble
// layout: packed row p*gs + r holds logical row (2p)*gs + r in the low nibble
// and (2p+1)*gs + r in the high nibble. Logical rows past K read as zero.
// out has shape (n_groups_pad/2 * gs, N).
void oqt_pack_group_pairs(const int8_t* q, uint8_t* out, int64_t K, int64_t N,
                          int64_t gs, int64_t n_groups_pad) {
  const int64_t half_groups = n_groups_pad / 2;
  // Parallel over packed rows (independent); the byte-wise inner loop
  // auto-vectorizes under -O3 (simple AND/OR/shift over contiguous bytes).
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static) if (half_groups * gs * N > (1 << 20))
#endif
  for (int64_t p = 0; p < half_groups; ++p) {
    for (int64_t r = 0; r < gs; ++r) {
      const int64_t low_row = (2 * p) * gs + r;
      const int64_t high_row = (2 * p + 1) * gs + r;
      uint8_t* dst = out + (p * gs + r) * N;
      const int8_t* low_src = low_row < K ? q + low_row * N : nullptr;
      const int8_t* high_src = high_row < K ? q + high_row * N : nullptr;
      if (low_src && high_src) {
        // Hot path: branch-free, vectorizable.
#ifdef _OPENMP
#pragma omp simd
#endif
        for (int64_t n = 0; n < N; ++n) {
          dst[n] = static_cast<uint8_t>(
              (static_cast<uint8_t>(low_src[n]) & 0x0F) |
              ((static_cast<uint8_t>(high_src[n]) & 0x0F) << 4));
        }
      } else {
        for (int64_t n = 0; n < N; ++n) {
          const uint8_t lo = low_src ? static_cast<uint8_t>(low_src[n]) & 0x0F : 0;
          const uint8_t hi = high_src ? static_cast<uint8_t>(high_src[n]) & 0x0F : 0;
          dst[n] = static_cast<uint8_t>(lo | (hi << 4));
        }
      }
    }
  }
}

// Inverse of oqt_pack_group_pairs: out is (K, N) int8 container values.
// signed_ != 0 applies two's-complement nibble decoding ([8,15] -> [-8,-1]).
void oqt_unpack_group_pairs(const uint8_t* packed, int8_t* out, int64_t K,
                            int64_t N, int64_t gs, int signed_) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (K * N > (1 << 20))
#endif
  for (int64_t row = 0; row < K; ++row) {
    const int64_t p = row / (2 * gs);
    const int64_t within = row % (2 * gs);
    const bool high = within >= gs;
    const int64_t r = high ? within - gs : within;
    const uint8_t* src = packed + (p * gs + r) * N;
    int8_t* dst = out + row * N;
    const int shift = high ? 4 : 0;
    if (signed_) {
#ifdef _OPENMP
#pragma omp simd
#endif
      for (int64_t n = 0; n < N; ++n) {
        // Sign-extend the nibble: (v ^ 8) - 8 maps [8,15] -> [-8,-1].
        const int v = (src[n] >> shift) & 0x0F;
        dst[n] = static_cast<int8_t>((v ^ 8) - 8);
      }
    } else {
#ifdef _OPENMP
#pragma omp simd
#endif
      for (int64_t n = 0; n < N; ++n) {
        dst[n] = static_cast<int8_t>((src[n] >> shift) & 0x0F);
      }
    }
  }
}

// Per-row min/max over a (rows, cols) float32 array — the hot reduction in
// RTN/channel/group qparam computation and the MinMax calibrator.
void oqt_minmax_rows(const float* x, float* mins, float* maxs, int64_t rows,
                     int64_t cols) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (rows * cols > (1 << 20))
#endif
  for (int64_t r = 0; r < rows; ++r) {
    const float* row = x + r * cols;
    float mn = row[0], mx = row[0];
#ifdef _OPENMP
#pragma omp simd reduction(min : mn) reduction(max : mx)
#endif
    for (int64_t c = 0; c < cols; ++c) {
      mn = std::min(mn, row[c]);
      mx = std::max(mx, row[c]);
    }
    mins[r] = mn;
    maxs[r] = mx;
  }
}

// Global min/max (the per-tensor calibrator path).
void oqt_minmax_all(const float* x, int64_t size, float* out_min, float* out_max) {
  float mn = x[0], mx = x[0];
#ifdef _OPENMP
#pragma omp parallel for simd schedule(static) reduction(min : mn) \
    reduction(max : mx) if (size > (1 << 20))
#endif
  for (int64_t i = 0; i < size; ++i) {
    mn = std::min(mn, x[i]);
    mx = std::max(mx, x[i]);
  }
  *out_min = mn;
  *out_max = mx;
}

}  // extern "C"
