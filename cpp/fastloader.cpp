// Native data-loader kernels for wavenet_tpu (C++17, no external deps).
//
// The reference's data path is pure-Python NumPy (SURVEY.md §2 #2); at
// scale the host input pipeline becomes the bottleneck long before the
// accelerator does, so the hot host-side ops live here:
//   * mulaw_encode: float waveform -> int32 mu-law class ids
//   * mulaw_decode: int32 ids -> float waveform
//   * gather_windows: batched strided window gather out of encoded clips
//     (the per-step crop batch assembly), multi-threaded
//
// Built as a plain shared library; bound from Python with ctypes
// (wavenet_tpu/cpp/loader.py).  Exact same rounding semantics as
// audio/mulaw.py (round-half-even like NumPy) — asserted bit-identical in
// tests/test_cpp_loader.py.

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// y = round_half_even((sign(x)*log1p(mu|x|)/log1p(mu) + 1)/2 * mu)
//
// Precision mirrors audio/mulaw.py encode_np under NumPy 2 (NEP 50) exactly:
// the companding log1p runs in float32 (mu*|x| and sign(x)*log1p(...) stay
// float32 because python-int/float operands are weak), then the division by
// np.log1p(mu) — a strong float64 scalar — promotes to float64, as does
// everything after.  Rounding is an explicit half-even (no dependence on the
// process FP rounding mode, unlike nearbyint — advisor r1 #4).  Residual
// risk is libm-vs-numpy ulp drift in log1pf, which tests/test_cpp_loader.py
// pins by asserting bit-identity on this platform.
static inline double round_half_even(double v) {
  // v >= 0 here (the companded value is affinely mapped into [0, mu])
  double fl = std::floor(v);
  double diff = v - fl;
  if (diff > 0.5) return fl + 1.0;
  if (diff < 0.5) return fl;
  return (std::fmod(fl, 2.0) == 0.0) ? fl : fl + 1.0;
}

void mulaw_encode(const float* x, int64_t n, int32_t q_channels,
                  int32_t* out) {
  const float muf = static_cast<float>(q_channels - 1);
  const double mu = q_channels - 1;
  const double denom = std::log1p(mu);
  for (int64_t i = 0; i < n; ++i) {
    float v = x[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    float c32 = (v >= 0.0f ? 1.0f : -1.0f) * std::log1p(muf * std::fabs(v));
    double c = static_cast<double>(c32) / denom;
    double scaled = (c + 1.0) / 2.0 * mu;
    out[i] = static_cast<int32_t>(round_half_even(scaled));
  }
}

void mulaw_decode(const int32_t* q, int64_t n, int32_t q_channels,
                  float* out) {
  const double mu = q_channels - 1;
  const float muf = static_cast<float>(q_channels - 1);
  const double lg = std::log1p(mu);
  for (int64_t i = 0; i < n; ++i) {
    // NumPy mirror (decode_np) computes c in float32 (python-float/int
    // operands are weak under NEP 50), then expands in float64 via the
    // strong np.log1p(mu) scalar — mirror that exactly for bit-identity
    float c32 = 2.0f * static_cast<float>(q[i]) / muf - 1.0f;
    double c = static_cast<double>(c32);
    double v = (c >= 0 ? 1.0 : -1.0) * std::expm1(std::fabs(c) * lg) / mu;
    out[i] = static_cast<float>(v);
  }
}

// Gather B windows of length W: out[b, :] = clips[clip_idx[b]][start[b] : +W]
// clip_ptrs: array of B pointers? Simpler: flat concatenated clip buffer with
// per-clip offsets; callers pass (flat, clip_offsets) once.
void gather_windows(const int32_t* flat, const int64_t* clip_offsets,
                    const int32_t* clip_idx, const int64_t* starts,
                    int64_t batch, int64_t window, int32_t* out,
                    int32_t num_threads) {
  auto work = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      const int32_t* src = flat + clip_offsets[clip_idx[b]] + starts[b];
      int32_t* dst = out + b * window;
      for (int64_t i = 0; i < window; ++i) dst[i] = src[i];
    }
  };
  if (num_threads <= 1 || batch < 4) {
    work(0, batch);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (batch + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(batch, b0 + per);
    if (b0 >= b1) break;
    ts.emplace_back(work, b0, b1);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
