// Host-side native helpers of uivr_tpu_torch (C++17, no external deps): the
// envmap's alias table, the EXR ZIP predictors and Radiance HDR scanline
// decoding, behind a plain C ABI for ctypes.  uivr_tpu_torch/native/__init__.py
// builds this file with g++ at first use (-O3 -shared -fPIC -std=c++17) and
// holds the Python versions it replaces as the plain versions.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Walker/Vose alias-table construction, O(N).  Replaces the Python loop of
// scene/emitters.make_envmap, which takes seconds on multi-megatexel maps
// (a 4k map has 8M texels); pops in the same order, so the tables are equal.
// ---------------------------------------------------------------------------
void build_alias_table(const double* pmf, int64_t n, int32_t* alias,
                       float* prob) {
  std::vector<double> scaled(n);
  for (int64_t i = 0; i < n; ++i) scaled[i] = pmf[i] * (double)n;
  std::vector<int64_t> small, large;
  small.reserve(n);
  large.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    alias[i] = (int32_t)i;
    prob[i] = 1.0f;
    (scaled[i] < 1.0 ? small : large).push_back(i);
  }
  while (!small.empty() && !large.empty()) {
    int64_t s = small.back();
    small.pop_back();
    int64_t l = large.back();
    large.pop_back();
    prob[s] = (float)scaled[s];
    alias[s] = (int32_t)l;
    scaled[l] -= (1.0 - scaled[s]);
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  // leftovers are numerically ~1
  for (int64_t i : small) prob[i] = 1.0f;
  for (int64_t i : large) prob[i] = 1.0f;
}

// ---------------------------------------------------------------------------
// OpenEXR ZIP pre/post filters: interleave-split + byte delta coding
// (core/exr_io.py, for every ZIP chunk written and read).
// ---------------------------------------------------------------------------
void exr_zip_predict(const uint8_t* src, int64_t n, uint8_t* dst) {
  if (n <= 0) return;
  int64_t half = (n + 1) / 2;
  // reorder: even bytes then odd bytes
  for (int64_t i = 0, j = 0; i < n; i += 2, ++j) dst[j] = src[i];
  for (int64_t i = 1, j = half; i < n; i += 2, ++j) dst[j] = src[i];
  // delta encode in place
  uint8_t prev = dst[0];
  for (int64_t i = 1; i < n; ++i) {
    uint8_t cur = dst[i];
    dst[i] = (uint8_t)((int)cur - (int)prev + 128 + 256);
    prev = cur;
  }
}

void exr_zip_unpredict(const uint8_t* src, int64_t n, uint8_t* dst) {
  if (n <= 0) return;
  std::vector<uint8_t> rec(n);
  rec[0] = src[0];
  for (int64_t i = 1; i < n; ++i)
    rec[i] = (uint8_t)((int)rec[i - 1] + (int)src[i] - 128);
  int64_t half = (n + 1) / 2;
  for (int64_t i = 0, j = 0; j < half; i += 2, ++j) dst[i] = rec[j];
  for (int64_t i = 1, j = half; j < n; i += 2, ++j) dst[i] = rec[j];
}

// ---------------------------------------------------------------------------
// Radiance RGBE (.hdr) scanline decode (core/hdr_io.py: the paper's 2k-4k
// maps hold up to 8M pixels).  Decodes ALL scanlines (new-style
// per-component RLE or flat/old-style runs) into H*W*4 RGBE bytes.
// Returns 0 on success, -1 on malformed input (the caller then runs the
// Python reader, which raises a precise error).
// ---------------------------------------------------------------------------
int hdr_decode_scanlines(const uint8_t* src, int64_t n, int64_t W, int64_t H,
                         uint8_t* out /* H*W*4 */) {
  int64_t i = 0;
  for (int64_t y = 0; y < H; ++y) {
    uint8_t* row = out + y * W * 4;
    if (W >= 8 && W < 32768 && i + 4 <= n && src[i] == 2 && src[i + 1] == 2 &&
        ((int64_t)src[i + 2] << 8 | src[i + 3]) == W) {
      i += 4;  // new-style RLE: 4 component planes
      for (int c = 0; c < 4; ++c) {
        int64_t x = 0;
        while (x < W) {
          if (i >= n) return -1;
          int64_t cnt = src[i];
          if (cnt > 128) {  // run
            cnt -= 128;
            if (i + 1 >= n || x + cnt > W) return -1;
            uint8_t v = src[i + 1];
            for (int64_t k = 0; k < cnt; ++k) row[(x + k) * 4 + c] = v;
            i += 2;
          } else {  // literal
            if (i + 1 + cnt > n || x + cnt > W) return -1;
            for (int64_t k = 0; k < cnt; ++k)
              row[(x + k) * 4 + c] = src[i + 1 + k];
            i += 1 + cnt;
          }
          x += cnt;
        }
      }
    } else {  // flat pixels with old-style (1,1,1,n) run markers
      int64_t x = 0;
      int rshift = 0;  // consecutive markers shift the count 8 bits each
      while (x < W) {
        if (i + 4 > n) return -1;
        if (src[i] == 1 && src[i + 1] == 1 && src[i + 2] == 1 && x > 0) {
          if (rshift > 24) return -1;  // corrupt: shift would overflow
          int64_t cnt = (int64_t)src[i + 3] << rshift;
          if (x + cnt > W) return -1;
          for (int64_t k = 0; k < cnt; ++k)
            std::memcpy(row + (x + k) * 4, row + (x - 1) * 4, 4);
          x += cnt;
          rshift += 8;
        } else {
          std::memcpy(row + x * 4, src + i, 4);
          x += 1;
          rshift = 0;
        }
        i += 4;
      }
    }
  }
  return 0;
}

}  // extern "C"
