// Fused host-side patchify + normalize + pack (a copy of the JAX package's
// native/packer.cpp, built by titok_tpu_torch/data/_native.py as the "pack"
// library, which needs no other library).
//
// Turns decoded uint8 THWC frames into [-1, 1] float32 patch rows in one
// pass: for each output patch row it walks the (p0, p1, p2, c) layout
// gathering source pixels, normalizing and writing float32 (the caller
// rounds to bf16 where the wire asks for it).
//
// Layout contract (== titok_tpu_torch/ops/patchify.py, reference
// model/base/utils.py:26-39): row index = (d0*g1 + d1)*g2 + d2, column
// index = ((p0*P1 + p1)*P2 + p2)*C + c, with source frames in THWC uint8.
//
// Built with -ffp-contract=off: `x * (2/255) - 1` stays two roundings, so
// the rows equal ops/patchify.py:decode_rows of the raw bytes bit for bit
// on any host compiler (an FMA would round once).

#include <cstdint>
#include <cstddef>

extern "C" {

// frames: [T, H, W, C] uint8 (decoded video chunk)
// out: [grid_size, P] float32 rows starting at out (caller offsets)
// Returns 0.
int pk_patchify_normalize(const uint8_t* frames, int T, int H, int W, int C,
                          int p0, int p1, int p2, float* out) {
  const int g0 = T / p0, g1 = H / p1, g2 = W / p2;
  const int P = p0 * p1 * p2 * C;
  const float scale = 2.0f / 255.0f;

  for (int d0 = 0; d0 < g0; ++d0) {
    for (int d1 = 0; d1 < g1; ++d1) {
      for (int d2 = 0; d2 < g2; ++d2) {
        float* row = out + (static_cast<size_t>(d0) * g1 * g2 +
                            static_cast<size_t>(d1) * g2 + d2) * P;
        int col = 0;
        for (int a = 0; a < p0; ++a) {
          const int t = d0 * p0 + a;
          for (int b = 0; b < p1; ++b) {
            const int y = d1 * p1 + b;
            const uint8_t* src_row = frames +
                ((static_cast<size_t>(t) * H + y) * W + d2 * p2) * C;
            for (int cpx = 0; cpx < p2 * C; ++cpx) {
              row[col++] = src_row[cpx] * scale - 1.0f;
            }
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
