// Fused crop + bicubic resize for uint8 RGB24 frame stacks, via libswscale
// (a copy of the JAX package's native/frame_resize.cpp, built with
// video_decoder.cpp into the "av" library by titok_tpu_torch/data/_native.py).
//
// The chunk sampler's RandomResizedCrop / Resize+CenterCrop (reference
// dataset/video_dataset.py:95-107 uses torchvision v2 BICUBIC
// antialias=true; swscale's bicubic scaler applies ratio-scaled filter
// taps, i.e. it is likewise antialiased on downscale).
//
// One SwsContext is built per call (per clip, dozens of frames), then reused
// across the frame loop; sws_scale runs SIMD paths and, called through
// ctypes, holds no Python state (the interpreter lock is released for the
// whole stack, so decode threads overlap).
//
// One change from the JAX package's copy: swscale's RGB24 input reads up to
// a pixel past the end of a source row (chroma is taken from pixel pairs, so
// an odd crop width reads one more). On the last row of the last frame that
// is past the end of `in` when the crop window ends at the frame's
// bottom-right corner (every full-frame resize), and the JAX copy's output
// then depends on whatever bytes follow the caller's buffer. Here that last
// frame is scaled from a copy padded with repeats of its last pixel, so
// nothing outside `in` is read; every other frame reads as before.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
#include <libswscale/swscale.h>
}

extern "C" {

// in:  [T, H, W, 3] uint8, C-contiguous
// crop window (cy, cx, ch, cw) within [H, W]
// out: [T, oh, ow, 3] uint8, C-contiguous
// Returns 0 on success.
int fr_resize_frames(const uint8_t* in, int64_t T, int H, int W,
                     int cy, int cx, int ch, int cw,
                     uint8_t* out, int oh, int ow) {
  if (!in || !out || T <= 0) return 1;
  if (cy < 0 || cx < 0 || ch <= 0 || cw <= 0 || cy + ch > H || cx + cw > W)
    return 2;
  if (oh <= 0 || ow <= 0) return 3;

  SwsContext* sws = sws_getContext(
      cw, ch, AV_PIX_FMT_RGB24, ow, oh, AV_PIX_FMT_RGB24,
      SWS_BICUBIC | SWS_ACCURATE_RND, nullptr, nullptr, nullptr);
  if (!sws) return 4;

  const int64_t in_frame = static_cast<int64_t>(H) * W * 3;
  const int64_t out_frame = static_cast<int64_t>(oh) * ow * 3;
  const int in_stride = W * 3;
  const int out_stride = ow * 3;

  constexpr int64_t kPad = 64;  // more than any over-read of a row's end
  std::vector<uint8_t> last;
  if (cy + ch == H && cx + cw == W) {
    last.resize(in_frame + kPad);
    std::memcpy(last.data(), in + (T - 1) * in_frame, in_frame);
    for (int64_t i = in_frame; i < in_frame + kPad; ++i) last[i] = last[i - 3];
  }

  for (int64_t t = 0; t < T; ++t) {
    const uint8_t* frame =
        (!last.empty() && t == T - 1) ? last.data() : in + t * in_frame;
    const uint8_t* src =
        frame + static_cast<int64_t>(cy) * in_stride + cx * 3;
    uint8_t* dst = out + t * out_frame;
    const uint8_t* src_planes[4] = {src, nullptr, nullptr, nullptr};
    uint8_t* dst_planes[4] = {dst, nullptr, nullptr, nullptr};
    const int src_strides[4] = {in_stride, 0, 0, 0};
    const int dst_strides[4] = {out_stride, 0, 0, 0};
    sws_scale(sws, src_planes, src_strides, 0, ch, dst_planes, dst_strides);
  }
  sws_freeContext(sws);
  return 0;
}

}  // extern "C"
