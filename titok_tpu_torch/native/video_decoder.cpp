// Video decode/encode via FFmpeg's libav* C libraries (a copy of the JAX
// package's native/video_decoder.cpp, built with frame_resize.cpp into the
// "av" library by titok_tpu_torch/data/_native.py and linked against libav
// through pkg-config).
//
// Host-side random-access mp4 decode in place of the reference's decord
// (reference dataset/video_dataset.py:5,66 / video_dataset_csv.py:5,57),
// feeding the packer. The C API below is consumed through ctypes
// (titok_tpu_torch/data/video_reader.py).
//
// Design notes:
// - open() demuxes the whole file once to index frame PTS values (decord
//   builds the same index); frame i == i-th smallest PTS, which handles
//   B-frame reordering.
// - get_batch(indices) seeks to the nearest preceding keyframe per target
//   and decodes forward, converting to packed RGB24 via swscale.
// - encode() provides a minimal fixed-fps RGB encoder (mpeg4 by default)
//   for the convert_to_wds tool and for tests.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace {

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", msg.c_str());
  }
}

std::string av_err(int code) {
  char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(code, buf, sizeof(buf));
  return std::string(buf);
}

struct BytesIO {
  const uint8_t* data;
  int64_t size;
  int64_t pos;
};

int bytes_read(void* opaque, uint8_t* buf, int buf_size) {
  BytesIO* io = static_cast<BytesIO*>(opaque);
  int64_t remain = io->size - io->pos;
  if (remain <= 0) return AVERROR_EOF;
  int n = static_cast<int>(std::min<int64_t>(buf_size, remain));
  std::memcpy(buf, io->data + io->pos, n);
  io->pos += n;
  return n;
}

int64_t bytes_seek(void* opaque, int64_t offset, int whence) {
  BytesIO* io = static_cast<BytesIO*>(opaque);
  switch (whence) {
    case SEEK_SET: io->pos = offset; break;
    case SEEK_CUR: io->pos += offset; break;
    case SEEK_END: io->pos = io->size + offset; break;
    case AVSEEK_SIZE: return io->size;
    default: return -1;
  }
  return io->pos;
}

}  // namespace

struct VDContext {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  AVIOContext* avio = nullptr;
  BytesIO* bytes = nullptr;
  std::vector<uint8_t> owned_bytes;
  int stream_idx = -1;
  int width = 0, height = 0;
  double fps = 0.0;
  std::vector<int64_t> pts_index;  // sorted pts of every frame
};

extern "C" {

void vd_close(VDContext* ctx) {
  if (!ctx) return;
  if (ctx->sws) sws_freeContext(ctx->sws);
  if (ctx->dec) avcodec_free_context(&ctx->dec);
  if (ctx->fmt) avformat_close_input(&ctx->fmt);
  if (ctx->avio) {
    av_freep(&ctx->avio->buffer);
    avio_context_free(&ctx->avio);
  }
  delete ctx->bytes;
  delete ctx;
}

static VDContext* vd_open_common(VDContext* ctx, char* err, int errlen) {
  int ret = avformat_find_stream_info(ctx->fmt, nullptr);
  if (ret < 0) {
    set_err(err, errlen, "find_stream_info: " + av_err(ret));
    vd_close(ctx);
    return nullptr;
  }
  ctx->stream_idx = av_find_best_stream(ctx->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                        nullptr, 0);
  if (ctx->stream_idx < 0) {
    set_err(err, errlen, "no video stream");
    vd_close(ctx);
    return nullptr;
  }
  AVStream* st = ctx->fmt->streams[ctx->stream_idx];
  const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!codec) {
    set_err(err, errlen, "no decoder for codec");
    vd_close(ctx);
    return nullptr;
  }
  ctx->dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(ctx->dec, st->codecpar);
  ctx->dec->thread_count = 0;  // auto
  if ((ret = avcodec_open2(ctx->dec, codec, nullptr)) < 0) {
    set_err(err, errlen, "codec open: " + av_err(ret));
    vd_close(ctx);
    return nullptr;
  }
  ctx->width = ctx->dec->width;
  ctx->height = ctx->dec->height;
  AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
  ctx->fps = r.den ? av_q2d(r) : 0.0;

  // index every frame's pts by demuxing once
  AVPacket* pkt = av_packet_alloc();
  while (av_read_frame(ctx->fmt, pkt) >= 0) {
    if (pkt->stream_index == ctx->stream_idx) {
      int64_t ts = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
      ctx->pts_index.push_back(ts);
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  std::sort(ctx->pts_index.begin(), ctx->pts_index.end());

  // rewind for decoding
  av_seek_frame(ctx->fmt, ctx->stream_idx, ctx->pts_index.empty() ? 0 : ctx->pts_index[0],
                AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(ctx->dec);

  ctx->sws = sws_getContext(ctx->width, ctx->height, ctx->dec->pix_fmt,
                            ctx->width, ctx->height, AV_PIX_FMT_RGB24,
                            SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!ctx->sws) {
    set_err(err, errlen, "swscale init failed");
    vd_close(ctx);
    return nullptr;
  }
  return ctx;
}

VDContext* vd_open_file(const char* path, char* err, int errlen) {
  VDContext* ctx = new VDContext();
  int ret = avformat_open_input(&ctx->fmt, path, nullptr, nullptr);
  if (ret < 0) {
    set_err(err, errlen, "open: " + av_err(ret));
    delete ctx;
    return nullptr;
  }
  return vd_open_common(ctx, err, errlen);
}

VDContext* vd_open_bytes(const uint8_t* data, int64_t size, char* err,
                         int errlen) {
  VDContext* ctx = new VDContext();
  ctx->owned_bytes.assign(data, data + size);
  ctx->bytes = new BytesIO{ctx->owned_bytes.data(), size, 0};
  unsigned char* buf = static_cast<unsigned char*>(av_malloc(1 << 16));
  ctx->avio = avio_alloc_context(buf, 1 << 16, 0, ctx->bytes, bytes_read,
                                 nullptr, bytes_seek);
  ctx->fmt = avformat_alloc_context();
  ctx->fmt->pb = ctx->avio;
  int ret = avformat_open_input(&ctx->fmt, nullptr, nullptr, nullptr);
  if (ret < 0) {
    set_err(err, errlen, "open bytes: " + av_err(ret));
    vd_close(ctx);
    return nullptr;
  }
  return vd_open_common(ctx, err, errlen);
}

int64_t vd_num_frames(VDContext* ctx) {
  return static_cast<int64_t>(ctx->pts_index.size());
}
double vd_fps(VDContext* ctx) { return ctx->fps; }
int vd_width(VDContext* ctx) { return ctx->width; }
int vd_height(VDContext* ctx) { return ctx->height; }

// Decode frames at the given (ascending or not) indices into out
// [n, H, W, 3] RGB24. Returns 0 on success.
int vd_get_batch(VDContext* ctx, const int64_t* indices, int n, uint8_t* out,
                 char* err, int errlen) {
  const int64_t total = static_cast<int64_t>(ctx->pts_index.size());
  const size_t frame_bytes =
      static_cast<size_t>(ctx->width) * ctx->height * 3;

  // process in ascending order, remember output positions
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return indices[a] < indices[b];
  });

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int64_t cur_decoded_pts = INT64_MIN;
  bool positioned = false;
  int ret = 0;

  auto decode_to_pts = [&](int64_t target_pts, uint8_t* dst) -> int {
    while (true) {
      int r = avcodec_receive_frame(ctx->dec, frame);
      if (r == 0) {
        int64_t fpts = frame->best_effort_timestamp != AV_NOPTS_VALUE
                           ? frame->best_effort_timestamp
                           : frame->pts;
        cur_decoded_pts = fpts;
        if (fpts >= target_pts) {
          // sws_scale's SIMD paths can write past an unpadded stride; go
          // through an aligned scratch image and copy rows out.
          uint8_t* planes[4] = {nullptr};
          int strides[4] = {0};
          av_image_alloc(planes, strides, ctx->width, ctx->height,
                         AV_PIX_FMT_RGB24, 64);
          sws_scale(ctx->sws, frame->data, frame->linesize, 0, ctx->height,
                    planes, strides);
          for (int y = 0; y < ctx->height; ++y) {
            std::memcpy(dst + static_cast<size_t>(y) * ctx->width * 3,
                        planes[0] + static_cast<size_t>(y) * strides[0],
                        static_cast<size_t>(ctx->width) * 3);
          }
          av_freep(&planes[0]);
          av_frame_unref(frame);
          return 0;
        }
        av_frame_unref(frame);
        continue;
      }
      if (r == AVERROR(EAGAIN)) {
        int rr = av_read_frame(ctx->fmt, pkt);
        if (rr < 0) {
          avcodec_send_packet(ctx->dec, nullptr);  // flush
          continue;
        }
        if (pkt->stream_index == ctx->stream_idx) {
          avcodec_send_packet(ctx->dec, pkt);
        }
        av_packet_unref(pkt);
        continue;
      }
      if (r == AVERROR_EOF) return AVERROR_EOF;
      return r;
    }
  };

  for (int oi = 0; oi < n; ++oi) {
    int64_t idx = indices[order[oi]];
    if (idx < 0 || idx >= total) {
      set_err(err, errlen, "frame index out of range");
      ret = -1;
      break;
    }
    int64_t target_pts = ctx->pts_index[idx];
    // seek only when going backwards or jumping far ahead
    if (!positioned || target_pts < cur_decoded_pts ||
        (idx > 0 && target_pts - cur_decoded_pts >
             (ctx->pts_index[1] - ctx->pts_index[0] + 1) * 300)) {
      av_seek_frame(ctx->fmt, ctx->stream_idx, target_pts,
                    AVSEEK_FLAG_BACKWARD);
      avcodec_flush_buffers(ctx->dec);
      cur_decoded_pts = INT64_MIN;
      positioned = true;
    }
    int r = decode_to_pts(target_pts,
                          out + frame_bytes * static_cast<size_t>(order[oi]));
    if (r != 0) {
      set_err(err, errlen, "decode: " + av_err(r));
      ret = -1;
      break;
    }
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  return ret;
}

// Minimal fixed-fps RGB video encoder (for tooling/tests).
// frames: [t, h, w, 3] RGB24. codec_name: e.g. "mpeg4".
int vd_encode_video(const char* path, const uint8_t* frames, int t, int h,
                    int w, double fps, const char* codec_name, char* err,
                    int errlen) {
  AVFormatContext* fmt = nullptr;
  int ret = avformat_alloc_output_context2(&fmt, nullptr, nullptr, path);
  if (ret < 0 || !fmt) {
    set_err(err, errlen, "alloc output: " + av_err(ret));
    return -1;
  }
  const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
  if (!codec) {
    set_err(err, errlen, std::string("no encoder: ") + codec_name);
    avformat_free_context(fmt);
    return -1;
  }
  AVStream* st = avformat_new_stream(fmt, nullptr);
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  enc->width = w;
  enc->height = h;
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  AVRational rate = av_d2q(fps, 100000);
  enc->time_base = av_inv_q(rate);
  enc->framerate = rate;
  enc->gop_size = 12;
  enc->bit_rate = static_cast<int64_t>(w) * h * 4;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

  if ((ret = avcodec_open2(enc, codec, nullptr)) < 0) {
    set_err(err, errlen, "encoder open: " + av_err(ret));
    avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return -1;
  }
  avcodec_parameters_from_context(st->codecpar, enc);
  st->time_base = enc->time_base;

  if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
    if ((ret = avio_open(&fmt->pb, path, AVIO_FLAG_WRITE)) < 0) {
      set_err(err, errlen, "avio open: " + av_err(ret));
      avcodec_free_context(&enc);
      avformat_free_context(fmt);
      return -1;
    }
  }
  avformat_write_header(fmt, nullptr);

  SwsContext* sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h,
                                   AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                                   nullptr, nullptr);
  AVFrame* frame = av_frame_alloc();
  frame->format = AV_PIX_FMT_YUV420P;
  frame->width = w;
  frame->height = h;
  av_frame_get_buffer(frame, 0);
  AVPacket* pkt = av_packet_alloc();

  auto flush_enc = [&](AVFrame* f) {
    avcodec_send_frame(enc, f);
    while (avcodec_receive_packet(enc, pkt) == 0) {
      if (pkt->duration == 0) pkt->duration = 1;  // one tick of enc time_base
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
      av_packet_unref(pkt);
    }
  };

  const size_t frame_bytes = static_cast<size_t>(w) * h * 3;
  for (int i = 0; i < t; ++i) {
    av_frame_make_writable(frame);
    const uint8_t* src[1] = {frames + frame_bytes * i};
    int src_stride[1] = {w * 3};
    sws_scale(sws, src, src_stride, 0, h, frame->data, frame->linesize);
    frame->pts = i;
    flush_enc(frame);
  }
  flush_enc(nullptr);

  av_write_trailer(fmt);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  sws_freeContext(sws);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&enc);
  avformat_free_context(fmt);
  return 0;
}

}  // extern "C"
