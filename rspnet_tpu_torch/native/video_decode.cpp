// Native video decoder (FFmpeg libav*), C API for ctypes: the port's copy
// of rspnet_tpu/native/video_decode.cpp, unchanged in what it computes.
//
// Replaces the reference's decord dependency (SURVEY.md §2.7): per-worker
// readers exposing open -> (num_frames, fps) and get_batch(indices) ->
// uint8 RGB frames, the exact contract of decord.VideoReader used at
// reference datasets/classification/video.py:57-75.
//
// Decode strategy: indices are sorted; we seek to the keyframe at/before the
// first needed frame, then decode forward, converting only requested frames
// to RGB24 via swscale. Frame numbering maps pts -> index with the stream's
// average frame rate (exact for fixed-fps transcodes, the reference's
// recommended data prep, utils/transcode_dataset.py).
//
// Build: rspnet_tpu_torch/native/video_decode.py builds it with g++ at first
// use into build/rspnet_tpu_torch/native/ (-lavformat -lavcodec -lavutil
// -lswscale).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstring>
#include <mutex>
#include <new>
#include <vector>

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVFrame* last_frame = nullptr;  // refcounted clone of the last decoded
                                  // frame: EOF-pad source when no decoded
                                  // frame matched a request in this call
  AVPacket* pkt = nullptr;
  // aligned intermediate RGB buffer: sws_scale's SIMD stores can write past
  // unaligned row ends (width*3 rarely is a 16/32-byte multiple), so it
  // must never target the caller's tightly-packed numpy buffer directly
  uint8_t* rgb_data[4] = {nullptr, nullptr, nullptr, nullptr};
  int rgb_linesize[4] = {0, 0, 0, 0};
  int sws_w = 0, sws_h = 0;  // output geometry the cached sws/rgb serve
  int stream_idx = -1;
  int width = 0;
  int height = 0;
  int64_t num_frames = 0;
  double fps = 30.0;
  AVRational time_base{1, 25};
  int64_t start_time = 0;
  int64_t next_index = 0;   // index of the next frame decode will produce
  bool drained = false;     // demuxer hit EOF and the codec was flushed:
                            // the NEXT get_batch must seek before reading
  char err[256] = {0};
};

void set_err(Reader* r, const char* msg, int code = 0) {
  if (code != 0) {
    char buf[128];
    av_strerror(code, buf, sizeof(buf));
    snprintf(r->err, sizeof(r->err), "%s: %s", msg, buf);
  } else {
    snprintf(r->err, sizeof(r->err), "%s", msg);
  }
}

int64_t pts_to_index(const Reader* r, int64_t pts) {
  if (pts == AV_NOPTS_VALUE) return -1;
  double sec = (pts - r->start_time) * av_q2d(r->time_base);
  return (int64_t)(sec * r->fps + 0.5);
}

// Count frames by demuxing packets (no decode) when metadata lies.
int64_t count_frames_by_demux(const char* path, int stream_idx) {
  AVFormatContext* f = nullptr;
  if (avformat_open_input(&f, path, nullptr, nullptr) < 0) return 0;
  if (avformat_find_stream_info(f, nullptr) < 0) {
    avformat_close_input(&f);
    return 0;
  }
  AVPacket* p = av_packet_alloc();
  int64_t n = 0;
  while (av_read_frame(f, p) >= 0) {
    if (p->stream_index == stream_idx) n++;
    av_packet_unref(p);
  }
  av_packet_free(&p);
  avformat_close_input(&f);
  return n;
}

}  // namespace

extern "C" {

void* vr_open(const char* path) {
  Reader* r = new (std::nothrow) Reader();
  if (!r) return nullptr;

  int ret = avformat_open_input(&r->fmt, path, nullptr, nullptr);
  if (ret < 0) {
    set_err(r, "open_input", ret);
    return r;
  }
  ret = avformat_find_stream_info(r->fmt, nullptr);
  if (ret < 0) {
    set_err(r, "find_stream_info", ret);
    return r;
  }
  const AVCodec* dec = nullptr;
  r->stream_idx =
      av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (r->stream_idx < 0 || !dec) {
    set_err(r, "no video stream");
    return r;
  }
  AVStream* st = r->fmt->streams[r->stream_idx];
  r->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(r->codec, st->codecpar);
  r->codec->thread_count = 1;  // one reader per worker thread instead
  ret = avcodec_open2(r->codec, dec, nullptr);
  if (ret < 0) {
    set_err(r, "codec_open", ret);
    return r;
  }

  r->width = r->codec->width;
  r->height = r->codec->height;
  r->time_base = st->time_base;
  r->start_time = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;

  AVRational fr = st->avg_frame_rate;
  if (fr.num == 0 || fr.den == 0) fr = st->r_frame_rate;
  r->fps = (fr.num && fr.den) ? av_q2d(fr) : 30.0;

  r->num_frames = st->nb_frames;
  if (r->num_frames <= 0 && st->duration != AV_NOPTS_VALUE) {
    r->num_frames =
        (int64_t)(st->duration * av_q2d(st->time_base) * r->fps + 0.5);
  }
  if (r->num_frames <= 0) {
    r->num_frames = count_frames_by_demux(path, r->stream_idx);
  }

  r->frame = av_frame_alloc();
  r->last_frame = av_frame_alloc();
  r->pkt = av_packet_alloc();
  r->next_index = 0;
  return r;
}

const char* vr_error(void* h) {
  Reader* r = (Reader*)h;
  if (!r) return "reader is closed";
  return r->err[0] ? r->err : nullptr;
}

// NULL-handle guards: a use-after-close from Python must raise, not
// segfault the training process (vr_close already guards).
long vr_num_frames(void* h) { return h ? (long)((Reader*)h)->num_frames : -1; }
double vr_fps(void* h) { return h ? ((Reader*)h)->fps : 0.0; }
int vr_width(void* h) { return h ? ((Reader*)h)->width : 0; }
int vr_height(void* h) { return h ? ((Reader*)h)->height : 0; }

// Decode frames at `indices` (any order) into out [n, out_h, out_w, 3]
// RGB24, resized during the pixel-format conversion (ONE sws_scale pass does
// both — decode-time scaling kills the per-frame host cv2 resize loop the
// reference transcode recipe's variable widths otherwise force,
// utils/transcode_dataset.py scale=w=-2:h=256). Returns 0 on success.
static int get_batch_scaled_impl(Reader* r, const long* indices, int n,
                                 unsigned char* out, int out_w, int out_h) {
  if (!r) return -1;
  if (!r->codec) {
    set_err(r, "reader not open");
    return -1;
  }
  if (n <= 0) return 0;
  if (out_w <= 0 || out_h <= 0) {
    set_err(r, "invalid output size");
    return -1;
  }

  std::vector<std::pair<int64_t, int>> want(n);  // (frame index, out slot)
  for (int i = 0; i < n; i++) want[i] = {indices[i], i};
  std::sort(want.begin(), want.end());

  const size_t frame_bytes = (size_t)out_w * out_h * 3;
  if (r->sws && (r->sws_w != out_w || r->sws_h != out_h)) {
    // cached converter serves a different output geometry: rebuild
    sws_freeContext(r->sws);
    r->sws = nullptr;
    if (r->rgb_data[0]) av_freep(&r->rgb_data[0]);
    r->rgb_data[0] = nullptr;
  }
  if (!r->sws) {
    // map deprecated full-range J formats to their modern equivalent and
    // carry the range explicitly; avoids swscale's per-reader log spam
    AVPixelFormat src_fmt = r->codec->pix_fmt;
    bool full_range = r->codec->color_range == AVCOL_RANGE_JPEG;
    switch (src_fmt) {
      case AV_PIX_FMT_YUVJ420P: src_fmt = AV_PIX_FMT_YUV420P;
                                full_range = true; break;
      case AV_PIX_FMT_YUVJ422P: src_fmt = AV_PIX_FMT_YUV422P;
                                full_range = true; break;
      case AV_PIX_FMT_YUVJ444P: src_fmt = AV_PIX_FMT_YUV444P;
                                full_range = true; break;
      case AV_PIX_FMT_YUVJ440P: src_fmt = AV_PIX_FMT_YUV440P;
                                full_range = true; break;
      default: break;
    }
    r->sws = sws_getContext(r->width, r->height, src_fmt, out_w, out_h,
                            AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr,
                            nullptr);
    if (!r->sws) {
      set_err(r, "sws_getContext failed");
      return -1;
    }
    r->sws_w = out_w;
    r->sws_h = out_h;
    if (full_range) {
      int* inv_table; int* table;
      int in_full, out_full, brightness, contrast, saturation;
      if (sws_getColorspaceDetails(r->sws, &inv_table, &in_full, &table,
                                   &out_full, &brightness, &contrast,
                                   &saturation) >= 0) {
        sws_setColorspaceDetails(r->sws, inv_table, 1, table, out_full,
                                 brightness, contrast, saturation);
      }
    }
  }
  if (!r->rgb_data[0]) {
    int ret2 = av_image_alloc(r->rgb_data, r->rgb_linesize, out_w, out_h,
                              AV_PIX_FMT_RGB24, 32);
    if (ret2 < 0) {
      set_err(r, "av_image_alloc", ret2);
      return -1;
    }
  }

  int64_t first = want.front().first;
  // Seek backward to a keyframe if the window is behind us or far ahead —
  // or if a previous call drained the demuxer+codec at EOF (metadata can
  // overestimate num_frames, so a request at/past real EOF pads and
  // leaves both at end; without a seek the next call would read EOF
  // immediately, send a second flush packet, and fail with "EOF before
  // any requested frame" instead of padding).
  if (r->drained || first < r->next_index || first > r->next_index + 256) {
    int64_t ts =
        r->start_time +
        (int64_t)((double)first / r->fps / av_q2d(r->time_base));
    if (av_seek_frame(r->fmt, r->stream_idx, ts, AVSEEK_FLAG_BACKWARD) >= 0) {
      avcodec_flush_buffers(r->codec);
      r->next_index = -1;  // unknown until first decoded pts
      r->drained = false;
    }
  }

  size_t cursor = 0;          // next entry of `want` to fill
  int64_t last_written = -1;  // most recent out slot filled (for fallback)
  bool flushing = false;

  while (cursor < want.size()) {
    int ret;
    if (!flushing) {
      ret = av_read_frame(r->fmt, r->pkt);
      if (ret < 0) {
        // EOF: flush decoder
        avcodec_send_packet(r->codec, nullptr);
        flushing = true;
        r->drained = true;
        continue;
      }
      if (r->pkt->stream_index != r->stream_idx) {
        av_packet_unref(r->pkt);
        continue;
      }
      ret = avcodec_send_packet(r->codec, r->pkt);
      av_packet_unref(r->pkt);
      if (ret < 0 && ret != AVERROR(EAGAIN)) {
        set_err(r, "send_packet", ret);
        return -1;
      }
    }
    while (true) {
      int rr = avcodec_receive_frame(r->codec, r->frame);
      if (rr == AVERROR(EAGAIN)) break;
      if (rr == AVERROR_EOF) {
        // pad remaining requests with the last decoded frame (mirrors the
        // reference pipeline's nearest-frame fallback)
        if (last_written >= 0) {
          while (cursor < want.size()) {
            memcpy(out + (size_t)want[cursor].second * frame_bytes,
                   out + (size_t)last_written * frame_bytes, frame_bytes);
            cursor++;
          }
          return 0;
        }
        if (r->last_frame->data[0]) {
          // every request was past real EOF (metadata overestimated
          // num_frames): pad everything from the last decoded frame
          sws_scale(r->sws, r->last_frame->data, r->last_frame->linesize,
                    0, r->height, r->rgb_data, r->rgb_linesize);
          uint8_t* dst0 = out + (size_t)want[0].second * frame_bytes;
          for (int y = 0; y < out_h; y++) {
            memcpy(dst0 + (size_t)y * out_w * 3,
                   r->rgb_data[0] + (size_t)y * r->rgb_linesize[0],
                   (size_t)out_w * 3);
          }
          for (cursor = 1; cursor < want.size(); cursor++) {
            memcpy(out + (size_t)want[cursor].second * frame_bytes, dst0,
                   frame_bytes);
          }
          return 0;
        }
        set_err(r, "EOF before any requested frame");
        return -1;
      }
      if (rr < 0) {
        set_err(r, "receive_frame", rr);
        return -1;
      }
      av_frame_unref(r->last_frame);
      av_frame_ref(r->last_frame, r->frame);  // refcount, no pixel copy

      int64_t idx;
      int64_t pts = r->frame->best_effort_timestamp;
      if (r->next_index < 0) {
        idx = pts_to_index(r, pts);
        if (idx < 0) idx = 0;
      } else {
        idx = r->next_index;
      }
      r->next_index = idx + 1;

      if (cursor < want.size() && want[cursor].first <= idx) {
        // scale once into the aligned buffer, then copy tight rows out
        sws_scale(r->sws, r->frame->data, r->frame->linesize, 0, r->height,
                  r->rgb_data, r->rgb_linesize);
        while (cursor < want.size() && want[cursor].first <= idx) {
          uint8_t* dst = out + (size_t)want[cursor].second * frame_bytes;
          for (int y = 0; y < out_h; y++) {
            memcpy(dst + (size_t)y * out_w * 3,
                   r->rgb_data[0] + (size_t)y * r->rgb_linesize[0],
                   (size_t)out_w * 3);
          }
          last_written = want[cursor].second;
          cursor++;
        }
      }
      av_frame_unref(r->frame);
      if (cursor >= want.size()) return 0;
    }
  }
  return 0;
}

int vr_get_batch(void* h, const long* indices, int n, unsigned char* out) {
  Reader* r = (Reader*)h;
  if (!r) return -1;
  return get_batch_scaled_impl(r, indices, n, out, r->width, r->height);
}

int vr_get_batch_scaled(void* h, const long* indices, int n,
                        unsigned char* out, int out_w, int out_h) {
  return get_batch_scaled_impl((Reader*)h, indices, n, out, out_w, out_h);
}

void vr_close(void* h) {
  Reader* r = (Reader*)h;
  if (!r) return;
  if (r->rgb_data[0]) av_freep(&r->rgb_data[0]);
  if (r->sws) sws_freeContext(r->sws);
  if (r->frame) av_frame_free(&r->frame);
  if (r->last_frame) av_frame_free(&r->last_frame);
  if (r->pkt) av_packet_free(&r->pkt);
  if (r->codec) avcodec_free_context(&r->codec);
  if (r->fmt) avformat_close_input(&r->fmt);
  delete r;
}

}  // extern "C"
