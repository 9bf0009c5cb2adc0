// media_io.cc — host-side video/audio decode + mp4 mux for asva_tpu_torch.
//
// The port's own copy of asva_tpu/data/media/src/media_io.cc: the same
// statements, so that both packages decode the same frames and samples.  A
// replacement for the torchvision `video_reader` C++ ops the reference
// depends on (avgen/data/utils.py:9-11, decode semantics :192-268; writer
// pipeline_audio_cond_animation.py:453-460), with a plain C API consumed
// through ctypes.
//
// Decode semantics contract:
//   * seek(t) positions precisely: demux from the keyframe before t, decode
//     and discard until the first frame with pts >= t (torchvision
//     video_reader behavior).
//   * video clip sampling: walking decoded frames in pts order, accept a
//     frame when pts >= next_target (targets start at clip_start and step
//     1/fps); stop at num_frames or pts > clip_start + duration + 0.5/fps;
//     the Python layer pads by repeating the last frame.
//   * audio: all samples whose frame pts lies in [start, start+duration],
//     converted to float32 interleaved at native sample rate.
//
// Built at first use by asva_tpu_torch/data/media.py (g++ with the flags of
// asva_tpu/data/media/Makefile and pkg-config's libav libraries) into the
// port's build directory.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* vdec = nullptr;
  AVCodecContext* adec = nullptr;
  int vstream = -1;
  int astream = -1;
  SwsContext* sws = nullptr;
  // sws_scale's SIMD paths can write past the end of the final row (24
  // bytes observed with AVX2 RGB24 output), so scaling straight into the
  // caller's tightly-sized numpy buffer corrupts the heap.  Scale into
  // this padded, row-aligned scratch instead and memcpy tight rows out.
  std::vector<uint8_t> rgb_scratch;
  std::string error;
};

double ts_to_sec(int64_t ts, AVRational tb) {
  if (ts == AV_NOPTS_VALUE) return -1e30;
  return ts * av_q2d(tb);
}

AVCodecContext* open_decoder(AVFormatContext* fmt, int stream) {
  const AVCodec* codec =
      avcodec_find_decoder(fmt->streams[stream]->codecpar->codec_id);
  if (!codec) return nullptr;
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  if (!ctx) return nullptr;
  if (avcodec_parameters_to_context(ctx, fmt->streams[stream]->codecpar) < 0 ||
      avcodec_open2(ctx, codec, nullptr) < 0) {
    avcodec_free_context(&ctx);
    return nullptr;
  }
  return ctx;
}

}  // namespace

extern "C" {

void* mr_open(const char* path) {
  auto* r = new Reader();
  if (avformat_open_input(&r->fmt, path, nullptr, nullptr) < 0) {
    delete r;
    return nullptr;
  }
  if (avformat_find_stream_info(r->fmt, nullptr) < 0) {
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  r->vstream = av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                   nullptr, 0);
  r->astream = av_find_best_stream(r->fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                   nullptr, 0);
  if (r->vstream >= 0) r->vdec = open_decoder(r->fmt, r->vstream);
  if (r->astream >= 0) r->adec = open_decoder(r->fmt, r->astream);
  return r;
}

void mr_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  if (!r) return;
  if (r->sws) sws_freeContext(r->sws);
  if (r->vdec) avcodec_free_context(&r->vdec);
  if (r->adec) avcodec_free_context(&r->adec);
  if (r->fmt) avformat_close_input(&r->fmt);
  delete r;
}

int mr_width(void* h) {
  auto* r = static_cast<Reader*>(h);
  return r->vdec ? r->vdec->width : 0;
}
int mr_height(void* h) {
  auto* r = static_cast<Reader*>(h);
  return r->vdec ? r->vdec->height : 0;
}

double mr_video_fps(void* h) {
  auto* r = static_cast<Reader*>(h);
  if (r->vstream < 0) return 0.0;
  AVRational fr = r->fmt->streams[r->vstream]->avg_frame_rate;
  return fr.den ? av_q2d(fr) : 0.0;
}

double mr_video_duration(void* h) {
  auto* r = static_cast<Reader*>(h);
  if (r->vstream < 0) return 0.0;
  AVStream* s = r->fmt->streams[r->vstream];
  if (s->duration != AV_NOPTS_VALUE) return ts_to_sec(s->duration, s->time_base);
  return r->fmt->duration > 0 ? r->fmt->duration / (double)AV_TIME_BASE : 0.0;
}

double mr_audio_duration(void* h) {
  auto* r = static_cast<Reader*>(h);
  if (r->astream < 0) return 0.0;
  AVStream* s = r->fmt->streams[r->astream];
  if (s->duration != AV_NOPTS_VALUE) return ts_to_sec(s->duration, s->time_base);
  return r->fmt->duration > 0 ? r->fmt->duration / (double)AV_TIME_BASE : 0.0;
}

int mr_audio_sample_rate(void* h) {
  auto* r = static_cast<Reader*>(h);
  return r->adec ? r->adec->sample_rate : 0;
}

int mr_audio_channels(void* h) {
  auto* r = static_cast<Reader*>(h);
  return r->adec ? r->adec->ch_layout.nb_channels : 0;
}

// Decode the clip; returns number of frames written (<= num_frames).
int mr_read_video_clip(void* h, double start, double duration, double fps,
                       int num_frames, unsigned char* out) {
  auto* r = static_cast<Reader*>(h);
  if (!r->vdec) return -1;
  AVStream* vs = r->fmt->streams[r->vstream];
  start = std::max(start, 0.0);

  int64_t seek_ts = (int64_t)(start / av_q2d(vs->time_base));
  av_seek_frame(r->fmt, r->vstream, seek_ts, AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(r->vdec);

  const int W = r->vdec->width, H = r->vdec->height;
  if (!r->sws) {
    r->sws = sws_getContext(W, H, r->vdec->pix_fmt, W, H, AV_PIX_FMT_RGB24,
                            SWS_BILINEAR, nullptr, nullptr, nullptr);
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  double keyframe_cov = 1.0 / fps;
  double bound = start + duration + keyframe_cov / 2.0;
  double next_target = start;
  int collected = 0;
  bool done = false;

  auto handle_frame = [&](AVFrame* f) {
    double pts = ts_to_sec(f->best_effort_timestamp, vs->time_base);
    if (pts < start && f->best_effort_timestamp != AV_NOPTS_VALUE) {
      // seek preroll: discard frames before the requested start
      if (pts < start - 1e-9 && pts < next_target) return;
    }
    if (pts > bound) {
      done = true;
      return;
    }
    if (pts >= next_target && collected < num_frames) {
      const int stride = (W * 3 + 63) & ~63;
      r->rgb_scratch.resize((size_t)stride * H + 64);
      uint8_t* dst[4] = {r->rgb_scratch.data(), nullptr, nullptr, nullptr};
      int dst_stride[4] = {stride, 0, 0, 0};
      sws_scale(r->sws, f->data, f->linesize, 0, H, dst, dst_stride);
      uint8_t* frame_out = out + (size_t)collected * H * W * 3;
      for (int y = 0; y < H; ++y)
        std::memcpy(frame_out + (size_t)y * W * 3,
                    r->rgb_scratch.data() + (size_t)y * stride, W * 3);
      ++collected;
      next_target += keyframe_cov;
      if (collected == num_frames) done = true;
    }
  };

  while (!done && av_read_frame(r->fmt, pkt) >= 0) {
    if (pkt->stream_index == r->vstream) {
      if (avcodec_send_packet(r->vdec, pkt) >= 0) {
        while (avcodec_receive_frame(r->vdec, frame) >= 0) handle_frame(frame);
      }
    }
    av_packet_unref(pkt);
  }
  if (!done) {  // drain
    avcodec_send_packet(r->vdec, nullptr);
    while (avcodec_receive_frame(r->vdec, frame) >= 0) handle_frame(frame);
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  return collected;
}

// Decode audio samples with frame-pts in [start, start+duration]; float32
// interleaved at native rate.  Returns samples-per-channel written.
long mr_read_audio(void* h, double start, double duration, float* out,
                   long max_samples) {
  auto* r = static_cast<Reader*>(h);
  if (!r->adec) return -1;
  AVStream* as = r->fmt->streams[r->astream];
  int channels = r->adec->ch_layout.nb_channels;

  int64_t seek_ts = (int64_t)(std::max(start, 0.0) / av_q2d(as->time_base));
  av_seek_frame(r->fmt, r->astream, seek_ts, AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(r->adec);

  SwrContext* swr = nullptr;
  AVChannelLayout out_layout;
  av_channel_layout_copy(&out_layout, &r->adec->ch_layout);
  if (swr_alloc_set_opts2(&swr, &out_layout, AV_SAMPLE_FMT_FLT,
                          r->adec->sample_rate, &r->adec->ch_layout,
                          r->adec->sample_fmt, r->adec->sample_rate, 0,
                          nullptr) < 0 ||
      swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    return -1;
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  long written = 0;
  bool done = false;
  std::vector<float> tmp;

  auto handle_frame = [&](AVFrame* f) {
    double pts = ts_to_sec(f->best_effort_timestamp, as->time_base);
    if (pts > start + duration) {
      done = true;
      return;
    }
    if (pts < start) return;
    tmp.resize((size_t)f->nb_samples * channels);
    uint8_t* dst = reinterpret_cast<uint8_t*>(tmp.data());
    int n = swr_convert(swr, &dst, f->nb_samples,
                        const_cast<const uint8_t**>(f->data), f->nb_samples);
    long take = std::min<long>(n, max_samples - written);
    if (take > 0) {
      std::memcpy(out + written * channels, tmp.data(),
                  (size_t)take * channels * sizeof(float));
      written += take;
    }
    if (written >= max_samples) done = true;
  };

  while (!done && av_read_frame(r->fmt, pkt) >= 0) {
    if (pkt->stream_index == r->astream) {
      if (avcodec_send_packet(r->adec, pkt) >= 0) {
        while (avcodec_receive_frame(r->adec, frame) >= 0) handle_frame(frame);
      }
    }
    av_packet_unref(pkt);
  }
  if (!done) {
    avcodec_send_packet(r->adec, nullptr);
    while (avcodec_receive_frame(r->adec, frame) >= 0) handle_frame(frame);
  }

  swr_free(&swr);
  av_channel_layout_uninit(&out_layout);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return written;
}

// ---------------------------------------------------------------------------
// Writer: mp4 with H.264 (libx264/libopenh264 if present, else mpeg4) + AAC.
// frames: (n, h, w, 3) uint8 RGB.  audio: float32 interleaved, may be null.
// ---------------------------------------------------------------------------
int mw_write_video(const char* path, const unsigned char* frames, int n,
                   int h, int w, double fps, const float* audio,
                   long audio_samples, int audio_channels, int audio_sr) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, "mp4", path) < 0)
    return -1;

  const AVCodec* vcodec = avcodec_find_encoder_by_name("libx264");
  if (!vcodec) vcodec = avcodec_find_encoder_by_name("libopenh264");
  if (!vcodec) vcodec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!vcodec) return -2;

  AVStream* vst = avformat_new_stream(fmt, nullptr);
  AVCodecContext* venc = avcodec_alloc_context3(vcodec);
  venc->width = w;
  venc->height = h;
  venc->pix_fmt = AV_PIX_FMT_YUV420P;
  venc->time_base = AVRational{1, (int)llround(fps * 1000.0)};
  venc->framerate = av_d2q(fps, 100000);
  venc->gop_size = 12;
  venc->bit_rate = (int64_t)4e6;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    venc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(venc, vcodec, nullptr) < 0) return -3;
  avcodec_parameters_from_context(vst->codecpar, venc);
  vst->time_base = venc->time_base;

  AVCodecContext* aenc = nullptr;
  AVStream* ast = nullptr;
  SwrContext* aswr = nullptr;
  if (audio && audio_samples > 0) {
    const AVCodec* acodec = avcodec_find_encoder(AV_CODEC_ID_AAC);
    if (acodec) {
      ast = avformat_new_stream(fmt, nullptr);
      aenc = avcodec_alloc_context3(acodec);
      aenc->sample_rate = audio_sr;
      av_channel_layout_default(&aenc->ch_layout, audio_channels);
      aenc->sample_fmt = AV_SAMPLE_FMT_FLTP;
      aenc->time_base = AVRational{1, audio_sr};
      aenc->bit_rate = 128000;
      if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
        aenc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
      if (avcodec_open2(aenc, acodec, nullptr) < 0) {
        avcodec_free_context(&aenc);
        aenc = nullptr;
      } else {
        avcodec_parameters_from_context(ast->codecpar, aenc);
        ast->time_base = aenc->time_base;
        AVChannelLayout in_layout;
        av_channel_layout_default(&in_layout, audio_channels);
        swr_alloc_set_opts2(&aswr, &aenc->ch_layout, AV_SAMPLE_FMT_FLTP,
                            audio_sr, &in_layout, AV_SAMPLE_FMT_FLT, audio_sr,
                            0, nullptr);
        swr_init(aswr);
        av_channel_layout_uninit(&in_layout);
      }
    }
  }

  if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  }
  if (avformat_write_header(fmt, nullptr) < 0) return -5;

  AVPacket* pkt = av_packet_alloc();
  auto flush_enc = [&](AVCodecContext* enc, AVStream* st) {
    while (avcodec_receive_packet(enc, pkt) >= 0) {
      if (enc == venc && pkt->duration == 0) pkt->duration = 1000;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
      av_packet_unref(pkt);
    }
  };

  // video frames
  SwsContext* sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h,
                                   AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                                   nullptr, nullptr);
  AVFrame* vf = av_frame_alloc();
  vf->format = AV_PIX_FMT_YUV420P;
  vf->width = w;
  vf->height = h;
  av_frame_get_buffer(vf, 0);
  for (int i = 0; i < n; ++i) {
    const uint8_t* src[1] = {frames + (size_t)i * h * w * 3};
    int src_stride[1] = {w * 3};
    av_frame_make_writable(vf);
    sws_scale(sws, src, src_stride, 0, h, vf->data, vf->linesize);
    vf->pts = (int64_t)i * 1000;
    avcodec_send_frame(venc, vf);
    flush_enc(venc, vst);
  }
  avcodec_send_frame(venc, nullptr);
  flush_enc(venc, vst);

  // audio
  if (aenc) {
    int fsize = aenc->frame_size > 0 ? aenc->frame_size : 1024;
    AVFrame* af = av_frame_alloc();
    af->format = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_copy(&af->ch_layout, &aenc->ch_layout);
    af->sample_rate = audio_sr;
    af->nb_samples = fsize;
    av_frame_get_buffer(af, 0);
    long pos = 0;
    int64_t pts = 0;
    while (pos < audio_samples) {
      int take = (int)std::min<long>(fsize, audio_samples - pos);
      av_frame_make_writable(af);
      const uint8_t* in =
          reinterpret_cast<const uint8_t*>(audio + pos * audio_channels);
      swr_convert(aswr, af->data, take, &in, take);
      if (take < fsize) {  // zero-pad the tail frame
        for (int c = 0; c < audio_channels; ++c)
          std::memset(af->data[c] + take * sizeof(float), 0,
                      (fsize - take) * sizeof(float));
      }
      af->nb_samples = fsize;
      af->pts = pts;
      pts += fsize;
      avcodec_send_frame(aenc, af);
      flush_enc(aenc, ast);
      pos += take;
    }
    avcodec_send_frame(aenc, nullptr);
    flush_enc(aenc, ast);
    av_frame_free(&af);
  }

  av_write_trailer(fmt);
  if (sws) sws_freeContext(sws);
  av_frame_free(&vf);
  av_packet_free(&pkt);
  avcodec_free_context(&venc);
  if (aenc) avcodec_free_context(&aenc);
  if (aswr) swr_free(&aswr);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return 0;
}

}  // extern "C"
