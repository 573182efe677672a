// ffmpeg-backed audio ingestion: m4a/AAC (and any lavf container) decode
// plus an AAC/m4a encoder used only by tests to build fixtures in memory.
//
// Parity target: the reference decodes m4a through torchaudio/ffmpeg
// (reference wenet/dataset/processor.py:178-211) and its shard writer
// whitelists the extension (tools/make_shard.py:36).  This image carries
// libavformat/libavcodec 59 (FFmpeg 5.1) as system libraries, so we link
// against the real headers instead of guessing struct layouts over ctypes.
// Compiled at first use by native.build_av() into the package's _build/
// (linked with -lavformat -lavcodec -lavutil -lswresample); a failed build
// or load raises, and a payload that does not decode returns < 0.
//
// API (all extern "C", loaded via ctypes):
//   pafc_av_version()                      -> avformat_version()
//   pafc_av_decode(data, len, &out, &sr)   -> n mono float32 samples (<0 err)
//   pafc_av_encode_m4a(pcm, n, sr, &out)   -> byte length of .m4a (<0 err)
//   pafc_av_free / pafc_av_free_u8         -> free the returned buffers

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libavutil/samplefmt.h>
#include <libswresample/swresample.h>
}

namespace {

struct MemCtx {
  const uint8_t *data;
  int64_t size;
  int64_t pos;
};

int mem_read(void *opaque, uint8_t *buf, int buf_size) {
  MemCtx *m = static_cast<MemCtx *>(opaque);
  int64_t rem = m->size - m->pos;
  if (rem <= 0) return AVERROR_EOF;
  int n = static_cast<int>(std::min<int64_t>(buf_size, rem));
  std::memcpy(buf, m->data + m->pos, n);
  m->pos += n;
  return n;
}

// m4a needs a seekable source: the moov box commonly trails the mdat.
int64_t mem_seek(void *opaque, int64_t offset, int whence) {
  MemCtx *m = static_cast<MemCtx *>(opaque);
  if (whence == AVSEEK_SIZE) return m->size;
  whence &= ~AVSEEK_FORCE;
  int64_t np;
  switch (whence) {
    case SEEK_SET: np = offset; break;
    case SEEK_CUR: np = m->pos + offset; break;
    case SEEK_END: np = m->size + offset; break;
    default: return -1;
  }
  if (np < 0 || np > m->size) return -1;
  m->pos = np;
  return np;
}

struct DecState {
  AVFormatContext *fmt = nullptr;
  AVIOContext *avio = nullptr;
  AVCodecContext *dec = nullptr;
  SwrContext *swr = nullptr;
  AVPacket *pkt = nullptr;
  AVFrame *frame = nullptr;
  ~DecState() {
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (fmt) avformat_close_input(&fmt);
    if (avio) {
      av_freep(&avio->buffer);
      avio_context_free(&avio);
    }
  }
};

int drain_frames(DecState &s, std::vector<float> &out, int sr) {
  // receive every pending frame, convert to mono f32 at the native rate
  for (;;) {
    int r = avcodec_receive_frame(s.dec, s.frame);
    if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
    if (r < 0) return r;
    if (!s.swr) {
      AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
      r = swr_alloc_set_opts2(&s.swr, &mono, AV_SAMPLE_FMT_FLT, sr,
                              &s.frame->ch_layout,
                              static_cast<AVSampleFormat>(s.frame->format),
                              s.frame->sample_rate, 0, nullptr);
      if (r < 0 || swr_init(s.swr) < 0) return r < 0 ? r : -1;
    }
    int max_out = swr_get_out_samples(s.swr, s.frame->nb_samples);
    size_t base = out.size();
    out.resize(base + max_out);
    uint8_t *dst = reinterpret_cast<uint8_t *>(out.data() + base);
    int got = swr_convert(s.swr, &dst, max_out,
                          const_cast<const uint8_t **>(s.frame->data),
                          s.frame->nb_samples);
    if (got < 0) return got;
    out.resize(base + got);
  }
}

}  // namespace

extern "C" {

uint32_t pafc_av_version(void) { return avformat_version(); }

// Decode any lavf-supported container/codec to mono float32 at the
// stream's native rate (pipeline `resample` handles rate conversion,
// mirroring reference processor.py:294).  Returns the sample count, or a
// negative errno-style code.  *out is malloc'd; free with pafc_av_free.
int64_t pafc_av_decode(const uint8_t *data, int64_t len, float **out,
                       int32_t *sr_out) {
  av_log_set_level(AV_LOG_ERROR);
  DecState s;
  MemCtx mem{data, len, 0};
  constexpr int kBuf = 1 << 16;
  uint8_t *iobuf = static_cast<uint8_t *>(av_malloc(kBuf));
  if (!iobuf) return -1;
  s.avio = avio_alloc_context(iobuf, kBuf, 0, &mem, mem_read, nullptr,
                              mem_seek);
  if (!s.avio) {
    av_free(iobuf);
    return -1;
  }
  s.fmt = avformat_alloc_context();
  if (!s.fmt) return -1;
  s.fmt->pb = s.avio;
  int r = avformat_open_input(&s.fmt, nullptr, nullptr, nullptr);
  if (r < 0) return r;
  r = avformat_find_stream_info(s.fmt, nullptr);
  if (r < 0) return r;
  const AVCodec *codec = nullptr;
  int idx = av_find_best_stream(s.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec,
                                0);
  if (idx < 0 || !codec) return idx < 0 ? idx : -1;
  s.dec = avcodec_alloc_context3(codec);
  if (!s.dec) return -1;
  r = avcodec_parameters_to_context(s.dec, s.fmt->streams[idx]->codecpar);
  if (r < 0) return r;
  r = avcodec_open2(s.dec, codec, nullptr);
  if (r < 0) return r;
  s.pkt = av_packet_alloc();
  s.frame = av_frame_alloc();
  if (!s.pkt || !s.frame) return -1;
  int sr = s.fmt->streams[idx]->codecpar->sample_rate;
  if (sr <= 0) return -1;
  std::vector<float> pcm;
  while ((r = av_read_frame(s.fmt, s.pkt)) >= 0) {
    if (s.pkt->stream_index == idx) {
      int sr2 = avcodec_send_packet(s.dec, s.pkt);
      if (sr2 >= 0 || sr2 == AVERROR(EAGAIN)) {
        int dr = drain_frames(s, pcm, sr);
        if (dr < 0) {
          av_packet_unref(s.pkt);
          return dr;
        }
      }
    }
    av_packet_unref(s.pkt);
  }
  if (r != AVERROR_EOF) return r;
  avcodec_send_packet(s.dec, nullptr);  // flush
  r = drain_frames(s, pcm, sr);
  if (r < 0) return r;
  if (s.swr) {  // drain the resampler's internal delay line
    int rem = static_cast<int>(swr_get_delay(s.swr, sr)) + 64;
    size_t base = pcm.size();
    pcm.resize(base + rem);
    uint8_t *dst = reinterpret_cast<uint8_t *>(pcm.data() + base);
    int got = swr_convert(s.swr, &dst, rem, nullptr, 0);
    pcm.resize(base + (got > 0 ? got : 0));
  }
  if (pcm.empty()) return -1;
  float *buf = static_cast<float *>(std::malloc(pcm.size() * sizeof(float)));
  if (!buf) return -1;
  std::memcpy(buf, pcm.data(), pcm.size() * sizeof(float));
  *out = buf;
  *sr_out = sr;
  return static_cast<int64_t>(pcm.size());
}

void pafc_av_free(float *p) { std::free(p); }
void pafc_av_free_u8(uint8_t *p) { std::free(p); }

// Encode mono float32 PCM to AAC in an .m4a (ipod-brand MP4) container,
// entirely in memory (dyn buf is seekable, so the muxer can back-patch
// the moov box).  Test-fixture helper, same role as encode_ogg_opus /
// encode_mp3 in data/codecs.py.  Returns byte length (<0 on error);
// *out is malloc'd; free with pafc_av_free_u8.
int64_t pafc_av_encode_m4a(const float *pcm, int64_t n, int32_t sr,
                           uint8_t **out) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext *oc = nullptr;
  int r = avformat_alloc_output_context2(&oc, nullptr, "ipod", "x.m4a");
  if (r < 0 || !oc) return r < 0 ? r : -1;
  const AVCodec *enc = avcodec_find_encoder(AV_CODEC_ID_AAC);
  AVCodecContext *ec = enc ? avcodec_alloc_context3(enc) : nullptr;
  AVStream *st = ec ? avformat_new_stream(oc, nullptr) : nullptr;
  AVFrame *frame = nullptr;
  AVPacket *pkt = nullptr;
  int64_t ret = -1;
  uint8_t *dyn = nullptr;
  std::vector<float> planar;
  do {
    if (!st) break;
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    av_channel_layout_copy(&ec->ch_layout, &mono);
    ec->sample_fmt = AV_SAMPLE_FMT_FLTP;
    ec->sample_rate = sr;
    ec->bit_rate = 64000;
    ec->time_base = AVRational{1, sr};
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
      ec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(ec, enc, nullptr) < 0) break;
    if (avcodec_parameters_from_context(st->codecpar, ec) < 0) break;
    st->time_base = ec->time_base;
    if (avio_open_dyn_buf(&oc->pb) < 0) break;
    if (avformat_write_header(oc, nullptr) < 0) break;
    frame = av_frame_alloc();
    pkt = av_packet_alloc();
    if (!frame || !pkt) break;
    int fs = ec->frame_size > 0 ? ec->frame_size : 1024;
    int64_t pos = 0, pts = 0;
    bool failed = false;
    auto pump = [&](AVFrame *f) {
      if (avcodec_send_frame(ec, f) < 0) return false;
      for (;;) {
        int rr = avcodec_receive_packet(ec, pkt);
        if (rr == AVERROR(EAGAIN) || rr == AVERROR_EOF) return true;
        if (rr < 0) return false;
        av_packet_rescale_ts(pkt, ec->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(oc, pkt) < 0) return false;
      }
    };
    while (pos < n) {
      int take = static_cast<int>(std::min<int64_t>(fs, n - pos));
      frame->nb_samples = fs;
      frame->format = AV_SAMPLE_FMT_FLTP;
      av_channel_layout_copy(&frame->ch_layout, &mono);
      frame->sample_rate = sr;
      if (av_frame_get_buffer(frame, 0) < 0) { failed = true; break; }
      std::memcpy(frame->data[0], pcm + pos, take * sizeof(float));
      if (take < fs)  // zero-pad the tail frame
        std::memset(frame->data[0] + take * sizeof(float), 0,
                    (fs - take) * sizeof(float));
      frame->pts = pts;
      pts += fs;
      pos += take;
      if (!pump(frame)) { failed = true; break; }
      av_frame_unref(frame);
    }
    if (failed) break;
    if (!pump(nullptr)) break;  // flush the encoder
    if (av_write_trailer(oc) < 0) break;
    int size = avio_close_dyn_buf(oc->pb, &dyn);
    oc->pb = nullptr;
    if (size <= 0 || !dyn) break;
    uint8_t *buf = static_cast<uint8_t *>(std::malloc(size));
    if (!buf) break;
    std::memcpy(buf, dyn, size);
    *out = buf;
    ret = size;
  } while (false);
  if (oc && oc->pb) {
    uint8_t *tmp = nullptr;
    avio_close_dyn_buf(oc->pb, &tmp);
    if (tmp) av_free(tmp);
    oc->pb = nullptr;
  }
  if (dyn) av_free(dyn);
  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (ec) avcodec_free_context(&ec);
  if (oc) avformat_free_context(oc);
  return ret;
}

}  // extern "C"
