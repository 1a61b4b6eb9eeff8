/* lavf input shim: libavformat demux + libavcodec decode + optional
 * swscale CSP conversion, exposed to Python over ctypes.
 *
 * Native analogue of the reference's input/lavf.c (280 LoC): probe
 * any container/codec ffmpeg can read, decode to planar YUV, surface
 * stream metadata (dims, fps, SAR, bit depth, frame count) and per-frame
 * pts in stream timebase units for VFR handling (input/lavf.c converts
 * to the demuxer timebase the same way).
 */
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    AVFormatContext *fmt;
    AVCodecContext *dec;
    struct SwsContext *sws;
    AVFrame *frame;
    AVFrame *out;   /* converted frame when sws is active */
    AVPacket *pkt;
    int stream_idx;
    int eof_sent;
    enum AVPixelFormat out_fmt;
} LavfIn;

typedef struct {
    int32_t width, height;
    int32_t fps_num, fps_den;
    int32_t sar_num, sar_den;
    int32_t tb_num, tb_den;      /* stream timebase (for pts) */
    int32_t csp;                  /* 420/422/444/400 */
    int32_t bitdepth;             /* 8 or 10 */
    int64_t num_frames;           /* -1 if unknown */
    int32_t interlaced, tff;
} LavfInfo;

static int classify(enum AVPixelFormat f, int *csp, int *depth) {
    const AVPixFmtDescriptor *d = av_pix_fmt_desc_get(f);
    if (!d || (d->flags & AV_PIX_FMT_FLAG_RGB) || d->nb_components < 1)
        return -1;
    *depth = d->comp[0].depth;
    if (d->nb_components == 1) { *csp = 400; return 0; }
    if (d->log2_chroma_w == 1 && d->log2_chroma_h == 1) *csp = 420;
    else if (d->log2_chroma_w == 1 && d->log2_chroma_h == 0) *csp = 422;
    else if (d->log2_chroma_w == 0 && d->log2_chroma_h == 0) *csp = 444;
    else return -1;
    return (*depth == 8 || *depth == 10) ? 0 : -1;
}

void *lavf_open(const char *path, const char *format_name, LavfInfo *info) {
    LavfIn *h = av_mallocz(sizeof(*h));
    const AVInputFormat *ifmt = NULL;
    if (format_name && format_name[0])
        ifmt = av_find_input_format(format_name);
    if (avformat_open_input(&h->fmt, path, ifmt, NULL) < 0) goto fail;
    if (avformat_find_stream_info(h->fmt, NULL) < 0) goto fail;
    const AVCodec *codec = NULL;
    h->stream_idx = av_find_best_stream(h->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                        &codec, 0);
    if (h->stream_idx < 0 || !codec) goto fail;
    AVStream *st = h->fmt->streams[h->stream_idx];
    h->dec = avcodec_alloc_context3(codec);
    if (!h->dec) goto fail;
    if (avcodec_parameters_to_context(h->dec, st->codecpar) < 0) goto fail;
    h->dec->thread_count = 0;   /* auto */
    if (avcodec_open2(h->dec, codec, NULL) < 0) goto fail;
    h->frame = av_frame_alloc();
    h->out = av_frame_alloc();
    h->pkt = av_packet_alloc();

    /* output format: keep planar YUV 8/10-bit, else convert to yuv420p
     * (the reference auto-inserts a resize/CSP filter the same way,
     * x264.c:1305 init_vid_filters) */
    int csp, depth;
    if (classify(h->dec->pix_fmt, &csp, &depth) == 0) {
        h->out_fmt = h->dec->pix_fmt;
    } else {
        h->out_fmt = AV_PIX_FMT_YUV420P;
        csp = 420; depth = 8;
    }
    info->width = h->dec->width;
    info->height = h->dec->height;
    AVRational fr = av_guess_frame_rate(h->fmt, st, NULL);
    if (fr.num <= 0 || fr.den <= 0) { fr.num = 25; fr.den = 1; }
    info->fps_num = fr.num; info->fps_den = fr.den;
    AVRational sar = st->sample_aspect_ratio.num ? st->sample_aspect_ratio
                                                 : h->dec->sample_aspect_ratio;
    info->sar_num = sar.num; info->sar_den = sar.den;
    info->tb_num = st->time_base.num; info->tb_den = st->time_base.den;
    info->csp = csp;
    info->bitdepth = depth;
    info->num_frames = st->nb_frames > 0 ? st->nb_frames : -1;
    info->interlaced = h->dec->field_order != AV_FIELD_PROGRESSIVE &&
                       h->dec->field_order != AV_FIELD_UNKNOWN;
    info->tff = h->dec->field_order == AV_FIELD_TT ||
                h->dec->field_order == AV_FIELD_TB;
    return h;
fail:
    if (h->fmt) avformat_close_input(&h->fmt);
    av_free(h);
    return NULL;
}

/* Read one decoded frame into caller-provided plane buffers (tightly
 * packed, sized per the LavfInfo geometry). Returns 1 on frame, 0 on
 * EOF, <0 on error. *pts receives the frame pts in stream timebase. */
int lavf_read(void *vh, uint8_t *py, uint8_t *pu, uint8_t *pv,
              int64_t *pts) {
    LavfIn *h = vh;
    for (;;) {
        int r = avcodec_receive_frame(h->dec, h->frame);
        if (r == 0) break;
        if (r == AVERROR_EOF) return 0;
        if (r != AVERROR(EAGAIN)) return -1;
        if (h->eof_sent) return 0;
        r = av_read_frame(h->fmt, h->pkt);
        if (r < 0) {
            avcodec_send_packet(h->dec, NULL);
            h->eof_sent = 1;
            continue;
        }
        if (h->pkt->stream_index == h->stream_idx)
            avcodec_send_packet(h->dec, h->pkt);
        av_packet_unref(h->pkt);
    }
    AVFrame *f = h->frame;
    if (f->format != h->out_fmt) {
        h->sws = sws_getCachedContext(h->sws, f->width, f->height, f->format,
                                      f->width, f->height, h->out_fmt,
                                      SWS_BICUBIC, NULL, NULL, NULL);
        if (!h->sws) return -1;
        h->out->width = f->width; h->out->height = f->height;
        h->out->format = h->out_fmt;
        if (av_frame_get_buffer(h->out, 0) < 0) return -1;
        sws_scale(h->sws, (const uint8_t * const *)f->data, f->linesize, 0,
                  f->height, h->out->data, h->out->linesize);
        f = h->out;
    }
    const AVPixFmtDescriptor *d = av_pix_fmt_desc_get(f->format);
    int bytes = d->comp[0].depth > 8 ? 2 : 1;
    int cw = d->nb_components > 1 ? AV_CEIL_RSHIFT(f->width, d->log2_chroma_w)
                                  : 0;
    int ch = d->nb_components > 1 ? AV_CEIL_RSHIFT(f->height, d->log2_chroma_h)
                                  : 0;
    uint8_t *dst[3] = {py, pu, pv};
    int w[3] = {f->width, cw, cw}, ht[3] = {f->height, ch, ch};
    for (int p = 0; p < (d->nb_components > 1 ? 3 : 1); p++)
        for (int y = 0; y < ht[p]; y++)
            memcpy(dst[p] + (size_t)y * w[p] * bytes,
                   f->data[p] + (size_t)y * f->linesize[p],
                   (size_t)w[p] * bytes);
    *pts = h->frame->pts != AV_NOPTS_VALUE ? h->frame->pts
                                           : h->frame->best_effort_timestamp;
    av_frame_unref(h->frame);
    if (f == h->out) av_frame_unref(h->out);
    return 1;
}

void lavf_close(void *vh) {
    LavfIn *h = vh;
    if (!h) return;
    if (h->sws) sws_freeContext(h->sws);
    av_frame_free(&h->frame);
    av_frame_free(&h->out);
    av_packet_free(&h->pkt);
    avcodec_free_context(&h->dec);
    avformat_close_input(&h->fmt);
    av_free(h);
}
