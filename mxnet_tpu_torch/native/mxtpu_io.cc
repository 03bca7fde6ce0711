// mxtpu_io: native data plane for mxnet_tpu_torch.
//
// Host-side re-expression of MXNet's C++ IO stack (parity:
// 3rdparty/dmlc-core/include/dmlc/recordio.h framing,
// src/io/iter_image_recordio_2.cc threaded decode pipeline,
// src/io/image_aug_default.cc default augmenter semantics): record
// framing, pread fan-out, libjpeg decode, resize/crop/mirror/normalize —
// all off the GIL on a worker pool, returning ready NCHW float batches in
// deterministic order.  The same source as the JAX package's reader (only
// this comment differs), so both give the same batches bit for bit.
//
// C ABI only (loaded via ctypes; no pybind dependency).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xced7230au;
constexpr uint32_t kLenMask = (1u << 29) - 1u;

// ------------------------------------------------------------------ writer

struct Writer {
  FILE* f;
};

// ------------------------------------------------------------- jpeg decode

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// decode to RGB HWC uint8; returns false on any libjpeg error
bool decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                 int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(static_cast<size_t>(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
                   static_cast<size_t>(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ------------------------------------------------------- bilinear resize

void resize_bilinear(const uint8_t* src, int sw, int sh,
                     std::vector<uint8_t>* dst, int dw, int dh) {
  dst->resize(static_cast<size_t>(dw) * dh * 3);
  const float xs = sw > 1 ? float(sw - 1) / std::max(dw - 1, 1) : 0.f;
  const float ys = sh > 1 ? float(sh - 1) / std::max(dh - 1, 1) : 0.f;
  for (int y = 0; y < dh; ++y) {
    float fy = y * ys;
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = x * xs;
      int x0 = static_cast<int>(fx);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(static_cast<size_t>(y0) * sw + x0) * 3 + c];
        float v01 = src[(static_cast<size_t>(y0) * sw + x1) * 3 + c];
        float v10 = src[(static_cast<size_t>(y1) * sw + x0) * 3 + c];
        float v11 = src[(static_cast<size_t>(y1) * sw + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        (*dst)[(static_cast<size_t>(y) * dw + x) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// ------------------------------------------------------------ pipeline

struct Result {
  std::vector<float> data;    // 3*H*W (CHW, normalized)
  std::vector<float> label;   // label_width
  uint8_t ok;
};

struct Task {
  int64_t epoch, seq, rec;
  uint64_t seed;   // captured at schedule time — workers of an abandoned
                   // epoch must never race the live epoch's seed
};

// high bit of a stored length marks a multipart logical record whose
// offset points at the FIRST FRAME HEADER and whose length spans every
// frame (headers included) through the last frame's payload
constexpr uint64_t kMultipartBit = 1ull << 63;

struct Pipe {
  int fd = -1;
  std::vector<uint64_t> offs, lens;   // payload offset/length per record
  int H, W, resize, rand_crop, rand_mirror, label_width, capacity;
  float mean[3], stdv[3];
  uint64_t seed;

  std::deque<Task> tasks;
  int64_t epoch = 0;                  // bumped by schedule(); stale
                                      // results are discarded
  int64_t epoch_len = 0;
  std::map<int64_t, Result> done;
  int64_t next_out = 0;
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv_task, cv_done;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_task.wait(lk, [&] {
          return stop ||
                 (!tasks.empty() &&
                  done.size() < static_cast<size_t>(capacity));
        });
        if (stop) return;
        t = tasks.front();
        tasks.pop_front();
      }
      Result r = process(t.rec, t.seq, t.seed);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (t.epoch == epoch)        // drop results of abandoned epochs
          done.emplace(t.seq, std::move(r));
      }
      cv_done.notify_all();
    }
  }

  // Reassemble a multipart logical record from its raw frame span: parts
  // are rejoined with the magic word re-inserted (dmlc RecordIOReader).
  static bool reassemble(const std::vector<uint8_t>& span,
                         std::vector<uint8_t>* out) {
    out->clear();
    size_t p = 0;
    bool started = false;
    while (p + 8 <= span.size()) {
      uint32_t magic, lrec;
      std::memcpy(&magic, span.data() + p, 4);
      std::memcpy(&lrec, span.data() + p + 4, 4);
      if (magic != kMagic) return false;
      uint32_t cflag = lrec >> 29;
      size_t len = lrec & kLenMask;
      p += 8;
      if (p + len > span.size()) return false;
      if (cflag == 1) {
        started = true;
        out->assign(span.begin() + p, span.begin() + p + len);
      } else if (cflag == 2 || cflag == 3) {
        if (!started) return false;
        const uint8_t* m = reinterpret_cast<const uint8_t*>(&kMagic);
        out->insert(out->end(), m, m + 4);
        out->insert(out->end(), span.begin() + p, span.begin() + p + len);
        if (cflag == 3) return true;
      } else {
        return false;
      }
      p += len + ((4 - (len & 3)) & 3);
    }
    return false;
  }

  Result process(int64_t rec, int64_t seq, uint64_t seed) {
    Result r;
    r.ok = 0;
    r.data.assign(static_cast<size_t>(3) * H * W, 0.f);
    r.label.assign(label_width, 0.f);
    uint64_t rlen = lens[rec] & ~kMultipartBit;
    std::vector<uint8_t> raw(rlen);
    ssize_t got = pread(fd, raw.data(), rlen,
                        static_cast<off_t>(offs[rec]));
    if (got != static_cast<ssize_t>(rlen)) return r;
    if (lens[rec] & kMultipartBit) {
      std::vector<uint8_t> whole;
      if (!reassemble(raw, &whole)) return r;
      raw.swap(whole);
    }
    if (raw.size() < 24) return r;
    // IRHeader: <IfQQ> flag, label, id, id2 (+ flag floats when flag > 0)
    uint32_t flag;
    float lab;
    std::memcpy(&flag, raw.data(), 4);
    std::memcpy(&lab, raw.data() + 4, 4);
    size_t off = 24;
    if (flag > 0) {
      size_t need = static_cast<size_t>(flag) * 4;
      if (raw.size() < off + need) return r;
      for (int i = 0; i < label_width && i < static_cast<int>(flag); ++i)
        std::memcpy(&r.label[i], raw.data() + off + i * 4, 4);
      off += need;
    } else {
      r.label[0] = lab;
    }
    int w0 = 0, h0 = 0;
    std::vector<uint8_t> rgb;
    if (!decode_jpeg(raw.data() + off, raw.size() - off, &rgb, &w0, &h0))
      return r;
    const uint8_t* img = rgb.data();
    std::vector<uint8_t> tmp;
    int cw = w0, ch = h0;
    if (resize > 0) {
      float s = float(resize) / std::min(w0, h0);
      int nw = std::max(1, int(w0 * s + 0.5f));
      int nh = std::max(1, int(h0 * s + 0.5f));
      resize_bilinear(img, cw, ch, &tmp, nw, nh);
      img = tmp.data(); cw = nw; ch = nh;
    }
    std::vector<uint8_t> tmp2;
    if (cw < W || ch < H) {            // upscale to cover the crop
      int nw = std::max(W, cw), nh = std::max(H, ch);
      resize_bilinear(img, cw, ch, &tmp2, nw, nh);
      img = tmp2.data(); cw = nw; ch = nh;
    }
    std::mt19937_64 rng(seed * 0x9e3779b97f4a7c15ull + seq);
    int x0, y0;
    if (rand_crop) {
      x0 = static_cast<int>(rng() % (cw - W + 1));
      y0 = static_cast<int>(rng() % (ch - H + 1));
    } else {
      x0 = (cw - W) / 2; y0 = (ch - H) / 2;
    }
    bool mirror = rand_mirror && (rng() & 1);
    for (int y = 0; y < H; ++y) {
      for (int x = 0; x < W; ++x) {
        int sx = mirror ? (x0 + W - 1 - x) : (x0 + x);
        const uint8_t* px =
            img + (static_cast<size_t>(y0 + y) * cw + sx) * 3;
        for (int c = 0; c < 3; ++c) {
          r.data[(static_cast<size_t>(c) * H + y) * W + x] =
              (float(px[c]) - mean[c]) / stdv[c];
        }
      }
    }
    r.ok = 1;
    return r;
  }
};

}  // namespace

extern "C" {

// ------------------------------------------------------------------ writer

void* mxio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer{f};
  return w;
}

int64_t mxio_writer_tell(void* h) {
  return ftell(static_cast<Writer*>(h)->f);
}

int mxio_writer_write(void* h, const uint8_t* data, uint64_t len) {
  FILE* f = static_cast<Writer*>(h)->f;
  if (len > kLenMask) return -1;   // 29-bit length field; never truncate
  // dmlc multipart splitting: every 4-byte-aligned magic word inside the
  // payload becomes the next part's frame delimiter (cflag 1/2/3), so
  // upstream dmlc readers reassemble bit-for-bit
  const uint8_t* m = reinterpret_cast<const uint8_t*>(&kMagic);
  uint64_t dptr = 0;
  for (uint64_t i = 0; i + 4 <= len; i += 4) {
    if (std::memcmp(data + i, m, 4) == 0) {
      uint32_t lrec = ((dptr == 0 ? 1u : 2u) << 29) |
                      static_cast<uint32_t>(i - dptr);
      uint32_t hdr[2] = {kMagic, lrec};
      if (fwrite(hdr, 4, 2, f) != 2) return -1;
      if (i != dptr && fwrite(data + dptr, 1, i - dptr, f) != i - dptr)
        return -1;
      dptr = i + 4;
    }
  }
  uint32_t lrec = ((dptr != 0 ? 3u : 0u) << 29) |
                  static_cast<uint32_t>(len - dptr);
  uint32_t hdr[2] = {kMagic, lrec};
  if (fwrite(hdr, 4, 2, f) != 2) return -1;
  if (len != dptr && fwrite(data + dptr, 1, len - dptr, f) != len - dptr)
    return -1;
  static const char zeros[4] = {0, 0, 0, 0};
  size_t pad = (4 - (len & 3)) & 3;
  if (pad && fwrite(zeros, 1, pad, f) != pad) return -1;
  return 0;
}

void mxio_writer_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  fclose(w->f);
  delete w;
}

// ------------------------------------------------- offset table scan

// Scans a RecordIO file; fills malloc'd offset/length arrays of LOGICAL
// records.  Single-frame records store (payload offset, payload length);
// multipart records (cflag 1/2/3 chains) store (first-frame HEADER offset,
// full span length) with the kMultipartBit marker — the pipeline worker
// reassembles them.  Returns record count, -1 on error/malformed chain.
int64_t mxio_scan(const char* path, uint64_t** offs_out,
                  uint64_t** lens_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint64_t> offs, lens;
  uint32_t hdr[2];
  long chain_start = -1;   // header pos of the open multipart chain
  for (;;) {
    long pos = ftell(f);
    if (fread(hdr, 4, 2, f) != 2) break;
    if (hdr[0] != kMagic) { fclose(f); return -1; }
    uint32_t cflag = hdr[1] >> 29;
    uint64_t len = hdr[1] & kLenMask;
    if (cflag == 0) {
      if (chain_start != -1) { fclose(f); return -1; }
      offs.push_back(static_cast<uint64_t>(pos) + 8);
      lens.push_back(len);
    } else if (cflag == 1) {
      if (chain_start != -1) { fclose(f); return -1; }
      chain_start = pos;
    } else {
      if (chain_start == -1) { fclose(f); return -1; }
      if (cflag == 3) {
        offs.push_back(static_cast<uint64_t>(chain_start));
        lens.push_back((static_cast<uint64_t>(pos) + 8 + len -
                        static_cast<uint64_t>(chain_start)) | kMultipartBit);
        chain_start = -1;
      }
    }
    uint64_t skip = len + ((4 - (len & 3)) & 3);
    if (fseek(f, static_cast<long>(skip), SEEK_CUR) != 0) break;
  }
  fclose(f);
  if (chain_start != -1) return -1;   // truncated multipart chain
  int64_t n = static_cast<int64_t>(offs.size());
  *offs_out = static_cast<uint64_t*>(malloc(n * 8));
  *lens_out = static_cast<uint64_t*>(malloc(n * 8));
  std::memcpy(*offs_out, offs.data(), n * 8);
  std::memcpy(*lens_out, lens.data(), n * 8);
  return n;
}

void mxio_free(void* p) { free(p); }

// ------------------------------------------------------------- pipeline

void* mxio_pipe_open(const char* path, const uint64_t* offs,
                     const uint64_t* lens, int64_t n, int threads, int H,
                     int W, int resize, int rand_crop, int rand_mirror,
                     const float* mean, const float* stdv, uint64_t seed,
                     int label_width, int capacity) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  Pipe* p = new Pipe();
  p->fd = fd;
  p->offs.assign(offs, offs + n);
  p->lens.assign(lens, lens + n);
  p->H = H; p->W = W; p->resize = resize;
  p->rand_crop = rand_crop; p->rand_mirror = rand_mirror;
  p->label_width = std::max(1, label_width);
  p->capacity = std::max(capacity, 2 * threads);
  std::memcpy(p->mean, mean, 12);
  std::memcpy(p->stdv, stdv, 12);
  p->seed = seed;
  int nt = std::max(1, threads);
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// Install a new epoch order (record indices) and reset sequencing;
// `seed` reseeds the augmentation RNG so crops/mirrors vary per epoch.
void mxio_pipe_schedule(void* h, const int64_t* order, int64_t n,
                        uint64_t seed) {
  Pipe* p = static_cast<Pipe*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->tasks.clear();
    p->done.clear();
    p->epoch++;
    p->epoch_len = n;
    p->next_out = 0;
    p->seed = seed;
    for (int64_t i = 0; i < n; ++i)
      p->tasks.push_back(Task{p->epoch, i, order[i], seed});
  }
  p->cv_task.notify_all();
}

// Fill one batch (NCHW float data + labels + ok flags).  Returns the
// number of samples filled (< batch at end of epoch).
int64_t mxio_pipe_next(void* h, int64_t batch, float* data_out,
                       float* label_out, uint8_t* ok_out) {
  Pipe* p = static_cast<Pipe*>(h);
  const size_t isz = static_cast<size_t>(3) * p->H * p->W;
  int64_t filled = 0;
  for (; filled < batch; ++filled) {
    std::unique_lock<std::mutex> lk(p->mu);
    int64_t want = p->next_out;
    if (want >= p->epoch_len) break;
    p->cv_done.wait(lk, [&] { return p->done.count(want) > 0; });
    auto it = p->done.find(want);
    Result r = std::move(it->second);
    p->done.erase(it);
    p->next_out++;
    lk.unlock();
    p->cv_task.notify_all();   // capacity freed
    std::memcpy(data_out + filled * isz, r.data.data(), isz * 4);
    std::memcpy(label_out + filled * p->label_width, r.label.data(),
                p->label_width * 4);
    ok_out[filled] = r.ok;
  }
  return filled;
}

void mxio_pipe_close(void* h) {
  Pipe* p = static_cast<Pipe*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_task.notify_all();
  for (auto& t : p->workers) t.join();
  close(p->fd);
  delete p;
}

}  // extern "C"
