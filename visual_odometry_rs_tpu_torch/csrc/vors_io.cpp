// vors_io — the port's PNG decoder and prefetching frame loader (host C++).
//
// The C API of the JAX package's native loader (native/vors_io.cpp, the
// reference's src/misc/helper.rs:13-36 `read_png_16bits` and the image
// crate's `to_luma` at src/bin/vors_track.rs:141-143): 16-bit grayscale
// depth PNGs, 8-bit gray/RGB color PNGs turned into the image crate's integer
// BT.601 luma ((299R + 587G + 114B) / 1000), and a multi-threaded loader that
// decodes (depth, color) pairs ahead of the consumer and delivers them in
// order.
//
// PNG is decoded here on zlib's `inflate` alone, so the library needs only
// zlib's header: the chunk walk (with the CRC of every critical chunk), the
// five row filters, Adam7 interlacing, and every color type and bit depth.
// The decoded image is what libpng gives with the JAX package's transforms:
// gray below 8 bits expanded to 8 (scaled to 0..255), palette expanded to
// RGB (an index past the palette is black), alpha and tRNS dropped, 16-bit
// samples in host byte order.
//
// Plain C interface, loaded with ctypes (visual_odometry_rs_tpu_torch/native).

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int height = 0;
  int width = 0;
  int channels = 0;   // 1 or 3 (alpha is dropped)
  int bit_depth = 0;  // 8 or 16
  std::vector<uint8_t> data;  // row-major, u8 or host-order u16 samples
};

struct Header {
  uint32_t width = 0;
  uint32_t height = 0;
  int bit_depth = 0;
  int color_type = 0;
  int interlace = 0;
};

const uint8_t kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Reads the file; with `header_only`, only the signature and IHDR.
bool read_file(const char* path, bool header_only, std::vector<uint8_t>* buf,
               std::string* err) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    *err = std::string("cannot open ") + path;
    return false;
  }
  if (header_only) {
    buf->resize(8 + 8 + 13 + 4);
    buf->resize(std::fread(buf->data(), 1, buf->size(), fp));
  } else {
    std::fseek(fp, 0, SEEK_END);
    long size = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    buf->resize(size > 0 ? size_t(size) : 0);
    buf->resize(std::fread(buf->data(), 1, buf->size(), fp));
  }
  std::fclose(fp);
  return true;
}

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

bool valid_depth(int color_type, int bit_depth) {
  switch (color_type) {
    case 0: return bit_depth == 1 || bit_depth == 2 || bit_depth == 4 ||
                   bit_depth == 8 || bit_depth == 16;
    case 3: return bit_depth == 1 || bit_depth == 2 || bit_depth == 4 ||
                   bit_depth == 8;
    case 2: case 4: case 6: return bit_depth == 8 || bit_depth == 16;
    default: return false;
  }
}

bool parse_header(const uint8_t* d, uint32_t len, Header* h) {
  if (len != 13) return false;
  h->width = be32(d);
  h->height = be32(d + 4);
  h->bit_depth = d[8];
  h->color_type = d[9];
  h->interlace = d[12];
  return h->width > 0 && h->height > 0 && h->width <= 0x7fffffffu &&
         h->height <= 0x7fffffffu && valid_depth(h->color_type, h->bit_depth) &&
         d[10] == 0 && d[11] == 0 && h->interlace <= 1;
}

// Walks the chunks: the header, the palette and the concatenated IDAT data.
// Stops after IHDR when `idat` is null.
bool walk_chunks(const std::vector<uint8_t>& file, const char* path, Header* h,
                 std::vector<uint8_t>* palette, std::vector<uint8_t>* idat,
                 std::string* err) {
  if (file.size() < 8 || std::memcmp(file.data(), kSignature, 8) != 0) {
    *err = std::string("not a PNG: ") + path;
    return false;
  }
  size_t pos = 8;
  bool have_header = false;
  for (;;) {
    if (pos + 12 > file.size()) {
      *err = std::string("truncated PNG: ") + path;
      return false;
    }
    const uint32_t len = be32(&file[pos]);
    const uint8_t* type = &file[pos + 4];
    if (len > 0x7fffffffu || pos + 12 + size_t(len) > file.size()) {
      *err = std::string("truncated PNG: ") + path;
      return false;
    }
    const uint8_t* data = type + 4;
    const bool critical = (type[0] & 0x20) == 0;
    if (critical) {
      const uint32_t crc = uint32_t(crc32(crc32(0L, Z_NULL, 0), type, len + 4));
      if (crc != be32(data + len)) {
        *err = std::string("PNG CRC error: ") + path;
        return false;
      }
    }
    const bool is_ihdr = std::memcmp(type, "IHDR", 4) == 0;
    if (have_header == is_ihdr) {  // IHDR first, and only once
      *err = std::string("PNG header error: ") + path;
      return false;
    }
    if (is_ihdr) {
      if (!parse_header(data, len, h)) {
        *err = std::string("PNG header error: ") + path;
        return false;
      }
      have_header = true;
      if (!idat) return true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 != 0 || len > 3 * 256) {
        *err = std::string("bad PNG palette: ") + path;
        return false;
      }
      palette->assign(data, data + len);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat->insert(idat->end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    } else if (critical) {
      *err = std::string("unknown critical PNG chunk: ") + path;
      return false;
    }
    pos += 12 + size_t(len);
  }
  if (idat->empty() || (h->color_type == 3 && palette->empty())) {
    *err = std::string("PNG without image data or palette: ") + path;
    return false;
  }
  return true;
}

// One Adam7 pass (or the whole image): its first pixel and its steps.
struct Pass {
  uint32_t x0, y0, dx, dy, width, height;
};

std::vector<Pass> passes_of(const Header& h) {
  if (h.interlace == 0) return {{0, 0, 1, 1, h.width, h.height}};
  static const uint32_t x0[7] = {0, 4, 0, 2, 0, 1, 0};
  static const uint32_t y0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const uint32_t dx[7] = {8, 8, 4, 4, 2, 2, 1};
  static const uint32_t dy[7] = {8, 8, 8, 4, 4, 2, 2};
  std::vector<Pass> out;
  for (int p = 0; p < 7; ++p) {
    const uint32_t w = h.width > x0[p] ? (h.width - x0[p] + dx[p] - 1) / dx[p] : 0;
    const uint32_t ht = h.height > y0[p] ? (h.height - y0[p] + dy[p] - 1) / dy[p] : 0;
    if (w > 0 && ht > 0) out.push_back({x0[p], y0[p], dx[p], dy[p], w, ht});
  }
  return out;
}

size_t row_bytes(uint32_t width, int bits_per_pixel) {
  return (size_t(width) * bits_per_pixel + 7) / 8;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = uInt(in.size());
  zs.next_out = out->data();
  zs.avail_out = uInt(out->size());
  int ret;
  do {
    ret = inflate(&zs, Z_NO_FLUSH);
  } while (ret == Z_OK && zs.avail_out > 0 && zs.avail_in > 0);
  inflateEnd(&zs);
  // data past the image (libpng's "extra compressed data") is not an error
  return zs.avail_out == 0 &&
         (ret == Z_OK || ret == Z_STREAM_END || ret == Z_BUF_ERROR);
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return pb <= pc ? uint8_t(b) : uint8_t(c);
}

// Undoes the row filters of `rows` rows of `stride` bytes (a filter byte and
// the row) in place; `bpp` is the filters' byte distance to the left pixel.
bool unfilter(uint8_t* rows, uint32_t nb_rows, size_t stride, size_t bpp) {
  const size_t n = stride - 1;
  const uint8_t* prev = nullptr;
  for (uint32_t r = 0; r < nb_rows; ++r) {
    uint8_t* row = rows + r * stride;
    const uint8_t filter = row[0];
    uint8_t* cur = row + 1;
    switch (filter) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < n; ++i) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
        break;
      case 2:
        if (prev)
          for (size_t i = 0; i < n; ++i) cur[i] = uint8_t(cur[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < n; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = uint8_t(cur[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < n; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = uint8_t(cur[i] + paeth(a, b, c));
        }
        break;
      default:
        return false;
    }
    prev = cur;
  }
  return true;
}

// Decodes any PNG into 8/16-bit gray or RGB samples (see the file comment).
bool decode_png(const char* path, Image* out, std::string* err) {
  std::vector<uint8_t> file, palette, idat;
  Header h;
  if (!read_file(path, false, &file, err) ||
      !walk_chunks(file, path, &h, &palette, &idat, err))
    return false;
  const int in_channels = channels_of(h.color_type);
  const int bits_per_pixel = in_channels * h.bit_depth;
  const size_t bpp = bits_per_pixel >= 8 ? size_t(bits_per_pixel / 8) : 1;
  const std::vector<Pass> passes = passes_of(h);
  size_t total = 0;
  for (const Pass& p : passes) total += size_t(p.height) * (1 + row_bytes(p.width, bits_per_pixel));
  std::vector<uint8_t> raw(total);
  if (!inflate_all(idat, &raw)) {
    *err = std::string("PNG data error: ") + path;
    return false;
  }

  const bool palette_color = h.color_type == 3;
  const bool rgb = h.color_type == 2 || h.color_type == 6 || palette_color;
  out->height = int(h.height);
  out->width = int(h.width);
  out->channels = rgb ? 3 : 1;
  out->bit_depth = (h.bit_depth == 16) ? 16 : 8;
  const size_t sample_bytes = out->bit_depth / 8;
  out->data.assign(size_t(h.height) * h.width * out->channels * sample_bytes, 0);
  uint8_t* dst8 = out->data.data();
  uint16_t* dst16 = reinterpret_cast<uint16_t*>(out->data.data());
  const int bd = h.bit_depth;
  const int gray_scale = bd == 1 ? 255 : bd == 2 ? 85 : bd == 4 ? 17 : 1;
  const size_t nb_palette = palette.size() / 3;

  size_t offset = 0;
  for (const Pass& p : passes) {
    const size_t stride = 1 + row_bytes(p.width, bits_per_pixel);
    uint8_t* rows = raw.data() + offset;
    offset += size_t(p.height) * stride;
    if (!unfilter(rows, p.height, stride, bpp)) {
      *err = std::string("bad PNG row filter: ") + path;
      return false;
    }
    const int ch = out->channels;
    for (uint32_t y = 0; y < p.height; ++y) {
      const uint8_t* src = rows + y * stride + 1;
      const size_t first = size_t(p.y0 + y * p.dy) * h.width + p.x0;  // the row's first pixel
      if (bd == 16) {
        for (uint32_t x = 0; x < p.width; ++x) {
          const uint8_t* s = src + size_t(x) * in_channels * 2;
          uint16_t* d = dst16 + (first + size_t(x) * p.dx) * ch;
          for (int c = 0; c < ch; ++c) d[c] = uint16_t((s[2 * c] << 8) | s[2 * c + 1]);
        }
      } else if (bd == 8 && !palette_color) {
        if (p.dx == 1 && in_channels == ch) {
          std::memcpy(dst8 + first * ch, src, size_t(p.width) * ch);
        } else {
          for (uint32_t x = 0; x < p.width; ++x) {
            const uint8_t* s = src + size_t(x) * in_channels;
            uint8_t* d = dst8 + (first + size_t(x) * p.dx) * ch;
            for (int c = 0; c < ch; ++c) d[c] = s[c];
          }
        }
      } else {
        // samples of bd <= 8 bits, packed from the most significant bit
        for (uint32_t x = 0; x < p.width; ++x) {
          const size_t bit = size_t(x) * bd;
          const int v = (src[bit / 8] >> (8 - bd - int(bit % 8))) & ((1 << bd) - 1);
          uint8_t* d = dst8 + (first + size_t(x) * p.dx) * ch;
          if (palette_color) {
            for (int c = 0; c < 3; ++c) d[c] = size_t(v) < nb_palette ? palette[3 * v + c] : 0;
          } else {
            d[0] = uint8_t(v * gray_scale);
          }
        }
      }
    }
  }
  return true;
}

thread_local std::string g_last_error;

// RGB u8 -> the image crate's BT.601 integer luma: (299R + 587G + 114B) / 1000.
inline uint8_t luma(uint8_t r, uint8_t g, uint8_t b) {
  return static_cast<uint8_t>((299u * r + 587u * g + 114u * b) / 1000u);
}

bool to_gray_u8(const Image& img, uint8_t* out, std::string* err) {
  const int n = img.height * img.width;
  if (img.bit_depth == 8 && img.channels == 1) {
    std::memcpy(out, img.data.data(), n);
    return true;
  }
  if (img.bit_depth == 8 && img.channels == 3) {
    const uint8_t* p = img.data.data();
    for (int i = 0; i < n; ++i, p += 3) out[i] = luma(p[0], p[1], p[2]);
    return true;
  }
  if (img.bit_depth == 16 && img.channels == 1) {
    // image::to_luma on 16-bit gray keeps the high byte
    const uint16_t* p = reinterpret_cast<const uint16_t*>(img.data.data());
    for (int i = 0; i < n; ++i) out[i] = static_cast<uint8_t>(p[i] >> 8);
    return true;
  }
  *err = "unsupported PNG layout for gray conversion";
  return false;
}

}  // namespace

extern "C" {

const char* vors_last_error() { return g_last_error.c_str(); }

// Dimensions from the header alone (no pixel decode). Returns 0 on success.
int vors_png_dims(const char* path, int* height, int* width) {
  std::vector<uint8_t> file;
  Header h;
  if (!read_file(path, true, &file, &g_last_error) ||
      !walk_chunks(file, path, &h, nullptr, nullptr, &g_last_error))
    return 1;
  *height = int(h.height);
  *width = int(h.width);
  return 0;
}

// Decodes a 16-bit grayscale depth PNG into `out` (height*width u16,
// row-major, host byte order), as helper.rs:13-36 requires. Returns 0 on
// success.
int vors_read_png16(const char* path, uint16_t* out, int height, int width) {
  Image img;
  if (!decode_png(path, &img, &g_last_error)) return 1;
  if (img.bit_depth != 16 || img.channels != 1) {
    g_last_error = std::string("expected 16-bit grayscale PNG: ") + path;
    return 2;
  }
  if (img.height != height || img.width != width) {
    g_last_error = std::string("unexpected dimensions: ") + path;
    return 3;
  }
  std::memcpy(out, img.data.data(), sizeof(uint16_t) * height * width);
  return 0;
}

// Decodes a color or gray PNG into u8 luma (BT.601 integer weights).
int vors_read_gray(const char* path, uint8_t* out, int height, int width) {
  Image img;
  if (!decode_png(path, &img, &g_last_error)) return 1;
  if (img.height != height || img.width != width) {
    g_last_error = std::string("unexpected dimensions: ") + path;
    return 3;
  }
  if (!to_gray_u8(img, out, &g_last_error)) return 2;
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded prefetch loader: decodes (depth, color) pairs ahead of the
// consumer on a worker pool, delivering frames strictly in order.
// ---------------------------------------------------------------------------

struct FramePair {
  std::vector<uint16_t> depth;
  std::vector<uint8_t> gray;
  int status = 0;  // 0 ok, else the decode error code
  std::string error;
};

struct Loader {
  std::vector<std::string> depth_paths;
  std::vector<std::string> color_paths;
  int height = 0, width = 0;
  size_t next_to_schedule = 0;  // guarded by mu
  size_t next_to_deliver = 0;   // guarded by mu
  size_t ahead = 0;             // frames decoded or in flight, undelivered
  size_t max_ahead = 0;
  std::vector<std::unique_ptr<FramePair>> done;  // index-aligned slots
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_worker;    // work available / room in window
  std::condition_variable cv_consumer;  // frame ready
  bool stop = false;

  void worker_loop() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_worker.wait(lock, [&] {
          return stop || (next_to_schedule < depth_paths.size() && ahead < max_ahead);
        });
        if (stop) return;
        idx = next_to_schedule++;
        ahead++;
      }
      auto fp = std::make_unique<FramePair>();
      fp->depth.resize(static_cast<size_t>(height) * width);
      fp->gray.resize(static_cast<size_t>(height) * width);
      fp->status = vors_read_png16(depth_paths[idx].c_str(), fp->depth.data(), height, width);
      if (fp->status == 0)
        fp->status = vors_read_gray(color_paths[idx].c_str(), fp->gray.data(), height, width);
      if (fp->status != 0) fp->error = g_last_error;
      {
        std::lock_guard<std::mutex> lock(mu);
        done[idx] = std::move(fp);
      }
      cv_consumer.notify_all();
    }
  }
};

// A loader over n frames; paths are arrays of C strings. `num_threads`
// decode workers, at most `max_ahead` frames decoded ahead.
void* vors_loader_create(const char** depth_paths, const char** color_paths,
                         int n, int height, int width, int num_threads,
                         int max_ahead) {
  auto* ld = new Loader();
  ld->depth_paths.reserve(n);
  ld->color_paths.reserve(n);
  for (int i = 0; i < n; ++i) {
    ld->depth_paths.emplace_back(depth_paths[i]);
    ld->color_paths.emplace_back(color_paths[i]);
  }
  ld->height = height;
  ld->width = width;
  ld->max_ahead = max_ahead < 1 ? 1 : static_cast<size_t>(max_ahead);
  ld->done.resize(n);
  const int nt = num_threads < 1 ? 1 : num_threads;
  for (int i = 0; i < nt; ++i) ld->workers.emplace_back([ld] { ld->worker_loop(); });
  return ld;
}

// Blocking in-order delivery of the next frame pair. Returns 0 on success,
// -1 when the sequence is exhausted, else the frame's decode error code.
int vors_loader_next(void* handle, uint16_t* depth_out, uint8_t* gray_out) {
  auto* ld = static_cast<Loader*>(handle);
  std::unique_ptr<FramePair> fp;
  {
    std::unique_lock<std::mutex> lock(ld->mu);
    if (ld->next_to_deliver >= ld->depth_paths.size()) return -1;
    const size_t idx = ld->next_to_deliver;
    ld->cv_consumer.wait(lock, [&] { return ld->done[idx] != nullptr; });
    fp = std::move(ld->done[idx]);
    ld->next_to_deliver++;
    ld->ahead--;
  }
  ld->cv_worker.notify_all();
  if (fp->status == 0) {
    std::memcpy(depth_out, fp->depth.data(), sizeof(uint16_t) * ld->height * ld->width);
    std::memcpy(gray_out, fp->gray.data(), sizeof(uint8_t) * ld->height * ld->width);
  } else {
    g_last_error = fp->error;
  }
  return fp->status;
}

void vors_loader_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(ld->mu);
    ld->stop = true;
  }
  ld->cv_worker.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
