// stereo_io — native data-loading runtime for stereo_reconstruction.
//
// The reference implementation's data layer is native C++ (OpenCV imread +
// the Middlebury SDK's imageLib PFM reader, see reference
// src/DataLoader/data_loader.cpp). This library is its framework
// equivalent: a dependency-light C++17 loader (PNG via zlib inflate, PFM,
// calib.txt) with a std::thread prefetch pool, exposed through a C ABI for
// ctypes binding (no pybind11 in this environment).
//
// Build: see native/Makefile (g++ -O2 -shared -fPIC, links -lz).

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG decoding (8-bit, non-interlaced; gray / gray+alpha / RGB / RGBA / palette)
// ---------------------------------------------------------------------------

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;           // channels in `data`
  std::vector<uint8_t> data;  // row-major, tightly packed
  std::string error;
};

uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END || (rc == Z_OK && zs.avail_out == 0);
}

Image decode_png(const std::string& path) {
  Image img;
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    img.error = "cannot open " + path;
    return img;
  }
  std::vector<uint8_t> file((std::istreambuf_iterator<char>(f)),
                            std::istreambuf_iterator<char>());
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (file.size() < 8 || std::memcmp(file.data(), sig, 8) != 0) {
    img.error = "not a PNG: " + path;
    return img;
  }

  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // RGB triples
  std::vector<uint8_t> trns;

  size_t pos = 8;
  while (pos + 8 <= file.size()) {
    uint32_t len = read_be32(&file[pos]);
    std::string type(reinterpret_cast<char*>(&file[pos + 4]), 4);
    const uint8_t* payload = &file[pos + 8];
    if (pos + 12 + len > file.size()) break;

    if (type == "IHDR") {
      img.width = static_cast<int>(read_be32(payload));
      img.height = static_cast<int>(read_be32(payload + 4));
      bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
    } else if (type == "PLTE") {
      palette.assign(payload, payload + len);
    } else if (type == "tRNS") {
      trns.assign(payload, payload + len);
    } else if (type == "IDAT") {
      idat.insert(idat.end(), payload, payload + len);
    } else if (type == "IEND") {
      break;
    }
    pos += 12 + len;
  }

  if (interlace != 0) {
    img.error = "interlaced PNG unsupported: " + path;
    return img;
  }
  if (bit_depth != 8) {
    if (bit_depth == 16 || bit_depth == 1 || bit_depth == 2 || bit_depth == 4) {
      img.error = "bit depth " + std::to_string(bit_depth) + " unsupported: " + path;
      return img;
    }
    img.error = "bad bit depth: " + path;
    return img;
  }

  int src_ch = 0;
  switch (color_type) {
    case 0: src_ch = 1; break;  // gray
    case 2: src_ch = 3; break;  // RGB
    case 3: src_ch = 1; break;  // palette index
    case 4: src_ch = 2; break;  // gray+alpha
    case 6: src_ch = 4; break;  // RGBA
    default:
      img.error = "bad color type: " + path;
      return img;
  }

  const size_t stride = static_cast<size_t>(img.width) * src_ch;
  std::vector<uint8_t> raw((stride + 1) * img.height);
  if (!inflate_all(idat, raw)) {
    img.error = "zlib inflate failed: " + path;
    return img;
  }

  // de-filter in place into `un`
  std::vector<uint8_t> un(stride * img.height);
  const int bpp = src_ch;
  for (int y = 0; y < img.height; y++) {
    const uint8_t ftype = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &un[stride * y];
    const uint8_t* up = y > 0 ? &un[stride * (y - 1)] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= static_cast<size_t>(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= static_cast<size_t>(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (ftype) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default:
          img.error = "bad PNG filter: " + path;
          return img;
      }
      dst[x] = static_cast<uint8_t>(v);
    }
  }

  if (color_type == 3) {
    // expand palette to RGB
    img.channels = 3;
    img.data.resize(static_cast<size_t>(img.width) * img.height * 3);
    for (size_t i = 0; i < un.size(); i++) {
      const uint8_t idx = un[i];
      if (static_cast<size_t>(idx) * 3 + 2 < palette.size()) {
        img.data[i * 3 + 0] = palette[idx * 3 + 0];
        img.data[i * 3 + 1] = palette[idx * 3 + 1];
        img.data[i * 3 + 2] = palette[idx * 3 + 2];
      }
    }
  } else {
    img.channels = src_ch;
    img.data = std::move(un);
  }
  return img;
}

// ---------------------------------------------------------------------------
// PFM
// ---------------------------------------------------------------------------

struct FloatImage {
  int width = 0;
  int height = 0;
  int channels = 0;
  std::vector<float> data;  // top-down row-major
  std::string error;
};

FloatImage read_pfm(const std::string& path) {
  FloatImage img;
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    img.error = "cannot open " + path;
    return img;
  }
  std::string header;
  f >> header;
  if (header == "PF") {
    img.channels = 3;
  } else if (header == "Pf") {
    img.channels = 1;
  } else {
    img.error = "bad PFM header in " + path;
    return img;
  }
  double scale;
  f >> img.width >> img.height >> scale;
  f.get();  // single whitespace byte before payload
  const bool little = scale < 0;
  const size_t count =
      static_cast<size_t>(img.width) * img.height * img.channels;
  std::vector<float> buf(count);
  f.read(reinterpret_cast<char*>(buf.data()), count * sizeof(float));
  if (!f) {
    img.error = "short PFM payload in " + path;
    return img;
  }
  if (!little) {
    for (auto& v : buf) {
      uint32_t u;
      std::memcpy(&u, &v, 4);
      u = __builtin_bswap32(u);
      std::memcpy(&v, &u, 4);
    }
  }
  // PFM rows are stored bottom-up; flip to top-down
  img.data.resize(count);
  const size_t row = static_cast<size_t>(img.width) * img.channels;
  for (int y = 0; y < img.height; y++) {
    std::memcpy(&img.data[row * y], &buf[row * (img.height - 1 - y)],
                row * sizeof(float));
  }
  return img;
}

bool write_pfm(const std::string& path, const float* data, int height,
               int width, int channels) {
  std::ofstream f(path, std::ios::binary);
  if (!f) return false;
  f << (channels == 3 ? "PF" : "Pf") << "\n"
    << width << " " << height << "\n"
    << "-1.000000\n";
  const size_t row = static_cast<size_t>(width) * channels;
  for (int y = height - 1; y >= 0; y--) {
    f.write(reinterpret_cast<const char*>(data + row * y),
            row * sizeof(float));
  }
  return static_cast<bool>(f);
}

// ---------------------------------------------------------------------------
// Thread-pool prefetcher
// ---------------------------------------------------------------------------

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; i++) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

std::string g_last_error;
std::mutex g_error_mu;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lk(g_error_mu);
  g_last_error = msg;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Queries an image header. Returns 0 on success.
int stereo_io_png_info(const char* path, int* width, int* height,
                       int* channels) {
  Image img = decode_png(path);  // simple: full decode (cached by OS fs cache)
  if (!img.error.empty()) {
    set_error(img.error);
    return -1;
  }
  *width = img.width;
  *height = img.height;
  *channels = img.channels;
  return 0;
}

// Decodes a PNG into caller-allocated buffer (h*w*channels bytes).
int stereo_io_png_read(const char* path, uint8_t* out, int expected_h,
                       int expected_w, int expected_c) {
  Image img = decode_png(path);
  if (!img.error.empty()) {
    set_error(img.error);
    return -1;
  }
  if (img.height != expected_h || img.width != expected_w) {
    set_error("shape mismatch for " + std::string(path));
    return -2;
  }
  const size_t n = static_cast<size_t>(expected_h) * expected_w;
  if (img.channels == expected_c) {
    std::memcpy(out, img.data.data(), n * expected_c);
  } else if (expected_c == 3 && img.channels == 1) {
    for (size_t i = 0; i < n; i++)
      out[i * 3] = out[i * 3 + 1] = out[i * 3 + 2] = img.data[i];
  } else if (expected_c == 3 && img.channels == 4) {
    for (size_t i = 0; i < n; i++) {
      out[i * 3 + 0] = img.data[i * 4 + 0];
      out[i * 3 + 1] = img.data[i * 4 + 1];
      out[i * 3 + 2] = img.data[i * 4 + 2];
    }
  } else if (expected_c == 1 && img.channels >= 3) {
    for (size_t i = 0; i < n; i++) {
      // BT.601 luma rounding like cvtColor
      const int v = (299 * img.data[i * img.channels] +
                     587 * img.data[i * img.channels + 1] +
                     114 * img.data[i * img.channels + 2] + 500) /
                    1000;
      out[i] = static_cast<uint8_t>(v);
    }
  } else {
    set_error("channel conversion unsupported");
    return -3;
  }
  return 0;
}

int stereo_io_pfm_info(const char* path, int* width, int* height,
                       int* channels) {
  FloatImage img = read_pfm(path);
  if (!img.error.empty()) {
    set_error(img.error);
    return -1;
  }
  *width = img.width;
  *height = img.height;
  *channels = img.channels;
  return 0;
}

int stereo_io_pfm_read(const char* path, float* out, int expected_h,
                       int expected_w, int expected_c) {
  FloatImage img = read_pfm(path);
  if (!img.error.empty()) {
    set_error(img.error);
    return -1;
  }
  if (img.height != expected_h || img.width != expected_w ||
      img.channels != expected_c) {
    set_error("shape mismatch for " + std::string(path));
    return -2;
  }
  std::memcpy(out, img.data.data(),
              img.data.size() * sizeof(float));
  return 0;
}

int stereo_io_pfm_write(const char* path, const float* data, int h, int w,
                        int c) {
  return write_pfm(path, data, h, w, c) ? 0 : -1;
}

// Parallel batch PNG load: n images into one packed buffer of
// (n, h, w, c) uint8. paths is a NUL-separated, double-NUL-terminated list.
int stereo_io_png_read_batch(const char* paths_joined, int n, uint8_t* out,
                             int h, int w, int c, int num_threads) {
  std::vector<std::string> paths;
  const char* p = paths_joined;
  for (int i = 0; i < n; i++) {
    paths.emplace_back(p);
    p += paths.back().size() + 1;
  }
  std::atomic<int> failures{0};
  std::atomic<int> remaining{n};
  std::mutex done_mu;
  std::condition_variable done_cv;
  {
    ThreadPool pool(num_threads > 0 ? num_threads
                                    : std::thread::hardware_concurrency());
    const size_t sz = static_cast<size_t>(h) * w * c;
    for (int i = 0; i < n; i++) {
      pool.submit([&, i] {
        if (stereo_io_png_read(paths[i].c_str(), out + sz * i, h, w, c) != 0)
          failures.fetch_add(1);
        if (remaining.fetch_sub(1) == 1) {
          std::lock_guard<std::mutex> lk(done_mu);
          done_cv.notify_one();
        }
      });
    }
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [&] { return remaining.load() == 0; });
  }
  return failures.load() == 0 ? 0 : -1;
}

const char* stereo_io_last_error() {
  std::lock_guard<std::mutex> lk(g_error_mu);
  return g_last_error.c_str();
}

}  // extern "C"
