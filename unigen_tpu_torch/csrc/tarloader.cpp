// Native data-loading runtime of the port: a threaded tar-shard sample
// streamer and the PNG row unfilter.
//
// The tar streamer is unigen_tpu's csrc/tarloader.cpp as it is: shard
// reading, tar parsing and key-grouping on a background thread with a
// bounded queue, handing Python ready-to-decode sample blobs (image bytes stay
// compressed). The port adds png_unfilter, the per-row filter reversal of a
// PNG's inflated IDAT stream (Sub, Up, Average and Paeth depend on the byte
// to the left, which a Python loop pays for per byte), so that
// unigen_tpu_torch/data/decode.py reads PNG without PIL at host speed.
//
// Built by unigen_tpu_torch/data/native.py with
//   g++ -O3 -std=c++17 -fPIC -Wall -Wextra -pthread -shared
// into unigen_tpu_torch/build/ at first use and loaded with ctypes.
//
// C ABI (ctypes-friendly):
//   void*  tls_open(const char** shards, int n, unsigned seed, int resample,
//                   int queue_cap);
//   long   tls_next(void* h, unsigned char** blob);   // >0 size, 0 eof, <0 err
//   void   tls_free(unsigned char* blob);
//   void   tls_close(void* h);
//   int    png_unfilter(const unsigned char* in, long height, long stride,
//                       int bpp, unsigned char* out);  // 0 ok, else 1 + bad row
//
// Blob layout (little-endian):
//   u16 key_len, key bytes,
//   u16 n_parts, then per part: u16 ext_len, ext bytes, u32 data_len, data.
//
// Tar specifics handled: ustar name+prefix, octal & base-256 sizes, 512-byte
// record alignment, non-file entries skipped, truncated archives tolerated
// (crash-proof semantics like the reference's *_nothrow handlers,
// data_loader.py:113-146).

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Part {
  std::string ext;
  std::vector<uint8_t> data;
};

struct Sample {
  std::string key;
  std::vector<Part> parts;
};

uint64_t parse_size(const char* p) {
  // base-256 (high bit set) or NUL/space-terminated octal
  if (static_cast<unsigned char>(p[0]) & 0x80) {
    uint64_t v = static_cast<unsigned char>(p[0]) & 0x7f;
    for (int i = 1; i < 12; i++) v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  uint64_t v = 0;
  for (int i = 0; i < 12; i++) {
    char c = p[i];
    if (c == '\0' || c == ' ') break;
    if (c < '0' || c > '7') return 0;
    v = (v << 3) | static_cast<uint64_t>(c - '0');
  }
  return v;
}

bool header_all_zero(const unsigned char* h) {
  for (int i = 0; i < 512; i++)
    if (h[i]) return false;
  return true;
}

// Iterate file members of one tar; calls emit(name, bytes). Returns false on a
// fatal open error, true otherwise (parse errors just stop the shard).
template <typename Emit>
bool scan_tar(const std::string& path, Emit emit) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  unsigned char hdr[512];
  while (std::fread(hdr, 1, 512, f) == 512) {
    if (header_all_zero(hdr)) break;
    char name[257];
    std::memcpy(name, hdr, 100);
    name[100] = '\0';
    std::string full;
    if (hdr[345]) {  // ustar prefix
      char prefix[156];
      std::memcpy(prefix, hdr + 345, 155);
      prefix[155] = '\0';
      full = std::string(prefix) + "/" + name;
    } else {
      full = name;
    }
    uint64_t size = parse_size(reinterpret_cast<const char*>(hdr) + 124);
    char type = static_cast<char>(hdr[156]);
    uint64_t padded = (size + 511) & ~511ULL;
    if (type == '0' || type == '\0') {
      std::vector<uint8_t> data(size);
      if (size && std::fread(data.data(), 1, size, f) != size) break;
      if (padded > size && std::fseek(f, static_cast<long>(padded - size), SEEK_CUR))
        break;
      emit(full, std::move(data));
    } else {
      if (padded && std::fseek(f, static_cast<long>(padded), SEEK_CUR)) break;
    }
  }
  std::fclose(f);
  return true;
}

struct Stream {
  std::vector<std::string> shards;
  bool resample;
  size_t queue_cap;
  std::mt19937 rng;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::queue<Sample> queue;
  bool done = false;
  bool stop = false;
  std::thread worker;

  void push(Sample&& s) {
    std::unique_lock<std::mutex> lock(mu);
    cv_push.wait(lock, [&] { return queue.size() < queue_cap || stop; });
    if (stop) return;
    queue.push(std::move(s));
    cv_pop.notify_one();
  }

  void run() {
    std::vector<size_t> order(shards.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = i;
    do {
      if (resample) {
        // sampling-with-replacement shard stream (reference data_loader.py:213-216)
        for (size_t n = 0; n < shards.size() && !stop; n++) {
          size_t pick = rng() % shards.size();
          emit_shard(shards[pick]);
        }
      } else {
        std::shuffle(order.begin(), order.end(), rng);
        for (size_t idx : order) {
          if (stop) break;
          emit_shard(shards[idx]);
        }
      }
    } while (resample && !stop);
    std::lock_guard<std::mutex> lock(mu);
    done = true;
    cv_pop.notify_all();
  }

  void emit_shard(const std::string& path) {
    Sample current;
    scan_tar(path, [&](const std::string& name, std::vector<uint8_t>&& data) {
      if (stop) return;
      auto dot = name.rfind('.');
      std::string key = dot == std::string::npos ? name : name.substr(0, dot);
      std::string ext = dot == std::string::npos ? "" : name.substr(dot);
      if (key != current.key) {
        if (!current.key.empty()) push(std::move(current));
        current = Sample{};
        current.key = key;
      }
      current.parts.push_back(Part{ext, std::move(data)});
    });
    if (!current.key.empty() && !stop) push(std::move(current));
  }
};

std::vector<uint8_t> serialize(const Sample& s) {
  size_t total = 2 + s.key.size() + 2;
  for (const auto& p : s.parts) total += 2 + p.ext.size() + 4 + p.data.size();
  std::vector<uint8_t> out(total);
  uint8_t* w = out.data();
  auto put16 = [&](uint16_t v) { std::memcpy(w, &v, 2); w += 2; };
  auto put32 = [&](uint32_t v) { std::memcpy(w, &v, 4); w += 4; };
  put16(static_cast<uint16_t>(s.key.size()));
  std::memcpy(w, s.key.data(), s.key.size());
  w += s.key.size();
  put16(static_cast<uint16_t>(s.parts.size()));
  for (const auto& p : s.parts) {
    put16(static_cast<uint16_t>(p.ext.size()));
    std::memcpy(w, p.ext.data(), p.ext.size());
    w += p.ext.size();
    put32(static_cast<uint32_t>(p.data.size()));
    std::memcpy(w, p.data.data(), p.data.size());
    w += p.data.size();
  }
  return out;
}

}  // namespace

extern "C" {

void* tls_open(const char** shards, int n, unsigned seed, int resample,
               int queue_cap) {
  if (n <= 0) return nullptr;
  auto* s = new Stream();
  for (int i = 0; i < n; i++) s->shards.emplace_back(shards[i]);
  s->resample = resample != 0;
  s->queue_cap = queue_cap > 0 ? static_cast<size_t>(queue_cap) : 64;
  s->rng.seed(seed);
  s->worker = std::thread([s] { s->run(); });
  return s;
}

long tls_next(void* h, unsigned char** blob) {
  auto* s = static_cast<Stream*>(h);
  Sample sample;
  {
    std::unique_lock<std::mutex> lock(s->mu);
    s->cv_pop.wait(lock, [&] { return !s->queue.empty() || s->done; });
    if (s->queue.empty()) return 0;  // eof
    sample = std::move(s->queue.front());
    s->queue.pop();
    s->cv_push.notify_one();
  }
  auto bytes = serialize(sample);
  auto* out = static_cast<unsigned char*>(std::malloc(bytes.size()));
  if (!out) return -1;
  std::memcpy(out, bytes.data(), bytes.size());
  *blob = out;
  return static_cast<long>(bytes.size());
}

void tls_free(unsigned char* blob) { std::free(blob); }

void tls_close(void* h) {
  auto* s = static_cast<Stream*>(h);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    s->stop = true;
    s->cv_push.notify_all();
    s->cv_pop.notify_all();
  }
  if (s->worker.joinable()) s->worker.join();
  delete s;
}

// PNG filter reversal (PNG spec section 9): `in` holds `height` rows of one
// filter-type byte and `stride` filtered bytes; `out` receives height x stride
// bytes. `bpp` is the byte distance of the left neighbour (bytes a pixel,
// at least 1). Returns 0, or 1 + the row whose filter type is not 0-4.
int png_unfilter(const unsigned char* in, long height, long stride, int bpp,
                 unsigned char* out) {
  std::vector<unsigned char> zero(static_cast<size_t>(stride), 0);
  for (long y = 0; y < height; y++) {
    const unsigned char* src = in + y * (stride + 1);
    const int ft = src[0];
    src++;
    unsigned char* cur = out + y * stride;
    const unsigned char* up = y ? out + (y - 1) * stride : zero.data();
    switch (ft) {
      case 0:
        std::memcpy(cur, src, static_cast<size_t>(stride));
        break;
      case 1:
        for (long i = 0; i < stride; i++)
          cur[i] = static_cast<unsigned char>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < stride; i++)
          cur[i] = static_cast<unsigned char>(src[i] + up[i]);
        break;
      case 3:
        for (long i = 0; i < stride; i++) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = static_cast<unsigned char>(src[i] + ((left + up[i]) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < stride; i++) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up[i];
          const int c = i >= bpp ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<unsigned char>(src[i] + pred);
        }
        break;
      default:
        return static_cast<int>(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
