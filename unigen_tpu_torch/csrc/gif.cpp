// GIF decoder of the port's native data library: frame 0 as PIL 12's
// GifImagePlugin and its LZW decoder (libImaging/GifDecode.c) give it to
// Image.open(b).convert("RGB"), without PIL.
//
// The container, as PIL walks it: the screen (size, global colour table);
// then blocks up to the first image: extensions (a graphic control
// extension's transparency index; comments and application data skipped),
// any other byte skipped; the image descriptor (extent, local colour table,
// interlace) and the LZW minimum code size. A colour table that is the
// identity grey ramp is no palette (PIL's mode L: the index is the grey
// level); a local table replaces the global one. An image reaching past the
// screen grows the canvas. The canvas starts as the transparency index where
// the frame has one, else index 0; the frame is written over it, transparent
// pixels included. convert("RGB") then maps indices through the palette,
// an index past the table's end to black.
//
// LZW as GifDecode.c: code sizes from min + 1 up to 12 bits, growing when
// the next free code reaches the mask (no early change), no new codes once
// 4,096 are in use (a clear comes when the encoder sends it), the KwKwK
// case, sub-blocks taken whole. A first code above the clear code, a code
// past the next free one, or an LZW code size above 12 fails the image; so
// does data that ends before the last row (PIL's "image file is truncated"),
// however the end code came: after an early end code the decoder reads on
// through what follows as PIL's does.
//
// C ABI (built into the library of tarloader.cpp by data/native.py):
//   int gif_info(const unsigned char* data, long size, int* info,
//                char* msg, int msg_len);          // info[0..1] = width, height
//   int gif_decode_rgb(const unsigned char* data, long size, unsigned char* out,
//                      long out_size, char* msg, int msg_len);  // uint8 [H, W, 3]
// Both return 0 (ok) or 1 (corrupt: PIL raises too), write a message on
// failure, never abort and hold no global state.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Failure{msg}; }

inline int le16(const uint8_t* p) { return p[0] | (p[1] << 8); }

struct Gif {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0;
  std::vector<uint8_t> palette;  // RGB triples; empty: mode L
  int transparency = -1;
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  bool interlace = false;
  int lzw_bits = 0;
  size_t lzw_offset = 0;

  Gif(const uint8_t* d, size_t n) : data(d), size(n) {}

  // fp.read(n): at most n bytes
  size_t read(size_t n, const uint8_t** out) {
    const size_t got = std::min(n, size - pos);
    *out = data + pos;
    pos += got;
    return got;
  }
  int read_byte() { return pos < size ? data[pos++] : -1; }
  // GifImageFile.data(): a sub-block, or false at a terminator or the end
  bool sub_block(const uint8_t** p, size_t* n) {
    const int s = read_byte();
    if (s <= 0) return false;
    *n = read(static_cast<size_t>(s), p);
    return true;
  }

  // _is_palette_needed: false for the identity grey ramp; Python's chained
  // comparison reads a short last entry only as far as it matches
  static bool palette_needed(const uint8_t* p, size_t n) {
    for (size_t i = 0; i < n; i += 3) {
      const int k = static_cast<int>(i / 3);
      if (k != p[i]) return true;
      if (i + 1 >= n) fail("GIF: truncated colour table");
      if (p[i] != p[i + 1]) return true;
      if (i + 2 >= n) fail("GIF: truncated colour table");
      if (p[i + 1] != p[i + 2]) return true;
    }
    return false;
  }

  void parse() {
    const uint8_t* s;
    if (read(13, &s) < 13 || (std::memcmp(s, "GIF87a", 6) && std::memcmp(s, "GIF89a", 6)))
      fail("not a GIF file");
    width = le16(s + 6);
    height = le16(s + 8);
    const int flags = s[10];
    std::vector<uint8_t> global;
    bool global_needed = false;
    if (flags & 128) {
      const uint8_t* p;
      const size_t n = read(static_cast<size_t>(3) << ((flags & 7) + 1), &p);
      global_needed = palette_needed(p, n);
      if (global_needed) global.assign(p, p + n);
    }
    int c = read_byte();
    if (c < 0 || c == ';') fail("GIF: no image");
    int local = -1;  // -1 none, 0 an identity table (mode L), 1 a palette
    std::vector<uint8_t> local_table;
    bool found = false;
    while (true) {
      if (c < 0) c = read_byte();
      if (c < 0 || c == ';') break;
      if (c == '!') {
        const int label = read_byte();
        if (label < 0) fail("GIF: truncated extension");
        const uint8_t* block;
        size_t n;
        const bool got = sub_block(&block, &n);
        if (label == 249 && got) {
          if (n < 3) fail("GIF: short graphic control extension");
          if (block[0] & 1) {
            if (n < 4) fail("GIF: short graphic control extension");
            transparency = block[3];
          }
        } else if (label == 254) {
          while (got && sub_block(&block, &n)) {
          }
          c = -1;
          continue;
        } else if (label == 255 && got) {
          if (n >= 11 && std::memcmp(block, "NETSCAPE2.0", 11) == 0) sub_block(&block, &n);
        }
        while (sub_block(&block, &n)) {
        }
      } else if (c == ',') {
        const uint8_t* d;
        if (read(9, &d) < 9) fail("GIF: truncated image descriptor");
        x0 = le16(d);
        y0 = le16(d + 2);
        x1 = x0 + le16(d + 4);
        y1 = y0 + le16(d + 6);
        width = std::max(width, x1);
        height = std::max(height, y1);
        const int f = d[8];
        interlace = (f & 64) != 0;
        if (f & 128) {
          const uint8_t* p;
          const size_t n = read(static_cast<size_t>(3) << ((f & 7) + 1), &p);
          local = palette_needed(p, n) ? 1 : 0;
          if (local == 1) local_table.assign(p, p + n);
        }
        lzw_bits = read_byte();
        if (lzw_bits < 0) fail("GIF: truncated image");
        lzw_offset = pos;
        found = true;
        break;
      }
      c = -1;
    }
    if (!found) fail("GIF: image not found");
    if (local == 1) palette.swap(local_table);
    else if (local == -1) palette.swap(global);
    if (width <= 0 || height <= 0) fail("GIF: empty image");
    if (static_cast<uint64_t>(width) * height > 178956970ull) fail("GIF: image too large");
    if (x1 <= x0 || y1 <= y0) fail("GIF: tile cannot extend outside image");
  }

  // GifDecode.c over everything from the LZW data to the end of the file
  void decode(std::vector<uint8_t>& idx) const {
    if (lzw_bits > 12) fail("GIF: bad LZW code size");
    const int xsize = x1 - x0, ysize = y1 - y0;
    const int clear = 1 << lzw_bits, end = clear + 1;
    constexpr int kTable = 4096;
    std::vector<uint8_t> table_data(kTable), buffer(kTable + 1);
    std::vector<uint16_t> link(kTable);
    int next = clear + 2, codesize = lzw_bits + 1, codemask = (1 << codesize) - 1;
    int state = 2;  // 2: the first code after a clear, 3: the rest
    int lastdata = 0, lastcode = 0;
    uint32_t bitbuffer = 0;
    int bitcount = 0, blocksize = 0;
    int step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
    int x = 0, y = 0;
    size_t ptr = lzw_offset;
    // PIL feeds its decoder 64 KiB reads: when the decoder stops for more
    // data, the next read must bring some, else the file is truncated
    size_t avail = std::min(size, lzw_offset + 65536);
    auto read_more = [&]() {
      if (avail >= size) fail("GIF: image file is truncated");
      avail = std::min(size, avail + 65536);
    };
    auto row = [&]() { return &idx[static_cast<size_t>(y + y0) * width + x0]; };
    uint8_t* out = row();
    // NEWLINE: false when the frame is complete
    auto newline = [&]() -> bool {
      x = 0;
      y += step;
      while (y >= ysize) {
        switch (pass) {
          case 1: y = 4; pass = 2; break;
          case 2: step = 4; y = 2; pass = 3; break;
          case 3: step = 2; y = 1; pass = 0; break;
          default: return false;
        }
      }
      out = row();
      return true;
    };
    while (true) {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= static_cast<uint32_t>(data[ptr++]) << bitcount;
          bitcount += 8;
          --blocksize;
        } else {
          while (ptr >= avail || avail - ptr < static_cast<size_t>(data[ptr]) + 1) read_more();
          blocksize = data[ptr++];
        }
      }
      int c = static_cast<int>(bitbuffer & static_cast<uint32_t>(codemask));
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) {
          next = clear + 2;
          codesize = lzw_bits + 1;
          codemask = (1 << codesize) - 1;
          state = 2;
        }
        continue;
      }
      if (c == end) {  // PIL's decoder stops; it goes on with the next read, if any
        read_more();
        continue;
      }
      const uint8_t* p;
      int n = 1;
      int bufferindex = kTable + 1;
      uint8_t single;
      if (state == 2) {
        if (c > clear) fail("GIF: broken LZW data");
        lastdata = lastcode = c;
        single = static_cast<uint8_t>(c);
        p = &single;
        state = 3;
      } else {
        const int thiscode = c;
        if (c > next) fail("GIF: broken LZW data");
        if (c == next) {
          buffer[--bufferindex] = static_cast<uint8_t>(lastdata);
          c = lastcode;
        }
        while (c >= clear) {
          if (bufferindex <= 1 || c >= kTable) fail("GIF: broken LZW data");
          buffer[--bufferindex] = table_data[c];
          c = link[c];
        }
        lastdata = c;
        buffer[--bufferindex] = static_cast<uint8_t>(c);
        if (next < kTable) {
          table_data[next] = static_cast<uint8_t>(c);
          link[next] = static_cast<uint16_t>(lastcode);
          if (next == codemask && codesize < 12) {
            ++codesize;
            codemask = (1 << codesize) - 1;
          }
          ++next;
        }
        lastcode = thiscode;
        p = &buffer[bufferindex];
        n = kTable + 1 - bufferindex;
      }
      for (int i = 0; i < n; ++i) {
        *out++ = p[i];
        if (++x >= xsize && !newline()) return;
      }
    }
  }
};

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

}  // namespace

extern "C" {

int gif_info(const unsigned char* data, long size, int* info, char* msg, int msg_len) {
  try {
    Gif g(data, size > 0 ? static_cast<size_t>(size) : 0);
    g.parse();
    info[0] = g.width;
    info[1] = g.height;
    return 0;
  } catch (const Failure& f) {
    set_msg(msg, msg_len, f.msg);
    return 1;
  }
}

int gif_decode_rgb(const unsigned char* data, long size, unsigned char* out, long out_size,
                   char* msg, int msg_len) {
  try {
    Gif g(data, size > 0 ? static_cast<size_t>(size) : 0);
    g.parse();
    const size_t n = static_cast<size_t>(g.width) * g.height;
    if (out_size < 0 || static_cast<size_t>(out_size) < 3 * n) fail("output buffer too small");
    std::vector<uint8_t> idx(n, static_cast<uint8_t>(g.transparency >= 0 ? g.transparency : 0));
    g.decode(idx);
    for (size_t i = 0; i < n; ++i) {
      const size_t k = idx[i];
      if (g.palette.empty()) {
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = idx[i];
      } else if (3 * k + 2 < g.palette.size()) {
        std::memcpy(out + 3 * i, &g.palette[3 * k], 3);
      } else {
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = 0;
      }
    }
    return 0;
  } catch (const Failure& f) {
    set_msg(msg, msg_len, f.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
    return 1;
  }
}

}  // extern "C"
