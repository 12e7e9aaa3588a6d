// BMP decoder of the port's native data library: what PIL 12's
// BmpImagePlugin and its raw unpackers give to Image.open(b).convert("RGB"),
// without PIL.
//
// Headers: CORE (12 bytes: 16-bit sizes, 3-byte palette entries) and INFO
// (40), V2 (52), V3 (56), OS/2 v2 (64), V4 (108) and V5 (124), whose height
// is top-down where its top byte is 0xFF. Pixel formats, as PIL maps them:
//   * 1, 4 and 8 bit with a palette (PIL's P;1, P;4 and P), BGRX entries
//     (BGR for CORE); `colors` 0 means 2^bits; a palette that is black and
//     white (2 colours) or the identity grey ramp is dropped and the rows are
//     read as mode 1 or L (bits, or bytes, whatever the bit depth: PIL's
//     choice), an index past the palette's end is black;
//   * 16 bit: 5-5-5 (BGR;15), or with BI_BITFIELDS 5-6-5 (BGR;16), each
//     channel v * 255 / max;
//   * 24 bit (BGR); 32 bit BI_RGB (BGRX: the fourth byte ignored) and
//     BI_BITFIELDS with PIL's eight byte-aligned mask sets (alpha dropped);
//   * BI_RLE8 and BI_RLE4 by PIL's BmpRleDecoder, with its quirks: a delta
//     takes its offsets from the two bytes after the two it skips, and the
//     decoded bytes are laid out row after row whatever the escapes said;
//     fewer bytes than pixels (an early end of bitmap) fail the image.
// Rows are bottom-up unless the height is negative; a raw row is PIL's
// stride, ((width * bits + 31) >> 3) & ~3, and the raw decoder reads
// (width * unpacker bits + 7) / 8 bytes of it (more than the stride: an
// error). Data that ends before the last row fails the image.
//
// C ABI (built into the library of tarloader.cpp by data/native.py):
//   int bmp_info(const unsigned char* data, long size, int* info,
//                char* msg, int msg_len);          // info[0..1] = width, height
//   int bmp_decode_rgb(const unsigned char* data, long size, unsigned char* out,
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

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

enum Unpack { kP1, kP4, kP8, kBits1, kGrey8, kBGR15, kBGR16, kBGR24, k32 };

struct Bmp {
  const uint8_t* data;
  size_t size;
  uint64_t width = 0, height = 0;
  int bits = 0;
  uint32_t compression = 0;
  int direction = -1;  // -1: bottom-up
  Unpack unpack = kBGR24;
  int shifts[3] = {16, 8, 0};  // k32: the shifts of R, G, B in the 32-bit word
  std::vector<uint8_t> palette;  // RGB triples
  size_t offset = 0;
  bool rle = false, rle4 = false;

  Bmp(const uint8_t* d, size_t n) : data(d), size(n) {}

  void parse() {
    if (size < 14 || data[0] != 'B' || data[1] != 'M') fail("not a BMP file");
    offset = le32(data + 10);
    if (size < 18) fail("BMP: truncated header");
    const uint32_t header_size = le32(data + 14);
    if (header_size < 4 || size - 18 < header_size - 4) fail("BMP: truncated header");
    const uint8_t* hd = data + 18;
    size_t pos = 14 + static_cast<size_t>(header_size);
    int padding = 4;
    uint32_t colors = 0, masks[4] = {0, 0, 0, 0};
    if (header_size == 12) {
      width = le16(hd);
      height = le16(hd + 2);
      bits = static_cast<int>(le16(hd + 6));
      padding = 3;
    } else if (header_size == 40 || header_size == 52 || header_size == 56 ||
               header_size == 64 || header_size == 108 || header_size == 124) {
      const bool y_flip = hd[7] == 0xFF;
      direction = y_flip ? 1 : -1;
      width = le32(hd);
      height = y_flip ? (1ull << 32) - le32(hd + 4) : le32(hd + 4);
      bits = static_cast<int>(le16(hd + 10));
      compression = le32(hd + 12);
      colors = le32(hd + 28);
      if (compression == 3) {
        if (header_size >= 52) {
          for (int i = 0; i < (header_size >= 56 ? 4 : 3); ++i) masks[i] = le32(hd + 36 + 4 * i);
        } else {
          if (size - pos < 12) fail("BMP: truncated bit fields");
          for (int i = 0; i < 3; ++i) masks[i] = le32(data + pos + 4 * i);
          pos += 12;
        }
      }
    } else {
      fail("BMP: unsupported header size " + std::to_string(header_size));
    }
    if (width == 0 || height == 0) fail("BMP: empty image");
    if (width * height > 178956970ull) fail("BMP: image too large");
    uint64_t ncolors = colors ? colors : (bits < 63 ? 1ull << bits : 0);
    if (offset == 14 + header_size && bits <= 8) offset += 4 * ncolors;
    bool palette_mode = false;
    switch (bits) {
      case 1: unpack = kP1; palette_mode = true; break;
      case 4: unpack = kP4; palette_mode = true; break;
      case 8: unpack = kP8; palette_mode = true; break;
      case 16: unpack = kBGR15; break;
      case 24: unpack = kBGR24; break;
      case 32: unpack = k32; break;
      default: fail("BMP: unsupported pixel depth " + std::to_string(bits));
    }
    if (compression == 3) {
      const uint32_t m[4] = {masks[0], masks[1], masks[2], masks[3]};
      auto is = [&](uint32_t r, uint32_t g, uint32_t b, uint32_t a) {
        return m[0] == r && m[1] == g && m[2] == b && m[3] == a;
      };
      auto shift_of = [](uint32_t mask) { return mask ? __builtin_ctz(mask) : 0; };
      if (bits == 32 &&
          (is(0xFF0000, 0xFF00, 0xFF, 0) || is(0xFF000000, 0xFF0000, 0xFF00, 0) ||
           is(0xFF000000, 0xFF00, 0xFF, 0) || is(0xFF000000, 0xFF0000, 0xFF00, 0xFF) ||
           is(0xFF, 0xFF00, 0xFF0000, 0xFF000000) || is(0xFF0000, 0xFF00, 0xFF, 0xFF000000) ||
           is(0xFF000000, 0xFF00, 0xFF, 0xFF0000))) {
        for (int c = 0; c < 3; ++c) shifts[c] = shift_of(m[c]);
      } else if (bits == 32 && is(0, 0, 0, 0)) {
        // PIL reads an all-zero mask set as BGRA
      } else if (bits == 24 && m[0] == 0xFF0000 && m[1] == 0xFF00 && m[2] == 0xFF) {
      } else if (bits == 16 && m[0] == 0xF800 && m[1] == 0x7E0 && m[2] == 0x1F) {
        unpack = kBGR16;
      } else if (bits == 16 && m[0] == 0x7C00 && m[1] == 0x3E0 && m[2] == 0x1F) {
      } else {
        fail("BMP: unsupported bit fields layout");
      }
    } else if (compression == 1 || compression == 2) {
      rle = true;
      rle4 = compression == 2;
    } else if (compression != 0) {
      fail("BMP: unsupported compression " + std::to_string(compression));
    }
    if (palette_mode) {
      if (ncolors == 0 || ncolors > 65536) fail("BMP: unsupported palette size");
      const size_t want = static_cast<size_t>(padding) * ncolors;
      const size_t got = pos < size ? std::min(want, size - pos) : 0;
      const uint8_t* pal = data + std::min(pos, size);
      // PIL's grey check: entry i against (i, i, i) (0 and 255 for two
      // colours); its o8(i) raises past 255
      bool grey = true;
      for (uint64_t i = 0; i < ncolors; ++i) {
        const uint64_t val = ncolors == 2 ? (i ? 255 : 0) : i;
        if (val > 255) fail("BMP: palette of more than 256 colours");
        const size_t at = static_cast<size_t>(i) * padding;
        if (at + 3 > got || pal[at] != val || pal[at + 1] != val || pal[at + 2] != val)
          grey = false;
      }
      if (grey) {
        unpack = ncolors == 2 ? kBits1 : kGrey8;
      } else {
        // ImagePalette.raw("BGRX" / "BGR"): whole entries only
        for (size_t at = 0; at + padding <= got; at += padding) {
          palette.push_back(pal[at + 2]);
          palette.push_back(pal[at + 1]);
          palette.push_back(pal[at]);
        }
      }
      pos += got;
    }
    if (offset == 0) offset = pos;
  }

  int unpack_bits() const {
    switch (unpack) {
      case kP1: case kBits1: return 1;
      case kP4: return 4;
      case kP8: case kGrey8: return 8;
      case kBGR15: case kBGR16: return 16;
      case kBGR24: return 24;
      default: return 32;
    }
  }

  void put_index(uint8_t* out, unsigned k) const {
    if (unpack == kGrey8) {
      out[0] = out[1] = out[2] = static_cast<uint8_t>(k);
    } else if (3 * static_cast<size_t>(k) + 2 < palette.size()) {
      std::memcpy(out, &palette[3 * k], 3);
    } else {
      out[0] = out[1] = out[2] = 0;
    }
  }

  void unpack_row(const uint8_t* in, uint8_t* out) const {
    const size_t w = static_cast<size_t>(width);
    for (size_t x = 0; x < w; ++x, out += 3) {
      switch (unpack) {
        case kP1: put_index(out, (in[x >> 3] >> (7 - (x & 7))) & 1); break;
        case kP4: put_index(out, (in[x >> 1] >> ((x & 1) ? 0 : 4)) & 15); break;
        case kP8: case kGrey8: put_index(out, in[x]); break;
        case kBits1:
          out[0] = out[1] = out[2] = ((in[x >> 3] >> (7 - (x & 7))) & 1) ? 255 : 0;
          break;
        case kBGR15: {
          const int px = in[2 * x] | (in[2 * x + 1] << 8);
          out[2] = static_cast<uint8_t>((px & 31) * 255 / 31);
          out[1] = static_cast<uint8_t>(((px >> 5) & 31) * 255 / 31);
          out[0] = static_cast<uint8_t>(((px >> 10) & 31) * 255 / 31);
          break;
        }
        case kBGR16: {
          const int px = in[2 * x] | (in[2 * x + 1] << 8);
          out[2] = static_cast<uint8_t>((px & 31) * 255 / 31);
          out[1] = static_cast<uint8_t>(((px >> 5) & 63) * 255 / 63);
          out[0] = static_cast<uint8_t>(((px >> 11) & 31) * 255 / 31);
          break;
        }
        case kBGR24:
          out[0] = in[3 * x + 2];
          out[1] = in[3 * x + 1];
          out[2] = in[3 * x];
          break;
        default: {
          const uint32_t v = le32(in + 4 * x);
          for (int c = 0; c < 3; ++c) out[c] = static_cast<uint8_t>(v >> shifts[c]);
        }
      }
    }
  }

  void decode(uint8_t* out) const {
    const size_t w = static_cast<size_t>(width), h = static_cast<size_t>(height);
    auto dst_row = [&](size_t r) { return out + 3 * w * (direction < 0 ? h - 1 - r : r); };
    if (rle) {
      if (unpack != kP1 && unpack != kP4 && unpack != kP8 && unpack != kGrey8)
        fail("BMP: RLE outside modes P and L");
      const std::vector<uint8_t> px = rle_decode();
      if (px.size() < w * h) fail("BMP: not enough image data");
      for (size_t r = 0; r < h; ++r) {
        uint8_t* o = dst_row(r);
        for (size_t x = 0; x < w; ++x) put_index(o + 3 * x, px[r * w + x]);
      }
      return;
    }
    const size_t stride = ((w * bits + 31) >> 3) & ~static_cast<size_t>(3);
    const size_t row_bytes = (w * unpack_bits() + 7) / 8;
    if (row_bytes > stride) fail("BMP: rows shorter than the unpacker reads");
    if (offset > size || (size - offset) < (h - 1) * stride + row_bytes)
      fail("BMP: image file is truncated");
    for (size_t r = 0; r < h; ++r) unpack_row(data + offset + r * stride, dst_row(r));
  }

  // PIL's BmpRleDecoder: the indices, row after row
  std::vector<uint8_t> rle_decode() const {
    const size_t w = static_cast<size_t>(width), dest = w * static_cast<size_t>(height);
    std::vector<uint8_t> px;
    size_t p = std::min(offset, size);
    size_t x = 0;
    auto read1 = [&](int* v) {
      if (p >= size) return false;
      *v = data[p++];
      return true;
    };
    while (px.size() < dest) {
      int num, byte;
      if (!read1(&num) || !read1(&byte)) break;
      if (num) {
        size_t n = static_cast<size_t>(num);
        if (x + n > w) n = x < w ? w - x : 0;
        for (size_t i = 0; i < n; ++i)
          px.push_back(static_cast<uint8_t>(rle4 ? ((i & 1) ? byte & 15 : byte >> 4) : byte));
        x += n;
      } else if (byte == 0) {
        while (px.size() % w) px.push_back(0);
        x = 0;
      } else if (byte == 1) {
        break;
      } else if (byte == 2) {
        if (size - p < 2) break;
        p += 2;
        if (size - p < 2) fail("BMP: truncated RLE delta");
        const size_t right = data[p], up = data[p + 1];
        p += 2;
        px.insert(px.end(), right + up * w, 0);
        x = px.size() % w;
      } else {
        const size_t count = rle4 ? static_cast<size_t>(byte) / 2 : static_cast<size_t>(byte);
        const size_t got = std::min(count, size - p);
        for (size_t i = 0; i < got; ++i) {
          const int v = data[p + i];
          if (rle4) {
            px.push_back(static_cast<uint8_t>(v >> 4));
            px.push_back(static_cast<uint8_t>(v & 15));
          } else {
            px.push_back(static_cast<uint8_t>(v));
          }
        }
        p += got;
        if (got < count) break;
        x += static_cast<size_t>(byte);
        if (p % 2) ++p;
      }
    }
    return px;
  }
};

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

}  // namespace

extern "C" {

int bmp_info(const unsigned char* data, long size, int* info, char* msg, int msg_len) {
  try {
    Bmp b(data, size > 0 ? static_cast<size_t>(size) : 0);
    b.parse();
    info[0] = static_cast<int>(b.width);
    info[1] = static_cast<int>(b.height);
    return 0;
  } catch (const Failure& f) {
    set_msg(msg, msg_len, f.msg);
    return 1;
  }
}

int bmp_decode_rgb(const unsigned char* data, long size, unsigned char* out, long out_size,
                   char* msg, int msg_len) {
  try {
    Bmp b(data, size > 0 ? static_cast<size_t>(size) : 0);
    b.parse();
    if (out_size < 0 || static_cast<uint64_t>(out_size) < 3 * b.width * b.height)
      fail("output buffer too small");
    b.decode(out);
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
