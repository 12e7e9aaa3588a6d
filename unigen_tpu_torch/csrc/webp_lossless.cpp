// VP8L (lossless WebP) and ALPH decoder of the port's native data library:
// the ARGB that libwebp 1.6 decodes for a "VP8L" chunk, and the alpha plane
// of an "ALPH" chunk, without libwebp.
//
// Followed, as libwebp's dec/vp8l_dec.c, dsp/lossless.c and dec/alpha_dec.c
// do it:
//   * the LSB-first bit reader, whose end of stream is a read past the last
//     bit of the data;
//   * the prefix codes: the simple code (one or two symbols) and the normal
//     code with its code-length code (order 17 18 0 1 2 3 4 5 16 6 ...),
//     the repeat codes 16 / 17 / 18 and the optional maximum symbol count;
//     a code whose lengths are all zero, over-subscribed or incomplete is an
//     error, one symbol alone a zero-bit code;
//   * the entropy image (meta prefix codes, groups of five codes), the colour
//     cache (hash 0x1e35a7bd), LZ77 copies with the 120-entry distance map;
//   * the transforms, undone in reverse order: the 14 predictors (and the
//     black one for modes 14 and 15) with their per-channel averages, the
//     select and the clamped add-subtract predictors; cross-colour;
//     subtract-green; colour indexing with 1-, 2- and 4-bit packing and a
//     delta-coded palette padded with zeros;
//   * ALPH: raw or lossless-coded (the green channel) alpha, then the
//     horizontal, vertical or gradient unfilter.
//
// The decision follows libwebp: a read past the end of the data, a bad
// prefix code, a transform twice, a cache size outside 1-11 bits or a copy
// reaching before the first pixel or past the last fails the image.
//
// C ABI (built into the library of tarloader.cpp by data/native.py):
//   int webp_vp8l_decode(const unsigned char* data, long size, int width,
//                        int height, unsigned char* out, char* msg,
//                        int msg_len);   // out: uint8 [height, width, 4] RGBA
//   int webp_alpha_decode(const unsigned char* data, long size, int width,
//                         int height, unsigned char* out, char* msg,
//                         int msg_len);  // out: uint8 [height, width]
// data: the payload of a "VP8L" or an "ALPH" chunk. Both return 0 (ok) or 1
// (corrupt: libwebp fails too), write a message on failure, never abort and
// hold no global state.

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

const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};
// distance codes 1..120 -> (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kMaxCacheBits = 11;
constexpr int kMaxCodeLength = 15;
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
const int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, 256, 256, 256,
                              kNumDistanceCodes};

// ---------------------------------------------------------------------------
// the bit reader

struct BitReader {
  const uint8_t* buf;
  size_t len;
  size_t limit;        // libwebp's reader holds 8 bytes at least: a shorter
  size_t bit_pos = 0;  // stream ends 64 bits in, as zeros
  bool eos = false;

  BitReader(const uint8_t* b, size_t n) : buf(b), len(n), limit(8 * std::max<size_t>(n, 8)) {}
  bool end_of_stream() const { return eos || bit_pos > limit; }
  uint32_t peek(int n) const {  // the next n <= 24 bits, zeros past the end
    const size_t byte = bit_pos >> 3;
    uint64_t w = 0;
    for (size_t i = 0; i < 5; ++i)
      if (byte + i < len) w |= static_cast<uint64_t>(buf[byte + i]) << (8 * i);
    return static_cast<uint32_t>(w >> (bit_pos & 7)) & ((1u << n) - 1);
  }
  void skip(int n) {
    bit_pos += static_cast<size_t>(n);
    if (bit_pos > limit) eos = true;
  }
  uint32_t read(int n) {
    if (eos || n > 24) {
      eos = true;
      return 0;
    }
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

// ---------------------------------------------------------------------------
// canonical prefix codes, read LSB-first

struct HuffmanCode {
  // table of 2^max_len entries: (symbol, length); len 0 with one symbol
  int max_len = 0;
  std::vector<uint32_t> table;  // (length << 16) | symbol

  int read(BitReader& br) const {
    if (max_len == 0) return static_cast<int>(table[0] & 0xffff);
    const uint32_t e = table[br.peek(max_len)];
    br.skip(static_cast<int>(e >> 16));
    return static_cast<int>(e & 0xffff);
  }
  bool single() const { return max_len == 0; }
};

inline uint32_t reverse_bits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((v >> i) & 1u) << (n - 1 - i);
  return r;
}

// libwebp's BuildHuffmanTable: false for a code it rejects
bool build_code(const int* lengths, int n, HuffmanCode* code) {
  int count[kMaxCodeLength + 1] = {0};
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  int nsym = n - count[0];
  int num_open = 1, num_nodes = 1;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return false;
  }
  if (nsym == 1) {
    if (code) {
      code->max_len = 0;
      for (int s = 0; s < n; ++s)
        if (lengths[s]) code->table.assign(1, static_cast<uint32_t>(s));
    }
    return true;
  }
  int max_len = 0;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return false;
    if (count[len]) max_len = len;
  }
  if (num_nodes != 2 * nsym - 1) return false;
  if (!code) return true;
  code->max_len = max_len;
  code->table.assign(static_cast<size_t>(1) << max_len, 0);
  uint32_t next = 0;  // canonical code, MSB-first
  for (int len = 1; len <= max_len; ++len) {
    for (int s = 0; s < n; ++s) {
      if (lengths[s] != len) continue;
      const uint32_t rev = reverse_bits(next, len);
      for (uint32_t hi = 0; hi < (1u << (max_len - len)); ++hi)
        code->table[rev | (hi << len)] = (static_cast<uint32_t>(len) << 16) | static_cast<uint32_t>(s);
      ++next;
    }
    next <<= 1;
  }
  return true;
}

// ---------------------------------------------------------------------------
// the decoder

struct Group {
  HuffmanCode codes[5];
};

struct Transform {
  int type;
  int bits = 0;
  int xsize, ysize;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Decoder {
  BitReader br;
  std::vector<Transform> transforms;
  unsigned transforms_seen = 0;
  bool alpha = false;  // an ALPH stream: libwebp's 8-bit path where it applies

  Decoder(const uint8_t* d, size_t n) : br(d, n) {}

  void read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
    HuffmanCode cl;
    if (!build_code(cl_lengths, 19, &cl)) fail("bad code-length code");
    int max_symbol;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * static_cast<int>(br.read(3));
      max_symbol = 2 + static_cast<int>(br.read(length_nbits));
      if (max_symbol > num_symbols) fail("bad code-length count");
    } else {
      max_symbol = num_symbols;
    }
    int symbol = 0, prev = 8;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      const int code_len = cl.read(br);
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len != 0) prev = code_len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int slot = code_len - 16;
        int repeat = static_cast<int>(br.read(kExtra[slot])) + kOffset[slot];
        if (symbol + repeat > num_symbols) fail("code-length repeat past the alphabet");
        const int length = code_len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = length;
      }
    }
  }

  // reads one prefix code over `alphabet` symbols (into `code` unless null)
  void read_code(int alphabet, HuffmanCode* code) {
    std::vector<int> lengths(static_cast<size_t>(std::max(alphabet, 256)), 0);
    if (br.read(1)) {  // simple code
      const int num_symbols = static_cast<int>(br.read(1)) + 1;
      const int first_len = static_cast<int>(br.read(1));
      int symbol = static_cast<int>(br.read(first_len == 0 ? 1 : 8));
      lengths[symbol] = 1;
      if (num_symbols == 2) {
        symbol = static_cast<int>(br.read(8));
        lengths[symbol] = 1;
      }
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = static_cast<int>(br.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl_lengths[kCodeLengthCodeOrder[i]] = static_cast<int>(br.read(3));
      read_code_lengths(cl_lengths, alphabet, lengths.data());
    }
    if (br.eos) fail("end of stream in a prefix code");
    if (!build_code(lengths.data(), alphabet, code)) fail("bad prefix code");
  }

  void read_transform(int* xsize, int ysize) {
    const int type = static_cast<int>(br.read(2));
    if (transforms_seen & (1u << type)) fail("a transform twice");
    transforms_seen |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    if (type == 0 || type == 1) {  // predictor, cross-colour
      t.bits = static_cast<int>(br.read(3)) + 2;
      t.data = decode_stream(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), false);
    } else if (type == 3) {  // colour indexing
      const int num_colors = static_cast<int>(br.read(8)) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      const int final_num = 1 << (8 >> bits);
      std::vector<uint32_t> full(static_cast<size_t>(final_num), 0);
      uint8_t* nd = reinterpret_cast<uint8_t*>(full.data());
      const uint8_t* od = reinterpret_cast<const uint8_t*>(pal.data());
      for (int i = 0; i < 4; ++i) nd[i] = od[i];
      for (int i = 4; i < 4 * num_colors; ++i) nd[i] = static_cast<uint8_t>(od[i] + nd[i - 4]);
      t.data.swap(full);
    }
    transforms.push_back(std::move(t));
  }

  // the entropy-coded image of xsize x ysize (the main image with
  // `top_level`): transforms, colour cache, codes, then the pixels
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool top_level) {
    int txsize = xsize;
    if (top_level)
      while (br.read(1)) read_transform(&txsize, ysize);
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = static_cast<int>(br.read(4));
      if (cache_bits < 1 || cache_bits > kMaxCacheBits) fail("bad colour cache size");
    }
    // the codes
    int huffman_bits = 0;
    std::vector<uint32_t> huffman_image;
    std::vector<int> mapping;  // group index -> stored group, -1 unused
    int num_groups_max = 1;
    if (top_level && br.read(1)) {
      huffman_bits = static_cast<int>(br.read(3)) + 2;
      const int hx = subsample(txsize, huffman_bits), hy = subsample(ysize, huffman_bits);
      huffman_image = decode_stream(hx, hy, false);
      for (uint32_t& g : huffman_image) {
        g = (g >> 8) & 0xffff;
        if (static_cast<int>(g) >= num_groups_max) num_groups_max = static_cast<int>(g) + 1;
      }
    }
    if (br.eos) fail("end of stream before the prefix codes");
    mapping.assign(static_cast<size_t>(num_groups_max), -1);
    int num_groups = 0;
    if (huffman_image.empty()) {
      mapping[0] = num_groups++;
    } else {
      for (uint32_t g : huffman_image)
        if (mapping[g] < 0) mapping[g] = num_groups++;
    }
    std::vector<Group> groups(static_cast<size_t>(num_groups));
    for (int i = 0; i < num_groups_max; ++i) {
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabetSize[j];
        if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
        read_code(alphabet, mapping[i] < 0 ? nullptr : &groups[mapping[i]].codes[j]);
      }
    }
    if (!huffman_image.empty())
      for (uint32_t& g : huffman_image) g = static_cast<uint32_t>(mapping[g]);
    // libwebp decodes an alpha plane that is only palette indices (one
    // transform, colour indexing; no cache; single-symbol red, blue and alpha
    // codes) on its 8-bit path, which accepts a read past the end by the
    // symbol that completes the plane
    bool lenient = top_level && alpha && transforms.size() == 1 && transforms[0].type == 3 &&
                   cache_bits == 0;
    for (const Group& grp : groups)
      lenient = lenient && grp.codes[RED].single() && grp.codes[BLUE].single() &&
                grp.codes[ALPHA].single();
    std::vector<uint32_t> data(static_cast<size_t>(txsize) * ysize);
    decode_pixels(data.data(), txsize, ysize, cache_bits, groups, huffman_bits, huffman_image,
                  lenient);
    return data;
  }

  void decode_pixels(uint32_t* data, int width, int height, int cache_bits,
                     const std::vector<Group>& groups, int hbits,
                     const std::vector<uint32_t>& himage, bool lenient) {
    const size_t total = static_cast<size_t>(width) * height;
    std::vector<uint32_t> cache(cache_bits ? static_cast<size_t>(1) << cache_bits : 0);
    const int cache_shift = 32 - cache_bits;
    const int hxsize = hbits ? subsample(width, hbits) : 0;
    const int mask = hbits ? (1 << hbits) - 1 : -1;
    const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
    const int cache_limit = len_code_limit + (cache_bits ? 1 << cache_bits : 0);
    size_t pos = 0, last_cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int c, int r) -> const Group& {
      if (!hbits) return groups[0];
      return groups[himage[static_cast<size_t>(r >> hbits) * hxsize + (c >> hbits)]];
    };
    const Group* g = total ? &group_at(0, 0) : nullptr;
    auto insert_cache = [&]() {
      if (cache_bits)
        while (last_cached < pos) {
          const uint32_t argb = data[last_cached++];
          cache[(argb * 0x1e35a7bdu) >> cache_shift] = argb;
        }
    };
    while (pos < total) {
      if ((col & mask) == 0) g = &group_at(col, row);
      const int code = g->codes[GREEN].read(br);
      if (!lenient && br.end_of_stream()) break;
      if (code < kNumLiteralCodes) {
        {
          const uint32_t red = static_cast<uint32_t>(g->codes[RED].read(br));
          const uint32_t blue = static_cast<uint32_t>(g->codes[BLUE].read(br));
          const uint32_t alpha_v = static_cast<uint32_t>(g->codes[ALPHA].read(br));
          if (!lenient && br.end_of_stream()) break;
          data[pos] = (alpha_v << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
        }
      advance_one:
        ++pos;
        ++col;
        if (col >= width) {
          col = 0;
          ++row;
          insert_cache();
        }
      } else if (code < len_code_limit) {
        const int length = copy_value(code - kNumLiteralCodes);
        const int dist_symbol = g->codes[DIST].read(br);
        const int dist_code = copy_value(dist_symbol);
        const size_t dist = plane_to_distance(width, dist_code);
        if (!lenient && br.end_of_stream()) break;
        if (pos < dist || total - pos < static_cast<size_t>(length)) fail("bad backward reference");
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
        pos += static_cast<size_t>(length);
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (col & mask) g = &group_at(col, row);
        insert_cache();
      } else if (code < cache_limit) {
        insert_cache();
        data[pos] = cache[static_cast<size_t>(code - len_code_limit)];
        goto advance_one;
      } else {
        fail("bad literal code");
      }
      if (lenient && br.end_of_stream()) break;
    }
    if (br.end_of_stream() && (!lenient || pos < total)) fail("end of stream in the pixels");
  }

  int copy_value(int symbol) {  // GetCopyLength / GetCopyDistance
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
  }

  static size_t plane_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return static_cast<size_t>(plane_code - 120);
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? static_cast<size_t>(dist) : 1;
  }
};

// ---------------------------------------------------------------------------
// the inverse transforms (dsp/lossless.c)

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
inline uint32_t clamped_add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const uint32_t v = clip255(((c0 >> s) & 0xff) + ((c1 >> s) & 0xff) - ((c2 >> s) & 0xff));
    out |= v << s;
  }
  return out;
}
inline uint32_t clamped_add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = static_cast<int>((ave >> s) & 0xff), b = static_cast<int>((c2 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}

inline uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamped_add_sub_full(L, top[0], top[-1]);
    case 13: return clamped_add_sub_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and the sentinels 14 and 15
  }
}

void inverse_predictor(const Transform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  uint32_t* out = px.data();
  out[0] = add_pixels(out[0], 0xff000000u);
  for (int x = 1; x < w; ++x) out[x] = add_pixels(out[x], out[x - 1]);
  const int tiles_per_row = subsample(w, t.bits);
  for (int y = 1; y < h; ++y) {
    uint32_t* row = out + static_cast<size_t>(y) * w;
    const uint32_t* top = row - w;
    row[0] = add_pixels(row[0], top[0]);
    const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles_per_row;
    for (int x = 1; x < w; ++x) {
      const int mode = static_cast<int>((modes[x >> t.bits] >> 8) & 0xf);
      row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
    }
  }
}

inline int color_delta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

void inverse_cross_color(const Transform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  const int tiles_per_row = subsample(w, t.bits);
  for (int y = 0; y < h; ++y) {
    uint32_t* row = px.data() + static_cast<size_t>(y) * w;
    const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles_per_row;
    for (int x = 0; x < w; ++x) {
      const uint32_t code = codes[x >> t.bits];
      const int8_t g2r = static_cast<int8_t>(code & 0xff);
      const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
      const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
      const uint32_t argb = row[x];
      const int8_t green = static_cast<int8_t>(argb >> 8);
      int new_red = static_cast<int>((argb >> 16) & 0xff);
      int new_blue = static_cast<int>(argb & 0xff);
      new_red += color_delta(g2r, green);
      new_red &= 0xff;
      new_blue += color_delta(g2b, green);
      new_blue += color_delta(r2b, static_cast<int8_t>(new_red));
      new_blue &= 0xff;
      row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) |
               static_cast<uint32_t>(new_blue);
    }
  }
}

void add_green(std::vector<uint32_t>& px) {
  for (uint32_t& argb : px) {
    const uint32_t green = (argb >> 8) & 0xff;
    uint32_t rb = argb & 0x00ff00ffu;
    rb += (green << 16) | green;
    rb &= 0x00ff00ffu;
    argb = (argb & 0xff00ff00u) | rb;
  }
}

std::vector<uint32_t> inverse_color_indexing(const Transform& t, const std::vector<uint32_t>& in) {
  const int w = t.xsize, h = t.ysize;
  const int in_w = subsample(w, t.bits);
  std::vector<uint32_t> out(static_cast<size_t>(w) * h);
  const int bits_per_pixel = 8 >> t.bits;
  const int count_mask = (1 << t.bits) - 1;
  const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
  const uint32_t* map = t.data.data();
  for (int y = 0; y < h; ++y) {
    const uint32_t* src = in.data() + static_cast<size_t>(y) * in_w;
    uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
    uint32_t packed = 0;
    for (int x = 0; x < w; ++x) {
      if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
      dst[x] = map[packed & bit_mask];
      packed >>= bits_per_pixel;
    }
  }
  return out;
}

// the ARGB pixels of a VP8L bitstream after its 5-byte header
std::vector<uint32_t> decode_argb(Decoder& d, int width, int height) {
  std::vector<uint32_t> px = d.decode_stream(width, height, true);
  for (int n = static_cast<int>(d.transforms.size()) - 1; n >= 0; --n) {
    const Transform& t = d.transforms[n];
    switch (t.type) {
      case 0: inverse_predictor(t, px); break;
      case 1: inverse_cross_color(t, px); break;
      case 2: add_green(px); break;
      default: px = inverse_color_indexing(t, px); break;
    }
  }
  return px;
}

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

// the alpha unfilters (dsp/filters.c)
void unfilter_alpha(int filter, uint8_t* a, int width, int height) {
  for (int y = 0; y < height; ++y) {
    uint8_t* row = a + static_cast<size_t>(y) * width;
    const uint8_t* prev = y ? row - width : nullptr;
    if (filter == 1 || prev == nullptr) {  // horizontal, and the first row of each
      uint8_t pred = prev ? prev[0] : 0;
      for (int i = 0; i < width; ++i) {
        row[i] = static_cast<uint8_t>(pred + row[i]);
        pred = row[i];
      }
    } else if (filter == 2) {
      for (int i = 0; i < width; ++i) row[i] = static_cast<uint8_t>(prev[i] + row[i]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = static_cast<uint8_t>(row[i] + pred);
        top_left = top;
        row[i] = left;
      }
    }
  }
}

}  // namespace

extern "C" {

int webp_vp8l_decode(const unsigned char* data, long size, int width, int height,
                     unsigned char* out, char* msg, int msg_len) {
  try {
    const size_t n = size > 0 ? static_cast<size_t>(size) : 0;
    if (n < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) fail("bad VP8L signature");
    Decoder d(data, n);
    d.br.read(8);
    const int w = static_cast<int>(d.br.read(14)) + 1;
    const int h = static_cast<int>(d.br.read(14)) + 1;
    d.br.read(1);  // alpha hint
    if (d.br.read(3) != 0 || d.br.eos) fail("bad VP8L header");
    if (w != width || h != height) fail("VP8L size differs from its header");
    const std::vector<uint32_t> px = decode_argb(d, w, h);
    for (size_t i = 0; i < px.size(); ++i) {
      out[4 * i + 0] = static_cast<uint8_t>(px[i] >> 16);
      out[4 * i + 1] = static_cast<uint8_t>(px[i] >> 8);
      out[4 * i + 2] = static_cast<uint8_t>(px[i]);
      out[4 * i + 3] = static_cast<uint8_t>(px[i] >> 24);
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

int webp_alpha_decode(const unsigned char* data, long size, int width, int height,
                      unsigned char* out, char* msg, int msg_len) {
  try {
    const size_t n = size > 0 ? static_cast<size_t>(size) : 0;
    if (n <= 1) fail("ALPH chunk too short");
    const int method = data[0] & 0x03;
    const int filter = (data[0] >> 2) & 0x03;
    const int pre_processing = (data[0] >> 4) & 0x03;
    const int rsrv = (data[0] >> 6) & 0x03;
    if (method > 1 || filter > 3 || pre_processing > 1 || rsrv != 0) fail("bad ALPH header");
    const size_t total = static_cast<size_t>(width) * height;
    if (method == 0) {
      if (n - 1 < total) fail("ALPH data too short");
      std::memcpy(out, data + 1, total);
    } else {
      Decoder d(data + 1, n - 1);
      d.alpha = true;
      const std::vector<uint32_t> px = decode_argb(d, width, height);
      for (size_t i = 0; i < total; ++i) out[i] = static_cast<uint8_t>(px[i] >> 8);
    }
    if (filter) unfilter_alpha(filter, out, width, height);
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
