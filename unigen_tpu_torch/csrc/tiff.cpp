// TIFF codecs of the port's native data library: what libtiff 4.7 (under PIL
// 12) does to a strip or a tile, and PIL's conversions, without either. The
// directory, the strip and tile layout and the unpacking are read by
// data/tiff.py; Deflate is inflated there by zlib.
//
//   * LZW (tif_lzw.c, the new-style codes): MSB-first codes of 9 to 12 bits,
//     widening one code early (at 511, 1023, 2047), clear 256, end 257. A
//     strip must open with a clear code; a first code after a clear above
//     it, a code past the next free one, a table past its 5,119 entries, or
//     an end of data (or an end code) before the requested bytes fails, as
//     libtiff's "Corrupted LZW table" and "Not enough data" do; bytes after
//     the requested ones are not read.
//   * PackBits (tif_packbits.c): runs cut at the requested size; too little
//     data for it fails.
//   * Predictor 2 (tif_predict.c): horizontal differencing of 8- or 16-bit
//     samples, each row on its own, 16-bit samples in the file's byte order.
//   * PIL's conversions to RGB: CMYK (cmyk2rgb: 255 - k, less c x (255 - k)
//     / 255 rounded PIL's way) and associated alpha (the "RGBa" unpacker:
//     c * 255 / a, 0 where a is 0; convert("RGB") then drops a).
//
// C ABI (built into the library of tarloader.cpp by data/native.py):
//   long tiff_lzw_decode(const unsigned char* data, long size, unsigned char* out,
//                        long out_size, char* msg, int msg_len);
//   long tiff_packbits_decode(...same...);
//       out_size bytes decoded into out: returns out_size, or -1 (corrupt:
//       libtiff fails too) or -2 (old-style LZW, which the port does not
//       decode) with a message
//   void tiff_unpredict(unsigned char* buf, long rows, long row_bytes,
//                       int samples, int bits, int big_endian);
//   void tiff_to_rgb(const unsigned char* px, long n, int kind,
//                    unsigned char* out);  // kind 0: CMYK, 1: RGBa; px [n, 4]
// None holds global state or aborts.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string msg;
  long status = -1;  // -2: a variant the port does not decode
};

[[noreturn]] void fail(const std::string& msg) { throw Failure{msg}; }

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kTableSize = 4095 + 1024;  // libtiff's CSIZE

struct Code {
  int next;  // the prefix's code, -1 none
  int length;
  uint8_t value, firstchar;
};

void lzw_decode(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) throw Failure{"TIFF: old-style LZW codes", -2};
  std::vector<Code> table(kTableSize);
  for (int i = 0; i < 256; ++i) table[i] = Code{-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  size_t bitpos = 0;
  const size_t nbits_total = 8 * n;
  int nbits = 9;
  int free_ent = kFirst;
  int maxcode = (1 << nbits) - 2;  // the entry past which codes widen
  int oldcode = -2;                // none yet: a first code that is no clear fails
  auto next_code = [&]() -> int {
    if (nbits_total - bitpos < static_cast<size_t>(nbits)) return kEoi;  // "not terminated"
    int code = 0;
    for (int i = 0; i < nbits; ++i, ++bitpos)
      code = (code << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return code;
  };
  size_t op = 0;
  while (op < occ) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      for (int i = kFirst; i < kTableSize; ++i) table[i] = Code{-1, 0, 0, 0};
      free_ent = kFirst;
      nbits = 9;
      maxcode = (1 << nbits) - 2;
      code = next_code();
      if (code == kEoi) break;
      if (code > kClear) fail("TIFF LZW: corrupted LZW table");
      out[op++] = static_cast<uint8_t>(code);
      oldcode = code;
      continue;
    }
    if (oldcode == -2 || free_ent >= kTableSize) fail("TIFF LZW: corrupted LZW table");
    Code& e = table[free_ent];
    e.next = oldcode;
    e.firstchar = table[oldcode].firstchar;
    e.length = table[oldcode].length + 1;
    e.value = code < free_ent ? table[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = (1 << nbits) - 2;
    }
    oldcode = code;
    if (code >= 256) {
      const Code& c = table[code];
      if (c.length == 0) fail("TIFF LZW: wrong length of decoded string");
      const size_t len = static_cast<size_t>(c.length);
      // the string, written backwards; the part past the request is dropped
      int k = code;
      for (size_t i = len; i-- > 0;) {
        if (op + i < occ) out[op + i] = table[k].value;
        k = table[k].next;
      }
      op += len < occ - op ? len : occ - op;
    } else {
      out[op++] = static_cast<uint8_t>(code);
    }
  }
  if (op < occ) fail("TIFF LZW: not enough data");
}

void packbits_decode(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  size_t cc = n, op = 0, bp = 0;
  while (cc > 0 && op < occ) {
    long k = static_cast<int8_t>(in[bp++]);
    --cc;
    if (k < 0) {
      if (k == -128) continue;
      size_t run = static_cast<size_t>(-k + 1);
      if (occ - op < run) run = occ - op;
      if (cc == 0) break;
      const uint8_t b = in[bp++];
      --cc;
      std::memset(out + op, b, run);
      op += run;
    } else {
      size_t lit = static_cast<size_t>(k) + 1;
      if (occ - op < lit) lit = occ - op;
      if (cc < lit) break;
      std::memcpy(out + op, in + bp, lit);
      op += lit;
      bp += lit;
      cc -= lit;
    }
  }
  if (op < occ) fail("TIFF PackBits: not enough data");
}

}  // namespace

extern "C" {

long tiff_lzw_decode(const unsigned char* data, long size, unsigned char* out, long out_size,
                     char* msg, int msg_len) {
  try {
    lzw_decode(data, size > 0 ? static_cast<size_t>(size) : 0, out,
               out_size > 0 ? static_cast<size_t>(out_size) : 0);
    return out_size;
  } catch (const Failure& f) {
    set_msg(msg, msg_len, f.msg);
    return f.status;
  }
}

long tiff_packbits_decode(const unsigned char* data, long size, unsigned char* out,
                          long out_size, char* msg, int msg_len) {
  try {
    packbits_decode(data, size > 0 ? static_cast<size_t>(size) : 0, out,
                    out_size > 0 ? static_cast<size_t>(out_size) : 0);
    return out_size;
  } catch (const Failure& f) {
    set_msg(msg, msg_len, f.msg);
    return -1;
  }
}

void tiff_unpredict(unsigned char* buf, long rows, long row_bytes, int samples, int bits,
                    int big_endian) {
  for (long r = 0; r < rows; ++r) {
    unsigned char* row = buf + r * row_bytes;
    if (bits == 8) {
      for (long i = samples; i < row_bytes; ++i)
        row[i] = static_cast<unsigned char>(row[i] + row[i - samples]);
    } else {
      const long n = row_bytes / 2;
      auto get = [&](long i) -> unsigned {
        return big_endian ? (row[2 * i] << 8) | row[2 * i + 1] : row[2 * i] | (row[2 * i + 1] << 8);
      };
      for (long i = samples; i < n; ++i) {
        const unsigned v = (get(i) + get(i - samples)) & 0xffff;
        row[2 * i + (big_endian ? 0 : 1)] = static_cast<unsigned char>(v >> 8);
        row[2 * i + (big_endian ? 1 : 0)] = static_cast<unsigned char>(v);
      }
    }
  }
}

void tiff_to_rgb(const unsigned char* px, long n, int kind, unsigned char* out) {
  for (long i = 0; i < n; ++i, px += 4, out += 3) {
    if (kind == 0) {
      const int nk = 255 - px[3];
      for (int c = 0; c < 3; ++c) {
        const int tmp = px[c] * nk + 128;
        const int v = nk - (((tmp >> 8) + tmp) >> 8);
        out[c] = static_cast<unsigned char>(v < 0 ? 0 : v > 255 ? 255 : v);
      }
    } else {
      const int a = px[3];
      for (int c = 0; c < 3; ++c) {
        const int v = a == 0 ? 0 : a == 255 ? px[c] : px[c] * 255 / a;
        out[c] = static_cast<unsigned char>(v > 255 ? 255 : v);
      }
    }
  }
}

}  // extern "C"
