// JPEG decoder of the port's native data library: what libjpeg-turbo, under
// PIL, returns for Image.open(b).convert("RGB"), without PIL.
//
// Read: SOI, APPn (APP0 JFIF and APP14 Adobe decide the colour space), DQT
// (8- and 16-bit tables), SOF0/SOF1/SOF2 at 8-bit precision, DHT, DRI with
// RST0-7, SOS, COM, DNL and EOI. Huffman-coded baseline and extended
// sequential scans, interleaved or not, and progressive scans (DC first and
// refine, AC first and refine, EOB runs) into one coefficient buffer a
// component. Then, as libjpeg-turbo does with its defaults:
//   * jidctint.c's ISLOW integer IDCT and its post-IDCT range limit;
//   * jdsample.c's fancy upsampling (h2v1, h2v2 and h1v2 triangle filters;
//     box replication for other integral factors and for h2 components at
//     most 2 samples wide);
//   * jdcolor.c's fixed-point YCbCr -> RGB, grey repeated, RGB passed
//     through (Adobe transform 0), YCCK -> CMYK, and CMYK to RGB as PIL's
//     "CMYK;I" unpacker and convert("RGB") do.
// No EXIF orientation is applied (PIL's open applies none).
//
// The decision to return pixels or to fail follows PIL: its own marker walk
// up to the first SOS, then libjpeg's, whose warnings (a bad Huffman code, a
// marker inside the entropy data, lost restart markers) PIL ignores and whose
// errors it raises; a stream that ends where libjpeg would wait for more
// bytes is "image file is truncated", as PIL's incremental feed makes it,
// until every row is out: then PIL's jpeg_finish_decompress reads on to EOI,
// where a bad marker fails the image and the end of the data does not. A
// multi-scan image is read to EOI before its first row. Where the entropy
// data is corrupt the pixels may differ from libjpeg's; the decision does not.
//
// Lossless (SOF3/7/11/15), hierarchical (SOF5-7/13-15) and arithmetic-coded
// (SOF9-11) JPEG and 12- or 16-bit precision are reported as unsupported,
// naming the variant.
//
// C ABI (built into the library of tarloader.cpp by data/native.py):
//   int jpeg_info(const unsigned char* data, long size, int* info,
//                 char* msg, int msg_len);
//       info[0..4] = width, height, components, SOF marker (0xC0..), precision
//   int jpeg_decode_rgb(const unsigned char* data, long size,
//                       unsigned char* out, long out_size,
//                       char* msg, int msg_len);   // out: uint8 [H, W, 3]
// Both return 0 (ok), 1 (corrupt: PIL raises too) or 2 (unsupported
// variant), write a message on failure, and never abort. They hold no global
// state, so any number of threads may call them.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2 };

struct Failure {
  int status;
  std::string msg;
};

// libjpeg suspends for more input: PIL raises "image file is truncated",
// unless every row is out (then it stops reading, done)
struct Suspend {};
// libjpeg suspends inside a sequential MCU and PIL has more of the file:
// the MCU is decoded again from its start with the next block of bytes
struct NeedMore {};

// PIL feeds libjpeg the file in blocks of this many bytes (ImageFile.MAXBLOCK)
constexpr size_t kPilBlock = 65536;
// libjpeg-turbo's fast Huffman path runs while this many bytes a block of
// the MCU are left in PIL's buffer (jdhuff.c's BUFSIZE)
constexpr size_t kFastBytesPerBlock = 512;

[[noreturn]] void fail(const std::string& msg) { throw Failure{kCorrupt, msg}; }
[[noreturn]] void truncated() { throw Suspend{}; }

// zigzag -> natural order; the 16 extra entries catch k past 63 in corrupt data
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jstdhuff.c: the tables installed where a stream defines none (slots 0, 1)
const uint8_t kStdDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {          // a DHT table as defined in the stream
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

constexpr int kLookahead = 8;  // HUFF_LOOKAHEAD

struct HuffTable {         // jdhuff.c's d_derived_tbl
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[1 << kLookahead];  // (code length << 8) | symbol; length 9: slow path
  uint8_t vals[256];
};

// jpeg_make_d_derived_tbl, with its checks
void derive(const HuffSpec& spec, bool is_dc, HuffTable* t) {
  char huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = spec.bits[l];
    if (p + i > 256) fail("bad Huffman table");
    while (i--) huffsize[p++] = static_cast<char>(l);
  }
  huffsize[p] = 0;
  const int nsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      ++code;
    }
    if (static_cast<int64_t>(code) >= (int64_t{1} << si)) fail("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (spec.bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += spec.bits[l];
      t->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  for (int i = 0; i < (1 << kLookahead); ++i) t->lookup[i] = (kLookahead + 1) << kLookahead;
  p = 0;
  for (int l = 1; l <= kLookahead; ++l) {
    for (int i = 1; i <= spec.bits[l]; ++i, ++p) {
      int look = static_cast<int>(huffcode[p] << (kLookahead - l));
      for (int ctr = 1 << (kLookahead - l); ctr > 0; --ctr) {
        t->lookup[look++] = static_cast<uint16_t>((l << kLookahead) | spec.vals[p]);
      }
    }
  }
  if (is_dc) {
    for (int i = 0; i < nsymbols; ++i) {
      if (spec.vals[i] > 15) fail("bad Huffman table");
    }
  }
  std::memcpy(t->vals, spec.vals, sizeof(t->vals));
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int width_in_blocks = 0, height_in_blocks = 0;  // true blocks
  int bw = 0, bh = 0;                             // allocated (MCU-padded) blocks
  int dw = 0, dh = 0;                             // downsampled_width / height
  bool latched = false;
  int quant[64] = {};                             // natural order
  std::vector<int16_t> coef;                      // [bh][bw][64]
  int16_t* block(int by, int bx) { return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64; }
};

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size)
      : data_(data), size_(size), chunk_end_(std::min(size, kPilBlock)) {}

  // The marker walk to the first SOS and its set-up (PIL's open, then
  // libjpeg's jpeg_read_header).
  void read_header();
  // Every scan, then the output pass into out [height][width][3] (out_size
  // bytes, checked against the header).
  void decode(uint8_t* out, size_t out_size);

  int width = 0, height = 0, ncomp = 0, sof = 0, precision = 0;

 private:
  // ---- byte input
  int byte() {
    if (pos_ >= chunk_end_) more_input();
    return data_[pos_++];
  }
  void more_input() {
    if (chunk_end_ >= size_) truncated();
    chunk_end_ = std::min(size_, chunk_end_ + kPilBlock);
    if (retry_mcu_) throw NeedMore{};
  }
  int two_bytes() {
    int a = byte();
    return (a << 8) | byte();
  }
  void skip(long n) {
    if (n <= 0) return;
    if (static_cast<size_t>(n) > size_ - pos_) truncated();
    pos_ += static_cast<size_t>(n);
    while (chunk_end_ < pos_) chunk_end_ = std::min(size_, chunk_end_ + kPilBlock);
  }

  // ---- markers (jdmarker.c)
  void first_marker();
  void next_marker();
  int read_markers();  // processes markers until SOS (returns 1) or EOI (returns 2)
  void get_sof();
  void get_sos();
  void get_dht();
  void get_dqt();
  void get_dri();
  void get_dac();
  void get_app();
  void skip_variable();

  // ---- set-up
  void initial_setup();
  void start_scan();

  // ---- entropy decoding (jdhuff.c / jdphuff.c)
  void fill(int nbits);
  inline void check(int nbits) {
    if (bits_left_ < nbits) fill(nbits);
  }
  inline int get_bits(int n) {
    bits_left_ -= n;
    return static_cast<int>((gbuf_ >> bits_left_) & ((uint64_t{1} << n) - 1));
  }
  inline int peek_bits(int n) const {
    return static_cast<int>((gbuf_ >> (bits_left_ - n)) & ((uint64_t{1} << n) - 1));
  }
  int huff_decode(const HuffTable& t);
  static inline int extend(int x, int s) {
    return x < (1 << (s - 1)) ? x + static_cast<int>((~0u << s) + 1) : x;
  }
  void process_restart();
  void read_restart_marker();
  void resync_to_restart(int desired);
  void decode_scan();
  void decode_mcu_sequential(int16_t** blocks, const int* member);
  bool decode_mcu_fast(int16_t** blocks, const int* member);
  void decode_mcu_sequential_retried(int16_t** blocks, const int* member, int blocks_in_mcu);
  void decode_mcu_dc_first(int16_t** blocks, const int* member);
  void decode_mcu_dc_refine(int16_t** blocks);
  void decode_mcu_ac_first(int16_t* block);
  void decode_mcu_ac_refine(int16_t* block);

  // ---- output pass
  void output(uint8_t* out);

  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  size_t chunk_end_ = 0;     // the end of the bytes PIL has handed libjpeg so far
  bool retry_mcu_ = false;
  int unread_marker_ = 0;
  bool saw_soi_ = false, saw_sof_ = false, saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  bool progressive_ = false;
  bool header_done_ = false;   // past the first SOS: PIL's own walk is over
  bool std_tables_installed_ = false;
  int restart_interval_ = 0;
  int next_restart_num_ = 0;

  bool qt_defined_[4] = {};
  int qt_[4][64] = {};
  HuffSpec dc_spec_[4], ac_spec_[4];

  Component comp_[4];
  int max_h_ = 1, max_v_ = 1;

  // current scan
  int comps_in_scan_ = 0;
  int scan_comp_[4] = {};
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  HuffTable dc_tbl_[4], ac_tbl_[4];

  // bit reader and entropy state
  uint64_t gbuf_ = 0;
  int bits_left_ = 0;
  bool insufficient_ = false;
  int restarts_to_go_ = 0;
  int last_dc_[4] = {};
  unsigned eobrun_ = 0;
};

// ---------------------------------------------------------------- markers --

void Decoder::first_marker() {
  int c = byte(), c2 = byte();
  // PIL's open accepts FF D8 FF only
  if (c != 0xFF || c2 != 0xD8 || size_ < 3 || data_[2] != 0xFF) fail("not a JPEG file");
  unread_marker_ = c2;
}

void Decoder::next_marker() {
  for (;;) {
    int c = byte();
    while (c != 0xFF) c = byte();  // garbage before a marker: libjpeg warns
    do {
      c = byte();
    } while (c == 0xFF);
    if (c != 0) {
      unread_marker_ = c;
      return;
    }
  }
}

void Decoder::skip_variable() {
  long length = two_bytes() - 2;
  skip(length);
}

void Decoder::get_app() {
  // PIL's APP handler reads the whole segment (a short one is a truncated
  // file), libjpeg looks at the first bytes of APP0 and APP14
  const int marker = unread_marker_;
  long length = two_bytes() - 2;
  if (length <= 0) return;
  if (static_cast<size_t>(length) > size_ - pos_) truncated();
  const uint8_t* p = data_ + pos_;
  if (marker == 0xE0 && length >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) saw_jfif_ = true;
  if (marker == 0xE0 && !header_done_ && length >= 4 && std::memcmp(p, "JFIF", 4) == 0 &&
      length < 7) {
    fail("JFIF segment too short");  // PIL's APP handler reads its version
  }
  if (marker == 0xEE && length >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
    saw_adobe_ = true;
    adobe_transform_ = p[11];
  }
  skip(length);
}

void Decoder::get_sof() {
  const int marker = unread_marker_;
  if (saw_sof_) fail("duplicate SOF marker");
  long length = two_bytes();
  if (length < 8) fail("bad SOF marker length");
  const int prec = byte();
  const int h = two_bytes();
  const int w = two_bytes();
  const int n = byte();
  // PIL's SOF handler first
  if (prec != 8) {
    if (prec == 12 || prec == 16) {
      throw Failure{kUnsupported, std::to_string(prec) + "-bit JPEG (precision " +
                                      std::to_string(prec) + ", SOF" +
                                      std::to_string(marker - 0xC0) + ")"};
    }
    fail("cannot handle " + std::to_string(prec) + "-bit layers");
  }
  if (n != 1 && n != 3 && n != 4) fail("cannot handle " + std::to_string(n) + "-layer images");
  if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF) {
    throw Failure{kUnsupported, "lossless JPEG (SOF" + std::to_string(marker - 0xC0) + ")"};
  }
  if (marker == 0xC5 || marker == 0xC6 || marker == 0xCD || marker == 0xCE) {
    throw Failure{kUnsupported, "hierarchical JPEG (SOF" + std::to_string(marker - 0xC0) + ")"};
  }
  if (marker == 0xC9 || marker == 0xCA) {
    throw Failure{kUnsupported,
                  "arithmetic-coded JPEG (SOF" + std::to_string(marker - 0xC0) + ")"};
  }
  if (h <= 0 || w <= 0) fail("empty JPEG image");
  if (length - 8 != n * 3) fail("bad SOF marker length");
  width = w;
  height = h;
  ncomp = n;
  sof = marker;
  precision = prec;
  progressive_ = marker == 0xC2;
  for (int ci = 0; ci < n; ++ci) {
    Component& c = comp_[ci];
    c.id = byte();
    const int f = byte();
    c.h = (f >> 4) & 15;
    c.v = f & 15;
    c.tq = byte();
  }
  saw_sof_ = true;
}

void Decoder::get_sos() {
  if (!saw_sof_) fail("SOS before SOF");
  const int length = two_bytes();
  const int n = byte();
  if (length != n * 2 + 6 || n < 1 || n > 4) fail("bad SOS marker length");
  comps_in_scan_ = n;
  bool used[4] = {};
  for (int i = 0; i < n; ++i) {
    const int cc = byte(), c = byte();
    int found = -1;
    for (int ci = 0; ci < ncomp; ++ci) {
      if (comp_[ci].id == cc && !used[ci]) {
        found = ci;
        break;
      }
    }
    if (found < 0) fail("bad component id in SOS");
    used[found] = true;
    scan_comp_[i] = found;
    comp_[found].dc_tbl = (c >> 4) & 15;
    comp_[found].ac_tbl = c & 15;
  }
  ss_ = byte();
  se_ = byte();
  const int a = byte();
  ah_ = (a >> 4) & 15;
  al_ = a & 15;
  next_restart_num_ = 0;
}

void Decoder::get_dht() {
  long length = two_bytes() - 2;
  while (length > 16) {
    int index = byte();
    uint8_t bits[17] = {0};
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      bits[i] = static_cast<uint8_t>(byte());
      count += bits[i];
    }
    length -= 17;
    if (count > 256 || count > length) fail("bad Huffman table");
    uint8_t vals[256] = {0};
    for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(byte());
    length -= count;
    HuffSpec* spec;
    if (index & 0x10) {
      index -= 0x10;
      if (index < 0 || index >= 4) fail("bad DHT index");
      spec = &ac_spec_[index];
    } else {
      if (index >= 4) fail("bad DHT index");
      spec = &dc_spec_[index];
    }
    spec->defined = true;
    std::memcpy(spec->bits, bits, sizeof(bits));
    std::memcpy(spec->vals, vals, sizeof(vals));
  }
  if (length != 0) fail("bad DHT marker length");
}

void Decoder::get_dqt() {
  long length = two_bytes() - 2;
  if (!header_done_) {
    // PIL's DQT handler: each table must be whole within the segment
    if (length > 0 && static_cast<size_t>(length) > size_ - pos_) truncated();
    long rest = length;
    const uint8_t* s = data_ + pos_;
    while (rest > 0) {
      const long qt_length = 1 + ((s[0] >> 4) == 0 ? 1 : 2) * 64;
      if (rest < qt_length) fail("bad quantization table marker");
      s += qt_length;
      rest -= qt_length;
    }
  }
  while (length > 0) {
    --length;
    const int n = byte();
    const int prec = n >> 4, tq = n & 15;
    if (tq >= 4) fail("bad DQT index");
    for (int i = 0; i < 64; ++i) qt_[tq][kNatural[i]] = prec ? two_bytes() : byte();
    length -= 64;
    if (prec) length -= 64;
    qt_defined_[tq] = true;
  }
  if (length != 0) fail("bad DQT marker length");
}

// DAC (arithmetic conditioning) means nothing to a Huffman-coded image, but
// libjpeg checks it pair by pair
void Decoder::get_dac() {
  long length = two_bytes() - 2;
  while (length > 0) {
    const int index = byte(), val = byte();
    length -= 2;
    if (index >= 32) fail("bad DAC index");
    if (index < 16 && (val & 15) > (val >> 4)) fail("bad DAC value");
  }
  if (length != 0) fail("bad DAC marker length");
}

void Decoder::get_dri() {
  if (two_bytes() != 4) fail("bad DRI marker length");
  restart_interval_ = two_bytes();
}

int Decoder::read_markers() {
  for (;;) {
    if (unread_marker_ == 0) {
      if (!saw_soi_) {
        first_marker();
      } else {
        next_marker();
      }
    }
    const int m = unread_marker_;
    // PIL's walk before the first SOS knows FF C0-FE only
    if (!header_done_ && m < 0xC0) fail("no marker found");
    switch (m) {
      case 0xD8:
        if (saw_soi_) fail("duplicate SOI marker");
        saw_soi_ = true;
        break;
      case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        get_sof();
        break;
      case 0xC8:
        fail("JPG marker");
        break;
      case 0xDA:
        get_sos();
        unread_marker_ = 0;
        return 1;
      case 0xD9:
        unread_marker_ = 0;
        return 2;
      case 0xCC:
        get_dac();
        break;
      case 0xC4:
        get_dht();
        break;
      case 0xDB:
        get_dqt();
        break;
      case 0xDD:
        get_dri();
        break;
      case 0xE0: case 0xE1: case 0xE2: case 0xE3: case 0xE4: case 0xE5: case 0xE6: case 0xE7:
      case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC: case 0xED: case 0xEE: case 0xEF:
        get_app();
        break;
      case 0xFE:
        skip_variable();
        break;
      case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
      case 0x01:
        break;
      case 0xDC:
        skip_variable();
        break;
      default:  // DHP, EXP, JPGn, reserved
        fail("unsupported marker type");
    }
    unread_marker_ = 0;
  }
}

// ----------------------------------------------------------------- set-up --

void Decoder::initial_setup() {
  if (static_cast<int64_t>(width) * height > 178956970) {
    fail("image too large (PIL's decompression bomb limit)");
  }
  max_h_ = max_v_ = 1;
  for (int ci = 0; ci < ncomp; ++ci) {
    const Component& c = comp_[ci];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors");
    max_h_ = std::max(max_h_, c.h);
    max_v_ = std::max(max_v_, c.v);
  }
  for (int ci = 0; ci < ncomp; ++ci) {
    Component& c = comp_[ci];
    if (max_h_ % c.h || max_v_ % c.v) fail("fractional sampling not implemented");
    c.width_in_blocks = static_cast<int>(ceil_div(static_cast<int64_t>(width) * c.h, max_h_ * 8));
    c.height_in_blocks =
        static_cast<int>(ceil_div(static_cast<int64_t>(height) * c.v, max_v_ * 8));
    c.dw = static_cast<int>(ceil_div(static_cast<int64_t>(width) * c.h, max_h_));
    c.dh = static_cast<int>(ceil_div(static_cast<int64_t>(height) * c.v, max_v_));
    c.bw = static_cast<int>(ceil_div(c.width_in_blocks, c.h) * c.h);
    c.bh = static_cast<int>(ceil_div(c.height_in_blocks, c.v) * c.v);
    c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
  }
}

void Decoder::read_header() {
  if (read_markers() != 1) fail("no image data (EOI before SOS)");
  header_done_ = true;
  initial_setup();
}

// ------------------------------------------------------- entropy decoding --

constexpr int kMinGetBits = 57;  // MIN_GET_BITS for a 64-bit bit buffer

// jpeg_fill_bit_buffer: load at least 25 bits unless a marker ends the
// segment; past a marker, zeros (libjpeg warns, and then skips the rest of
// the segment's MCUs). Running out of bytes is where libjpeg suspends.
void Decoder::fill(int nbits) {
  if (unread_marker_ == 0) {
    while (bits_left_ < kMinGetBits) {
      int c = byte();
      if (c == 0xFF) {
        do {
          c = byte();
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          unread_marker_ = c;
          goto no_more_bytes;
        }
      }
      gbuf_ = (gbuf_ << 8) | static_cast<uint64_t>(c);
      bits_left_ += 8;
    }
    return;
  }
no_more_bytes:
  if (nbits > bits_left_) {
    insufficient_ = true;
    gbuf_ <<= kMinGetBits - bits_left_;
    bits_left_ = kMinGetBits;
  }
}

int Decoder::huff_decode(const HuffTable& t) {
  int nb;
  if (bits_left_ < kLookahead) {
    fill(0);
    if (bits_left_ < kLookahead) {
      nb = 1;
      goto slow;
    }
  }
  {
    const int entry = t.lookup[peek_bits(kLookahead)];
    nb = entry >> kLookahead;
    if (nb <= kLookahead) {
      bits_left_ -= nb;
      return entry & 0xFF;
    }
  }
slow:
  check(nb);
  {
    int32_t code = get_bits(nb);
    int l = nb;
    while (code > t.maxcode[l]) {
      code <<= 1;
      check(1);
      code |= get_bits(1);
      ++l;
    }
    if (l > 16) return 0;  // bad code: libjpeg warns and fakes a zero
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
}

void Decoder::resync_to_restart(int desired) {
  int marker = unread_marker_;
  for (;;) {
    int action;
    if (marker < 0xC0) {
      action = 2;
    } else if (marker < 0xD0 || marker > 0xD7) {
      action = 3;
    } else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) {
      unread_marker_ = 0;
      return;
    }
    if (action == 3) return;
    next_marker();
    marker = unread_marker_;
  }
}

void Decoder::read_restart_marker() {
  if (unread_marker_ == 0) next_marker();
  if (unread_marker_ == 0xD0 + next_restart_num_) {
    unread_marker_ = 0;
  } else {
    resync_to_restart(next_restart_num_);
  }
  next_restart_num_ = (next_restart_num_ + 1) & 7;
}

void Decoder::process_restart() {
  bits_left_ = 0;
  read_restart_marker();
  for (int i = 0; i < comps_in_scan_; ++i) last_dc_[i] = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
  if (unread_marker_ == 0) insufficient_ = false;
}

void Decoder::decode_mcu_sequential(int16_t** blocks, const int* member) {
  for (int b = 0; blocks[b]; ++b) {
    const Component& c = comp_[scan_comp_[member[b]]];
    int16_t* block = blocks[b];
    int s = huff_decode(dc_tbl_[c.dc_tbl]);
    if (s) {
      check(s);
      const int r = get_bits(s);
      s = extend(r, s);
    }
    const int ci = member[b];
    last_dc_[ci] = static_cast<int>(static_cast<unsigned>(last_dc_[ci]) + static_cast<unsigned>(s));
    block[0] = static_cast<int16_t>(last_dc_[ci]);
    const HuffTable& ac = ac_tbl_[c.ac_tbl];
    for (int k = 1; k < 64; ++k) {
      s = huff_decode(ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        check(s);
        r = get_bits(s);
        block[kNatural[k]] = static_cast<int16_t>(extend(r, s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
}

// decode_mcu_fast: libjpeg-turbo's path for an MCU with plenty of bytes
// left, which loads 48 bits at a time. Its values are the slow path's; the
// bits it holds when the MCU ends are not, and they decide where a stream
// cut short runs dry. False where it met a marker: the slow path then
// decodes the MCU again from its start.
bool Decoder::decode_mcu_fast(int16_t** blocks, const int* member) {
  uint64_t gb = gbuf_;
  int bl = bits_left_;
  size_t p = pos_;
  int dc[4];
  std::memcpy(dc, last_dc_, sizeof(dc));
  bool marker = false;
  auto fill = [&]() {
    if (bl > 16) return;
    for (int i = 0; i < 6; ++i) {
      const int c0 = data_[p++];
      const int c1 = p < size_ ? data_[p] : 0;
      gb = (gb << 8) | static_cast<uint64_t>(c0);
      bl += 8;
      if (c0 == 0xFF) {
        ++p;
        if (c1 != 0) {
          marker = true;
          p -= 2;
          gb &= ~uint64_t{0xFF};
        }
      }
    }
  };
  auto bits = [&](int n) {
    bl -= n;
    return static_cast<int>((gb >> bl) & ((uint64_t{1} << n) - 1));
  };
  auto decode = [&](const HuffTable& t) {
    fill();
    int s = t.lookup[(gb >> (bl - kLookahead)) & ((1 << kLookahead) - 1)];
    int nb = s >> kLookahead;
    bl -= nb;
    s &= (1 << kLookahead) - 1;
    if (nb > kLookahead) {
      s = static_cast<int>((gb >> bl) & ((uint64_t{1} << nb) - 1));
      while (s > t.maxcode[nb]) {
        s = (s << 1) | bits(1);
        ++nb;
      }
      s = nb > 16 ? 0 : t.vals[(s + t.valoffset[nb]) & 0xFF];
    }
    return s;
  };
  for (int b = 0; blocks[b]; ++b) {
    const Component& c = comp_[scan_comp_[member[b]]];
    int16_t* block = blocks[b];
    int s = decode(dc_tbl_[c.dc_tbl]);
    if (s) {
      fill();
      s = extend(bits(s), s);
    }
    const int ci = member[b];
    dc[ci] = static_cast<int>(static_cast<unsigned>(dc[ci]) + static_cast<unsigned>(s));
    block[0] = static_cast<int16_t>(dc[ci]);
    const HuffTable& ac = ac_tbl_[c.ac_tbl];
    for (int k = 1; k < 64; ++k) {
      s = decode(ac);
      const int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        fill();
        block[kNatural[k]] = static_cast<int16_t>(extend(bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
  if (marker) return false;
  gbuf_ = gb;
  bits_left_ = bl;
  pos_ = p;
  std::memcpy(last_dc_, dc, sizeof(dc));
  return true;
}

// jdhuff.c's decode_mcu for one sequential MCU: the fast path where PIL's
// buffer holds enough bytes and no restart interval is set, else (or after
// it met a marker) the slow one; an MCU that runs out of PIL's buffer
// before the end of the file is decoded again from its start.
void Decoder::decode_mcu_sequential_retried(int16_t** blocks, const int* member,
                                            int blocks_in_mcu) {
  const uint64_t gbuf = gbuf_;
  const int bits_left = bits_left_;
  const size_t pos = pos_;
  int dc[4];
  std::memcpy(dc, last_dc_, sizeof(dc));
  for (;;) {
    const bool fast = !restart_interval_ && unread_marker_ == 0 &&
                      chunk_end_ - pos_ >= kFastBytesPerBlock * blocks_in_mcu;
    retry_mcu_ = true;
    try {
      if (!fast || !decode_mcu_fast(blocks, member)) decode_mcu_sequential(blocks, member);
      retry_mcu_ = false;
      return;
    } catch (const NeedMore&) {
      gbuf_ = gbuf;
      bits_left_ = bits_left;
      pos_ = pos;
      std::memcpy(last_dc_, dc, sizeof(dc));
    } catch (...) {
      retry_mcu_ = false;
      throw;
    }
  }
}

void Decoder::decode_mcu_dc_first(int16_t** blocks, const int* member) {
  for (int b = 0; blocks[b]; ++b) {
    const Component& c = comp_[scan_comp_[member[b]]];
    int s = huff_decode(dc_tbl_[c.dc_tbl]);
    if (s) {
      check(s);
      const int r = get_bits(s);
      s = extend(r, s);
    }
    const int ci = member[b];
    last_dc_[ci] = static_cast<int>(static_cast<unsigned>(last_dc_[ci]) + static_cast<unsigned>(s));
    blocks[b][0] = static_cast<int16_t>(static_cast<unsigned>(last_dc_[ci]) << al_);
  }
}

void Decoder::decode_mcu_dc_refine(int16_t** blocks) {
  const int p1 = 1 << al_;
  for (int b = 0; blocks[b]; ++b) {
    check(1);
    if (get_bits(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
  }
}

void Decoder::decode_mcu_ac_first(int16_t* block) {
  if (eobrun_ > 0) {
    --eobrun_;
    return;
  }
  const HuffTable& t = ac_tbl_[comp_[scan_comp_[0]].ac_tbl];
  for (int k = ss_; k <= se_; ++k) {
    int s = huff_decode(t);
    int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      check(s);
      r = get_bits(s);
      s = extend(r, s);
      block[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(s) << al_);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun_ = 1u << r;
      if (r) {
        check(r);
        eobrun_ += static_cast<unsigned>(get_bits(r));
      }
      --eobrun_;
      break;
    }
  }
}

void Decoder::decode_mcu_ac_refine(int16_t* block) {
  const int p1 = 1 << al_;
  const int m1 = static_cast<int>(~0u << al_);
  const HuffTable& t = ac_tbl_[comp_[scan_comp_[0]].ac_tbl];
  int k = ss_;
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      int s = huff_decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        check(1);
        s = get_bits(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1u << r;
        if (r) {
          check(r);
          eobrun_ += static_cast<unsigned>(get_bits(r));
        }
        break;
      }
      do {
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) {
          check(1);
          if (get_bits(1) && (*coef & p1) == 0) {
            *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se_);
      if (s) block[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t* coef = block + kNatural[k];
      if (*coef != 0) {
        check(1);
        if (get_bits(1) && (*coef & p1) == 0) {
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
        }
      }
    }
    --eobrun_;
  }
}

void Decoder::start_scan() {
  // latch each component's quantization table at its first scan (jdinput.c)
  int blocks_in_mcu = 0;
  for (int i = 0; i < comps_in_scan_; ++i) {
    Component& c = comp_[scan_comp_[i]];
    if (!c.latched) {
      if (c.tq >= 4 || !qt_defined_[c.tq]) fail("quantization table not defined");
      std::memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
      c.latched = true;
    }
    blocks_in_mcu += comps_in_scan_ == 1 ? 1 : c.h * c.v;
  }
  if (blocks_in_mcu > 10) fail("sampling factors too large for an interleaved scan");
  if (!std_tables_installed_ && !progressive_) {
    // libjpeg-turbo's sequential decoder gives streams that lack them the
    // standard tables (jstdhuff.c), at the first scan, in the slots still
    // empty; its progressive decoder does not
    const uint8_t* bits[4] = {kStdDcLumBits, kStdAcLumBits, kStdDcChromBits, kStdAcChromBits};
    const uint8_t* vals[4] = {kStdDcVals, kStdAcLumVals, kStdDcVals, kStdAcChromVals};
    const int nvals[4] = {12, 162, 12, 162};
    for (int i = 0; i < 4; ++i) {
      HuffSpec& spec = (i & 1) ? ac_spec_[i >> 1] : dc_spec_[i >> 1];
      if (spec.defined) continue;
      spec.defined = true;
      std::memcpy(spec.bits, bits[i], 17);
      std::memset(spec.vals, 0, sizeof(spec.vals));
      std::memcpy(spec.vals, vals[i], static_cast<size_t>(nvals[i]));
    }
    std_tables_installed_ = true;
  }
  const bool dc_band = ss_ == 0;
  if (progressive_) {
    bool bad = false;
    if (dc_band) {
      if (se_ != 0) bad = true;
    } else {
      if (ss_ > se_ || se_ >= 64) bad = true;
      if (comps_in_scan_ != 1) bad = true;
    }
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) fail("invalid progressive parameters");
  }
  for (int i = 0; i < comps_in_scan_; ++i) {
    const Component& c = comp_[scan_comp_[i]];
    const bool need_dc = !progressive_ || (dc_band && ah_ == 0);
    const bool need_ac = !progressive_ || !dc_band;
    if (need_dc) {
      if (c.dc_tbl >= 4 || !dc_spec_[c.dc_tbl].defined) fail("Huffman table not defined");
      derive(dc_spec_[c.dc_tbl], true, &dc_tbl_[c.dc_tbl]);
    }
    if (need_ac) {
      if (c.ac_tbl >= 4 || !ac_spec_[c.ac_tbl].defined) fail("Huffman table not defined");
      derive(ac_spec_[c.ac_tbl], false, &ac_tbl_[c.ac_tbl]);
    }
  }
  gbuf_ = 0;
  bits_left_ = 0;
  insufficient_ = false;
  for (int& d : last_dc_) d = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
}

void Decoder::decode_scan() {
  start_scan();
  int16_t* blocks[11];
  int member[10];
  enum { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine } mode = kSeq;
  if (progressive_) {
    if (ss_ == 0) {
      mode = ah_ == 0 ? kDcFirst : kDcRefine;
    } else {
      mode = ah_ == 0 ? kAcFirst : kAcRefine;
    }
  }
  int blocks_in_mcu = 0;
  auto decode_one = [&]() {
    if (restart_interval_) {
      if (restarts_to_go_ == 0) process_restart();
    }
    if (!insufficient_) {
      switch (mode) {
        case kSeq: decode_mcu_sequential_retried(blocks, member, blocks_in_mcu); break;
        case kDcFirst: decode_mcu_dc_first(blocks, member); break;
        case kDcRefine: decode_mcu_dc_refine(blocks); break;
        case kAcFirst: decode_mcu_ac_first(blocks[0]); break;
        case kAcRefine: decode_mcu_ac_refine(blocks[0]); break;
      }
    }
    if (restart_interval_) --restarts_to_go_;
  };
  if (comps_in_scan_ == 1) {
    Component& c = comp_[scan_comp_[0]];
    member[0] = 0;
    blocks[1] = nullptr;
    blocks_in_mcu = 1;
    for (int by = 0; by < c.height_in_blocks; ++by) {
      for (int bx = 0; bx < c.width_in_blocks; ++bx) {
        blocks[0] = c.block(by, bx);
        decode_one();
      }
    }
    return;
  }
  const int mcus_x = static_cast<int>(ceil_div(width, max_h_ * 8));
  const int mcus_y = static_cast<int>(ceil_div(height, max_v_ * 8));
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      int n = 0;
      for (int i = 0; i < comps_in_scan_; ++i) {
        Component& c = comp_[scan_comp_[i]];
        for (int y = 0; y < c.v; ++y) {
          for (int x = 0; x < c.h; ++x) {
            member[n] = i;
            blocks[n++] = c.block(my * c.v + y, mx * c.h + x);
          }
        }
      }
      blocks[n] = nullptr;
      blocks_in_mcu = n;
      decode_one();
    }
  }
}

// ------------------------------------------------------------ output pass --

// jidctint.c (jpeg_idct_islow) with its range limit
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int j = 0; j < 1024; ++j) {
      if (j < 128) {
        t[j] = static_cast<uint8_t>(j + 128);
      } else if (j < 512) {
        t[j] = 255;
      } else if (j < 896) {
        t[j] = 0;
      } else {
        t[j] = static_cast<uint8_t>(j - 896);
      }
    }
  }
};
const RangeLimit kRange;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const int* quant, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* ip = in + col;
    const int* qp = quant + col;
    int* wp = ws + col;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dc = static_cast<int>(static_cast<unsigned>(ip[0] * qp[0]) << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16];
    int64_t z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  constexpr int sh = kConstBits + kPass1Bits + 3;
  for (int row = 0; row < 8; ++row) {
    const int* wp = ws + 8 * row;
    uint8_t* op = out + static_cast<size_t>(row) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = kRange.t[descale(wp[0], kPass1Bits + 3) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// jdsample.c: one component's samples [dh][dw] (row stride `stride`) to the
// full image size [height][width]
void upsample(const uint8_t* in, int stride, int dw, int dh, int hexp, int vexp, int width,
              int height, uint8_t* out) {
  auto row = [&](int y) { return in + static_cast<size_t>(std::min(std::max(y, 0), dh - 1)) * stride; };
  if (hexp == 1 && vexp == 1) {
    for (int y = 0; y < height; ++y) std::memcpy(out + static_cast<size_t>(y) * width, row(y), width);
    return;
  }
  if (hexp == 2 && vexp == 1 && dw > 2) {  // h2v1_fancy_upsample
    std::vector<uint8_t> tmp(static_cast<size_t>(dw) * 2);
    for (int y = 0; y < height; ++y) {
      const uint8_t* ip = row(y);
      uint8_t* op = tmp.data();
      int v = ip[0];
      op[0] = static_cast<uint8_t>(v);
      op[1] = static_cast<uint8_t>((v * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        v = ip[x] * 3;
        op[2 * x] = static_cast<uint8_t>((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = static_cast<uint8_t>((v + ip[x + 1] + 2) >> 2);
      }
      v = ip[dw - 1];
      op[2 * dw - 2] = static_cast<uint8_t>((v * 3 + ip[dw - 2] + 1) >> 2);
      op[2 * dw - 1] = static_cast<uint8_t>(v);
      std::memcpy(out + static_cast<size_t>(y) * width, tmp.data(), width);
    }
    return;
  }
  if (hexp == 1 && vexp == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      const int iy = y >> 1;
      const bool below = y & 1;
      const uint8_t* p0 = row(iy);
      const uint8_t* p1 = row(below ? iy + 1 : iy - 1);
      const int bias = below ? 2 : 1;
      uint8_t* op = out + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; ++x) op[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
    }
    return;
  }
  if (hexp == 2 && vexp == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<uint8_t> tmp(static_cast<size_t>(dw) * 2);
    std::vector<int> sum(dw);
    for (int y = 0; y < height; ++y) {
      const int iy = y >> 1;
      const uint8_t* p0 = row(iy);
      const uint8_t* p1 = row((y & 1) ? iy + 1 : iy - 1);
      for (int x = 0; x < dw; ++x) sum[x] = p0[x] * 3 + p1[x];
      uint8_t* op = tmp.data();
      op[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
      op[1] = static_cast<uint8_t>((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        op[2 * x] = static_cast<uint8_t>((sum[x] * 3 + sum[x - 1] + 8) >> 4);
        op[2 * x + 1] = static_cast<uint8_t>((sum[x] * 3 + sum[x + 1] + 7) >> 4);
      }
      op[2 * dw - 2] = static_cast<uint8_t>((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
      op[2 * dw - 1] = static_cast<uint8_t>((sum[dw - 1] * 4 + 7) >> 4);
      std::memcpy(out + static_cast<size_t>(y) * width, tmp.data(), width);
    }
    return;
  }
  // box replication: int_upsample, h2v1_upsample, h2v2_upsample
  for (int y = 0; y < height; ++y) {
    const uint8_t* ip = in + static_cast<size_t>(y / vexp) * stride;
    uint8_t* op = out + static_cast<size_t>(y) * width;
    for (int x = 0; x < width; ++x) op[x] = ip[x / hexp];
  }
}

// jdcolor.c's tables
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = int64_t{1} << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + half);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void Decoder::output(uint8_t* out) {
  const size_t npix = static_cast<size_t>(width) * height;
  std::vector<uint8_t> planes(npix * ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    Component& c = comp_[ci];
    const int stride = c.width_in_blocks * 8;
    std::vector<uint8_t> samples(static_cast<size_t>(stride) * c.height_in_blocks * 8);
    for (int by = 0; by < c.height_in_blocks; ++by) {
      for (int bx = 0; bx < c.width_in_blocks; ++bx) {
        idct_islow(c.block(by, bx), c.quant,
                   samples.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
      }
    }
    upsample(samples.data(), stride, c.dw, c.dh, max_h_ / c.h, max_v_ / c.v, width, height,
             planes.data() + npix * ci);
  }
  const uint8_t* p0 = planes.data();
  if (ncomp == 1) {
    for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = p0[i];
    return;
  }
  const uint8_t* p1 = p0 + npix;
  const uint8_t* p2 = p1 + npix;
  if (ncomp == 3) {
    // libjpeg's guess of the colour space: JFIF, then Adobe, then the ids
    bool rgb = false;
    if (!saw_jfif_ && saw_adobe_) {
      rgb = adobe_transform_ == 0;
    } else if (!saw_jfif_) {
      rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
    }
    for (size_t i = 0; i < npix; ++i) {
      if (rgb) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
        continue;
      }
      const int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
      out[3 * i + 1] = clamp255(y + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
    return;
  }
  // four components: libjpeg's CMYK (YCCK converted), PIL's "CMYK;I"
  // inversion, then its cmyk2rgb
  const uint8_t* p3 = p2 + npix;
  const bool ycck = saw_adobe_ && adobe_transform_ != 0;
  for (size_t i = 0; i < npix; ++i) {
    int cmyk[4];
    if (ycck) {
      const int y = p0[i], cb = p1[i], cr = p2[i];
      cmyk[0] = clamp255(255 - (y + kYcc.cr_r[cr]));
      cmyk[1] = clamp255(255 - (y + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
      cmyk[2] = clamp255(255 - (y + kYcc.cb_b[cb]));
    } else {
      cmyk[0] = p0[i];
      cmyk[1] = p1[i];
      cmyk[2] = p2[i];
    }
    cmyk[3] = p3[i];
    const int nk = cmyk[3];  // 255 - (255 - k)
    for (int j = 0; j < 3; ++j) {
      const int c = 255 - cmyk[j];
      const int tmp = c * nk + 128;
      out[3 * i + j] = clamp255(nk - (((tmp >> 8) + tmp) >> 8));
    }
  }
}

void Decoder::decode(uint8_t* out, size_t out_size) {
  try {
    read_header();
  } catch (const Suspend&) {
    fail("image file is truncated");
  }
  if (out_size != static_cast<size_t>(width) * height * 3) {
    fail("output buffer does not match the image size");
  }
  const bool multi_scan = progressive_ || comps_in_scan_ < ncomp;
  try {
    decode_scan();
    if (multi_scan) {
      // libjpeg absorbs the whole file before its output pass
      while (read_markers() == 1) decode_scan();
    }
  } catch (const Suspend&) {
    fail("image file is truncated");
  }
  if (!multi_scan) {
    // PIL's jpeg_finish_decompress reads on to EOI: a marker there can
    // fail the image, the end of the data cannot
    try {
      if (read_markers() == 1) fail("EOI expected: a second scan in a single-scan image");
    } catch (const Suspend&) {
    }
  }
  output(out);
}

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

}  // namespace

extern "C" {

int jpeg_info(const unsigned char* data, long size, int* info, char* msg, int msg_len) {
  try {
    Decoder d(data, size > 0 ? static_cast<size_t>(size) : 0);
    try {
      d.read_header();
    } catch (const Suspend&) {
      fail("image file is truncated");
    }
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.ncomp;
    info[3] = d.sof;
    info[4] = d.precision;
    return kOk;
  } catch (const Failure& f) {
    set_msg(msg, msg_len, f.msg);
    return f.status;
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
    return kCorrupt;
  }
}

int jpeg_decode_rgb(const unsigned char* data, long size, unsigned char* out, long out_size,
                    char* msg, int msg_len) {
  try {
    Decoder d(data, size > 0 ? static_cast<size_t>(size) : 0);
    d.decode(out, out_size > 0 ? static_cast<size_t>(out_size) : 0);
    return kOk;
  } catch (const Failure& f) {
    set_msg(msg, msg_len, f.msg);
    return f.status;
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory");
    return kCorrupt;
  }
}

}  // extern "C"
