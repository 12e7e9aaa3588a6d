// VP8 (lossy WebP) decoder of the port's native data library: the RGB that
// libwebp 1.6 writes for a key frame under PIL's WebPAnimDecoder (MODE_RGBA,
// default options), without libwebp.
//
// Followed, as libwebp's decoder does it:
//   * the boolean decoder (dec/bit_reader: 8-bit range kept as range - 1,
//     one byte loaded when the window runs out, end of data marked once);
//   * the frame, segment and filter headers, the token partitions, the
//     quantizer tables (dec/quant_dec.c: y2 AC * 155 / 100 at least 8,
//     uv DC index at most 117) and the coefficient probabilities with their
//     updates (dec/tree_dec.c);
//   * the intra modes (4x4 with the above / left context, 16x16, chroma),
//     the residual tokens with the non-zero contexts, the inverse WHT and DCT
//     (dsp/dec.c; the block's transform picked by its last non-zero
//     coefficient, the full one in 16-bit lanes as the SSE2 build runs it),
//     the predictors with libwebp's edge samples (127 above, 129 left) and
//     its top-right replication;
//   * the simple and the normal loop filters with sharpness, segment and
//     mode deltas, in macroblock order over the unfiltered reconstruction;
//   * fancy upsampling of 4:2:0 chroma (dsp/upsampling.c) and the 14-bit
//     fixed-point YUV -> RGB of dsp/yuv.h.
// The tables are RFC 6386's (coefficient probabilities and their update
// probabilities, the 4x4 mode probabilities in libwebp's mode order, the
// quantizer steps).
//
// The decision follows libwebp: a header or partition that does not fit its
// data, or any read past the end of the first partition or of a token
// partition, fails the image (the reader's end-of-data flag, checked where
// libwebp checks it); corrupt data that stays inside its partitions decodes.
//
// C ABI (built into the library of tarloader.cpp by data/native.py):
//   int webp_vp8_decode(const unsigned char* data, long size, int width,
//                       int height, unsigned char* out, char* msg,
//                       int msg_len);   // out: uint8 [height, width, 3]
// data: the payload of a "VP8 " chunk. Returns 0 (ok) or 1 (corrupt: libwebp
// fails too), writes a message on failure, never aborts, holds no global
// state.

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

// ---------------------------------------------------------------------------
// tables (RFC 6386)

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,
};

// [type 4][band 8][context 3][proba 11]
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// [top mode][left mode][9], modes in libwebp's order (DC TM VE HE RD VR LD VL HD HU)
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED, B_DC_PRED_NOTOP, B_DC_PRED_NOLEFT,
       B_DC_PRED_NOTOPLEFT };

// ---------------------------------------------------------------------------
// the boolean decoder

struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;  // range - 1
  int bits = -8;         // bits of value beyond the 8 in the window
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {  // libwebp's VP8GetSigned: get_bit(0x80) with shift 1
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - val) >> 31;
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  int get_value(int n) {
    int v = 0;
    while (n-- > 0) v |= get_bit(0x80) << n;
    return v;
  }
  int get() { return get_value(1); }
  int get_signed_value(int n) {
    const int v = get_value(n);
    return get() ? -v : v;
  }
};

// ---------------------------------------------------------------------------
// dsp

inline int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

constexpr int BPS = 32;  // the work buffer's stride, as libwebp's

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The full inverse DCT as libwebp's SSE2 build runs it (Transform_SSE2): the
// same arithmetic as its C version, but every sum kept in 16 bits (wrapping)
// and each multiply a high half of 16 x 16 bits. Inside libwebp's value range
// the two agree; on corrupt coefficients only this one gives PIL's pixels.
inline int16_t w16(int v) { return static_cast<int16_t>(v); }

void transform_one(const int16_t* in, uint8_t* dst) {
  int16_t T[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass over the columns
    const int i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int a = i0 + i2;
    const int b = i0 - i2;
    const int c = mul2(i1) - mul1(i3);
    const int d = mul1(i1) + mul2(i3);
    T[4 * i + 0] = w16(a + d);
    T[4 * i + 1] = w16(b + c);
    T[4 * i + 2] = w16(b - c);
    T[4 * i + 3] = w16(a - d);
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass, row i
    const int t0 = T[i], t1 = T[4 + i], t2 = T[8 + i], t3 = T[12 + i];
    const int dc = t0 + 4;
    const int a = dc + t2;
    const int b = dc - t2;
    const int c = mul2(t1) - mul1(t3);
    const int d = mul1(t1) + mul2(t3);
    dst[0] = static_cast<uint8_t>(clip8(dst[0] + (w16(a + d) >> 3)));
    dst[1] = static_cast<uint8_t>(clip8(dst[1] + (w16(b + c) >> 3)));
    dst[2] = static_cast<uint8_t>(clip8(dst[2] + (w16(b - c) >> 3)));
    dst[3] = static_cast<uint8_t>(clip8(dst[3] + (w16(a - d) >> 3)));
    dst += BPS;
  }
}

// libwebp's TransformAC3_C (only in[0], in[1] and in[4] non-zero) and
// TransformDC_C, in 32-bit arithmetic
void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y, dst += BPS) {
    const int DC = rows[y];
    dst[0] = static_cast<uint8_t>(clip8(dst[0] + ((DC + d1) >> 3)));
    dst[1] = static_cast<uint8_t>(clip8(dst[1] + ((DC + c1) >> 3)));
    dst[2] = static_cast<uint8_t>(clip8(dst[2] + ((DC - c1) >> 3)));
    dst[3] = static_cast<uint8_t>(clip8(dst[3] + ((DC - d1) >> 3)));
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int DC = in[0] + 4;
  for (int y = 0; y < 4; ++y, dst += BPS)
    for (int x = 0; x < 4; ++x) dst[x] = static_cast<uint8_t>(clip8(dst[x] + (DC >> 3)));
}

// libwebp's DoTransform: the block's 2-bit code picks the transform
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_one(src, dst); break;
    case 2: transform_ac3(src, dst); break;
    case 1: transform_dc(src, dst); break;
    default: break;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = static_cast<uint8_t>(clip8(top[x] + left - tl));
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, static_cast<size_t>(size));
}

void pred_luma16(uint8_t* dst, int mode) {
  switch (mode) {
    case B_DC_PRED: {
      int dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> 5, 16);
      break;
    }
    case B_TM_PRED: true_motion(dst, 16); break;
    case B_VE_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case B_HE_PRED:
      for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case B_DC_PRED_NOTOP: {
      int dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[j - BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    default: fill(dst, 0x80, 16); break;
  }
}

void pred_chroma8(uint8_t* dst, int mode) {
  switch (mode) {
    case B_DC_PRED: {
      int dc = 8;
      for (int j = 0; j < 8; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill(dst, dc >> 4, 8);
      break;
    }
    case B_TM_PRED: true_motion(dst, 8); break;
    case B_VE_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case B_HE_PRED:
      for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case B_DC_PRED_NOTOP: {
      int dc = 4;
      for (int j = 0; j < 8; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 3, 8);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = 4;
      for (int j = 0; j < 8; ++j) dc += dst[j - BPS];
      fill(dst, dc >> 3, 8);
      break;
    }
    default: fill(dst, 0x80, 8); break;
  }
}

void pred_luma4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, static_cast<int>(dc >> 3), 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      std::memset(dst + 0 * BPS, avg3(A, B, C), 4);
      std::memset(dst + 1 * BPS, avg3(B, C, D), 4);
      std::memset(dst + 2 * BPS, avg3(C, D, E), 4);
      std::memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    default: {  // B_HU_PRED
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
    }
  }
}
#undef DST

// the loop filters (dsp/dec.c), on a plane of stride `stride`
inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = static_cast<uint8_t>(clip8(p0 + a2));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = static_cast<uint8_t>(clip8(p1 + a3));
  p[-step] = static_cast<uint8_t>(clip8(p0 + a2));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
  p[step] = static_cast<uint8_t>(clip8(q1 - a3));
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = static_cast<uint8_t>(clip8(p2 + a3));
  p[-2 * step] = static_cast<uint8_t>(clip8(p1 + a2));
  p[-step] = static_cast<uint8_t>(clip8(p0 + a1));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
  p[step] = static_cast<uint8_t>(clip8(q1 - a2));
  p[2 * step] = static_cast<uint8_t>(clip8(q2 - a3));
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (std::abs(p1 - p0) > thresh) || (std::abs(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int step, int across, int thresh) {  // 16 samples
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * across, step, thresh2)) do_filter2(p + i * across, step);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else do_filter6(p, hstride);
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else do_filter4(p, hstride);
    }
    p += vstride;
  }
}

// ---------------------------------------------------------------------------
// the decoder

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4;
  uint8_t imodes[16];
  uint8_t uvmode;
  uint8_t segment;
  uint8_t skip;
  uint32_t non_zero_y;
  uint32_t non_zero_uv;
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;

  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segments_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;

  QuantMatrix dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];

  // planes of the whole frame, macroblock-aligned
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> Y, U, V;
  std::vector<FInfo> finfo;  // [mb_h * mb_w]

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  void get_headers();
  void parse_segment_header();
  void parse_filter_header();
  void parse_partitions(const uint8_t* buf, size_t n);
  void parse_quant();
  void parse_proba();
  void precompute_filter_strengths();
  void parse_intra_modes(MBData& block, uint8_t* top, uint8_t* left);
  int get_coeffs(BoolReader& tbr, int type, int ctx, const int* dq, int n, int16_t* out);
  int get_large_value(BoolReader& tbr, const uint8_t* p);
  bool parse_residuals(MBData& block, uint8_t& top_nz, uint8_t& top_nz_dc, uint8_t& left_nz,
                       uint8_t& left_nz_dc, BoolReader& tbr);
  void decode(int want_w, int want_h, uint8_t* out);
  void filter_mb(int mb_x, int mb_y);
  void output(uint8_t* out) const;
};

void Decoder::get_headers() {
  const uint8_t* buf = data;
  size_t n = size;
  if (n < 4) fail("Truncated header.");
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) fail("Incorrect keyframe parameters.");
  if (!show) fail("Frame not displayable.");
  buf += 3;
  n -= 3;
  if (!key_frame) fail("Not a key frame.");
  if (n < 7) fail("cannot parse picture header");
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) fail("Bad code word");
  width = ((buf[4] << 8) | buf[3]) & 0x3fff;
  height = ((buf[6] << 8) | buf[5]) & 0x3fff;
  buf += 7;
  n -= 7;
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  if (partition_length > n) fail("bad partition length");
  br.init(buf, partition_length);
  buf += partition_length;
  n -= partition_length;
  br.get();  // colour space
  br.get();  // clamping type
  parse_segment_header();
  if (br.eof) fail("cannot parse segment header");
  parse_filter_header();
  if (br.eof) fail("cannot parse filter header");
  parse_partitions(buf, n);
  parse_quant();
  br.get();  // update_proba, ignored
  parse_proba();
}

void Decoder::parse_segment_header() {
  use_segment = br.get();
  if (use_segment) {
    update_map = br.get();
    if (br.get()) {
      absolute_delta = br.get();
      for (int s = 0; s < 4; ++s) quantizer[s] = br.get() ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.get() ? br.get_signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s)
        segments_proba[s] = static_cast<uint8_t>(br.get() ? br.get_value(8) : 255);
  } else {
    update_map = 0;
  }
}

void Decoder::parse_filter_header() {
  simple = br.get();
  level = br.get_value(6);
  sharpness = br.get_value(3);
  use_lf_delta = br.get();
  if (use_lf_delta) {
    if (br.get()) {
      for (int i = 0; i < 4; ++i)
        if (br.get()) ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get()) mode_lf_delta[i] = br.get_signed_value(6);
    }
  }
  filter_type = (level == 0) ? 0 : simple ? 1 : 2;
}

void Decoder::parse_partitions(const uint8_t* buf, size_t n) {
  const uint8_t* sz = buf;
  const uint8_t* buf_end = buf + n;
  size_t size_left = n;
  num_parts_minus_one = (1 << br.get_value(2)) - 1;
  const size_t last_part = static_cast<size_t>(num_parts_minus_one);
  if (n < 3 * last_part) fail("cannot parse partitions");
  const uint8_t* part_start = buf + last_part * 3;
  size_left -= last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts[last_part].init(part_start, size_left);
  if (!(part_start < buf_end)) fail("cannot parse partitions");
}

void Decoder::parse_quant() {
  const int base_q0 = br.get_value(7);
  const int dqy1_dc = br.get() ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get() ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get() ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get() ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get() ? br.get_signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix& m = dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q + 0, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Decoder::parse_proba() {
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          proba[t][b][c][p] = static_cast<uint8_t>(
              br.get_bit(kCoeffsUpdateProba[i]) ? br.get_value(8) : kCoeffsProba0[i]);
        }
  use_skip_proba = br.get();
  if (use_skip_proba) skip_p = br.get_value(8);
}

void Decoder::precompute_filter_strengths() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths[s][i4x4];
      int lvl = base_level;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];
        if (i4x4) lvl += mode_lf_delta[0];
      }
      lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
      if (lvl > 0) {
        int ilevel = lvl;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * lvl + ilevel;
        info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

void Decoder::parse_intra_modes(MBData& block, uint8_t* top, uint8_t* left) {
  if (update_map) {
    block.segment = static_cast<uint8_t>(!br.get_bit(segments_proba[0])
                                             ? br.get_bit(segments_proba[1])
                                             : br.get_bit(segments_proba[2]) + 2);
  } else {
    block.segment = 0;
  }
  block.skip = static_cast<uint8_t>(use_skip_proba ? br.get_bit(skip_p) : 0);
  block.is_i4x4 = static_cast<uint8_t>(!br.get_bit(145));
  if (!block.is_i4x4) {
    const int ymode = br.get_bit(156) ? (br.get_bit(128) ? B_TM_PRED : B_HE_PRED)
                                      : (br.get_bit(163) ? B_VE_PRED : B_DC_PRED);
    block.imodes[0] = static_cast<uint8_t>(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        ymode = !br.get_bit(prob[0]) ? B_DC_PRED
              : !br.get_bit(prob[1]) ? B_TM_PRED
              : !br.get_bit(prob[2]) ? B_VE_PRED
              : !br.get_bit(prob[3])
                  ? (!br.get_bit(prob[4]) ? B_HE_PRED
                                          : (!br.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                  : (!br.get_bit(prob[6]) ? B_LD_PRED
                     : (!br.get_bit(prob[7]) ? B_VL_PRED
                        : (!br.get_bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
        top[x] = static_cast<uint8_t>(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  block.uvmode = static_cast<uint8_t>(!br.get_bit(142) ? B_DC_PRED
                                      : !br.get_bit(114) ? B_VE_PRED
                                      : br.get_bit(183) ? B_TM_PRED : B_HE_PRED);
}

int Decoder::get_large_value(BoolReader& tbr, const uint8_t* p) {
  int v;
  if (!tbr.get_bit(p[3])) {
    if (!tbr.get_bit(p[4])) v = 2;
    else v = 3 + tbr.get_bit(p[5]);
  } else {
    if (!tbr.get_bit(p[6])) {
      if (!tbr.get_bit(p[7])) {
        v = 5 + tbr.get_bit(159);
      } else {
        v = 7 + 2 * tbr.get_bit(165);
        v += tbr.get_bit(145);
      }
    } else {
      const int bit1 = tbr.get_bit(p[8]);
      const int bit0 = tbr.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tbr.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// returns the position after the last non-zero coefficient (libwebp's GetCoeffs)
int Decoder::get_coeffs(BoolReader& tbr, int type, int ctx, const int* dq, int n,
                        int16_t* out) {
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!tbr.get_bit(p[0])) return n;
    while (!tbr.get_bit(p[1])) {
      p = proba[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!tbr.get_bit(p[2])) {
      v = 1;
      p = proba[type][kBands[n + 1]][1];
    } else {
      v = get_large_value(tbr, p);
      p = proba[type][kBands[n + 1]][2];
    }
    out[kZigzag[n]] = static_cast<int16_t>(tbr.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// libwebp's ParseResiduals: the contexts are the bits of nz (4 luma, 2 + 2
// chroma above / left) and nz_dc; returns true when every coefficient is zero
bool Decoder::parse_residuals(MBData& block, uint8_t& mb_nz, uint8_t& mb_nz_dc,
                              uint8_t& left_nz, uint8_t& left_nz_dc, BoolReader& tbr) {
  const QuantMatrix& q = dqm[block.segment];
  int16_t* dst = block.coeffs;
  std::memset(dst, 0, sizeof(block.coeffs));
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first, ac_type;
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb_nz_dc + left_nz_dc;
    const int nz = get_coeffs(tbr, 1, ctx, q.y2, 0, dc);
    mb_nz_dc = left_nz_dc = static_cast<uint8_t>(nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t tnz = mb_nz & 0x0f;
  uint32_t lnz = left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(tbr, ac_type, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (tnz >> 1) | (static_cast<uint32_t>(l) << 7);
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (static_cast<uint32_t>(l) << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = static_cast<uint32_t>(mb_nz) >> (4 + ch);
    lnz = static_cast<uint32_t>(left_nz) >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tbr, 2, ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (tnz >> 1) | (static_cast<uint32_t>(l) << 3);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (static_cast<uint32_t>(l) << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  mb_nz = static_cast<uint8_t>(out_t_nz);
  left_nz = static_cast<uint8_t>(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
    return mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED;
  }
  return mode;
}

const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

void Decoder::decode(int want_w, int want_h, uint8_t* out) {
  get_headers();
  if (width != want_w || height != want_h) fail("VP8 frame size differs from its header");
  precompute_filter_strengths();
  ystride = mb_w * 16;
  uvstride = mb_w * 8;
  Y.assign(static_cast<size_t>(ystride) * mb_h * 16, 0);
  U.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
  V.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
  finfo.assign(static_cast<size_t>(mb_w) * mb_h, FInfo());

  std::vector<uint8_t> intra_t(static_cast<size_t>(4) * mb_w, B_DC_PRED);
  std::vector<uint8_t> top_nz(mb_w, 0), top_nz_dc(mb_w, 0);
  // the unfiltered bottom row of the macroblock row above (libwebp's yuv_t_)
  std::vector<uint8_t> top_y(static_cast<size_t>(16) * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
  std::vector<MBData> mbs(mb_w);
  // the work buffer: one row of border above, one column left (libwebp's yuv_b_)
  uint8_t yuv_b[BPS * 17 + BPS * 9 * 2] = {0};
  uint8_t* const y_dst = yuv_b + BPS + 8;
  uint8_t* const u_dst = yuv_b + BPS * 17 + BPS + 8;
  uint8_t* const v_dst = u_dst + 16;

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& tbr = parts[mb_y & num_parts_minus_one];
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_modes(mbs[mb_x], &intra_t[4 * mb_x], intra_l);
    if (br.eof) fail("Premature end-of-partition0 encountered.");
    uint8_t left_nz = 0, left_nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData& block = mbs[mb_x];
      bool skip = use_skip_proba ? block.skip : false;
      if (!skip) {
        skip = parse_residuals(block, top_nz[mb_x], top_nz_dc[mb_x], left_nz, left_nz_dc, tbr);
      } else {
        left_nz = top_nz[mb_x] = 0;
        if (!block.is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
      }
      if (filter_type > 0) {
        FInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
        f = fstrengths[block.segment][block.is_i4x4];
        f.inner |= !skip;
      }
      if (tbr.eof) fail("Premature end-of-file encountered.");
    }

    // reconstruct the row (libwebp's ReconstructRow)
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& block = mbs[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      const int16_t* coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
        std::memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
        std::memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
      }
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) std::memset(top_right, top_y[16 * mb_x + 15], 4);
          else std::memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
        }
        for (int r = 1; r < 4; ++r) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + kScan[n];
          pred_luma4(dst, block.imodes[n]);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        pred_luma16(y_dst, check_mode(mb_x, mb_y, block.imodes[0]));
        if (bits != 0)
          for (int n = 0; n < 16; ++n, bits <<= 2)
            do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
      }
      const uint32_t bits_uv = block.non_zero_uv;
      const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
      pred_chroma8(u_dst, uv_mode);
      pred_chroma8(v_dst, uv_mode);
      for (int c = 0; c < 2; ++c) {
        const uint32_t b = bits_uv >> (8 * c);
        uint8_t* dst = c ? v_dst : u_dst;
        // libwebp's DoUVTransform: the full transform on all four blocks if
        // any has an AC coefficient, else the DC one
        if (b & 0xff)
          for (int n = 0; n < 4; ++n) {
            const int16_t* src = coeffs + (16 + 4 * c + n) * 16;
            uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
            if (b & 0xaa) transform_one(src, d);
            else transform_dc(src, d);
          }
      }
      if (mb_y < mb_h - 1) {
        std::memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
        std::memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
        std::memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&Y[static_cast<size_t>(mb_y * 16 + j) * ystride + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&U[static_cast<size_t>(mb_y * 8 + j) * uvstride + mb_x * 8], u_dst + j * BPS, 8);
        std::memcpy(&V[static_cast<size_t>(mb_y * 8 + j) * uvstride + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }
  if (filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y);
  output(out);
}

void Decoder::filter_mb(int mb_x, int mb_y) {
  const FInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
  const int limit = f.limit;
  if (limit == 0) return;
  const int ilevel = f.ilevel;
  uint8_t* y_dst = &Y[static_cast<size_t>(mb_y) * 16 * ystride + mb_x * 16];
  const int ys = ystride;
  if (filter_type == 1) {
    if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
    return;
  }
  const int uvs = uvstride;
  uint8_t* u_dst = &U[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8];
  uint8_t* v_dst = &V[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8];
  const int hev_t = f.hev_thresh;
  if (mb_x > 0) {
    filter_loop26(y_dst, 1, ys, 16, limit + 4, ilevel, hev_t);
    filter_loop26(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
    filter_loop26(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_t);
    filter_loop24(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
    filter_loop24(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
  }
  if (mb_y > 0) {
    filter_loop26(y_dst, ys, 1, 16, limit + 4, ilevel, hev_t);
    filter_loop26(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
    filter_loop26(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t);
    filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
    filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
  }
}

// dsp/yuv.h
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return static_cast<uint8_t>(((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// dsp/upsampling.c's fancy upsampler: output row y takes chroma row y >> 1 as
// its near row and the neighbour row on the side of y as its far row (the
// same row at the first row, and at the last one of an even height); each
// pair of columns likewise, with the 9-3-3-1 weights in two rounding steps
void Decoder::output(uint8_t* out) const {
  const int w = width, h = height;
  const int uv_h = (h + 1) >> 1;
  for (int y = 0; y < h; ++y) {
    const int near = y >> 1;
    const int far = y == 0 ? 0 : (y & 1) ? (near + 1 < uv_h ? near + 1 : near) : near - 1;
    const uint8_t* yrow = &Y[static_cast<size_t>(y) * ystride];
    uint8_t* dst = out + static_cast<size_t>(y) * w * 3;
    const uint8_t* nu = &U[static_cast<size_t>(near) * uvstride];
    const uint8_t* fu = &U[static_cast<size_t>(far) * uvstride];
    const uint8_t* nv = &V[static_cast<size_t>(near) * uvstride];
    const uint8_t* fv = &V[static_cast<size_t>(far) * uvstride];
    // first pixel: vertical only
    yuv_to_rgb(yrow[0], (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2, dst);
    const int last_pair = (w - 1) >> 1;
    for (int x = 1; x <= last_pair; ++x) {
      // tl = near[x-1], t = near[x], l = far[x-1], uv = far[x]
      int uvs[2][2];
      for (int c = 0; c < 2; ++c) {
        const uint8_t* n = c ? nv : nu;
        const uint8_t* f = c ? fv : fu;
        const int tl = n[x - 1], t = n[x], l = f[x - 1], uv = f[x];
        const int avg = tl + t + l + uv + 8;
        const int diag_12 = (avg + 2 * (t + l)) >> 3;
        const int diag_03 = (avg + 2 * (tl + uv)) >> 3;
        uvs[c][0] = (diag_12 + tl) >> 1;
        uvs[c][1] = (diag_03 + t) >> 1;
      }
      yuv_to_rgb(yrow[2 * x - 1], uvs[0][0], uvs[1][0], dst + (2 * x - 1) * 3);
      yuv_to_rgb(yrow[2 * x], uvs[0][1], uvs[1][1], dst + (2 * x) * 3);
    }
    if (!(w & 1)) {
      const int x = (w - 1) >> 1;
      yuv_to_rgb(yrow[w - 1], (3 * nu[x] + fu[x] + 2) >> 2, (3 * nv[x] + fv[x] + 2) >> 2,
                 dst + (w - 1) * 3);
    }
  }
}

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

}  // namespace

extern "C" {

int webp_vp8_decode(const unsigned char* data, long size, int width, int height,
                    unsigned char* out, char* msg, int msg_len) {
  try {
    Decoder d(data, size > 0 ? static_cast<size_t>(size) : 0);
    d.decode(width, height, out);
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
