/* The WebP bitstream decoders of the port (io/webp.py): the lossless VP8L
 * decoder (the four transforms, the meta prefix-code image, the five prefix
 * codes of a group, the colour cache and LZ77 copies), which also decodes
 * the alpha planes of ALPH chunks, and the lossy VP8 key-frame decoder (the
 * boolean decoder, frame header, segments, token partitions, intra
 * prediction, residual tokens, the inverse WHT and DCT, the simple and
 * normal loop filters) with the fancy 4:2:0 upsampling and 14-bit
 * fixed-point YUV -> RGB of libwebp's C path.  Plain C with a C interface,
 * built with gcc into vpt_tpu_torch/build/ at first use and called through
 * ctypes (io/codec.py); the RIFF container, the mode and the animation
 * canvas stay in Python (io/webp.py).
 *
 * Written from RFC 9649 (WebP lossless and the container) and RFC 6386
 * (VP8).  Where a decoder has to choose beyond the specifications (how far
 * a bit reader may run past its data, which streams it refuses, the
 * upsampler's edges, the prediction borders, what a corrupt stream's
 * out-of-range values become), the code follows libwebp's decoder on a
 * 64-bit x86 machine, the one behind PIL, so the pixels and the refusals
 * are PIL's: the bit readers keep libwebp's windows and end-of-stream rules
 * exactly, and the inverse DCT wraps in 16 bits as its SSE2 version does.
 * The constant tables (the default coefficient probabilities and their
 * update probabilities, the 4x4 intra-mode contexts, the quantiser tables,
 * the zigzag and band orders, the intra-mode tree and the LZ77 distance map)
 * are those of RFC 6386 and RFC 9649 in libwebp's layout (libwebp is BSD
 * licensed), its mode numbering included: DC, TM, VE, HE, RD, VR, LD, VL,
 * HD, HU.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------ tables */

/* Default coefficient probabilities, [block type][band][context][node] (RFC 6386 13.5). */
static const uint8_t kCoeffsProba0[4][8][3][11] = {
  {  /* block type 0 */
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
     {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
     {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
     {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
     {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
     {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
     {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
     {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
     {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
     {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
     {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
     {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
     {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}
  },
  {  /* block type 1 */
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
     {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
     {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
     {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
     {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
     {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
     {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
     {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
     {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
     {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
     {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
     {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
     {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
     {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
     {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
     {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}
  },
  {  /* block type 2 */
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
     {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
     {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
     {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
     {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
     {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
     {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
     {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
     {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
     {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
     {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
     {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}
  },
  {  /* block type 3 */
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
     {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
     {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
     {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
     {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
     {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
     {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
     {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
     {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
     {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
     {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
     {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
     {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
     {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
     {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}
  }
};

/* The probabilities that a coefficient probability is updated (RFC 6386 13.4). */
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {  /* block type 0 */
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
     {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}
  },
  {  /* block type 1 */
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
     {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}
  },
  {  /* block type 2 */
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
     {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}
  },
  {  /* block type 3 */
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}
  }
};

/* 4x4 intra-mode probabilities, [above mode][left mode][node] (RFC 6386 11.5). */
static const uint8_t kBModesProba[10][10][9] = {
  {{231, 120, 48, 89, 115, 113, 120, 152, 112}, {152, 179, 64, 126, 170, 118, 46, 70, 95}, {175, 69, 143, 80, 85, 82, 72, 155, 103},
   {56, 58, 10, 171, 218, 189, 17, 13, 152}, {114, 26, 17, 163, 44, 195, 21, 10, 173}, {121, 24, 80, 195, 26, 62, 44, 64, 85},
   {144, 71, 10, 38, 171, 213, 144, 34, 26}, {170, 46, 55, 19, 136, 160, 33, 206, 71}, {63, 20, 8, 114, 114, 208, 12, 9, 226},
   {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {{134, 183, 89, 137, 98, 101, 106, 165, 148}, {72, 187, 100, 130, 157, 111, 32, 75, 80}, {66, 102, 167, 99, 74, 62, 40, 234, 128},
   {41, 53, 9, 178, 241, 141, 26, 8, 107}, {74, 43, 26, 146, 73, 166, 49, 23, 157}, {65, 38, 105, 160, 51, 52, 31, 115, 128},
   {104, 79, 12, 27, 217, 255, 87, 17, 7}, {87, 68, 71, 44, 114, 51, 15, 186, 23}, {47, 41, 14, 110, 182, 183, 21, 17, 194},
   {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {{88, 88, 147, 150, 42, 46, 45, 196, 205}, {43, 97, 183, 117, 85, 38, 35, 179, 61}, {39, 53, 200, 87, 26, 21, 43, 232, 171},
   {56, 34, 51, 104, 114, 102, 29, 93, 77}, {39, 28, 85, 171, 58, 165, 90, 98, 64}, {34, 22, 116, 206, 23, 34, 43, 166, 73},
   {107, 54, 32, 26, 51, 1, 81, 43, 31}, {68, 25, 106, 22, 64, 171, 36, 225, 114}, {34, 19, 21, 102, 132, 188, 16, 76, 124},
   {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {{193, 101, 35, 159, 215, 111, 89, 46, 111}, {60, 148, 31, 172, 219, 228, 21, 18, 111}, {112, 113, 77, 85, 179, 255, 38, 120, 114},
   {40, 42, 1, 196, 245, 209, 10, 25, 109}, {88, 43, 29, 140, 166, 213, 37, 43, 154}, {61, 63, 30, 155, 67, 45, 68, 1, 209},
   {100, 80, 8, 43, 154, 1, 51, 26, 71}, {142, 78, 78, 16, 255, 128, 34, 197, 171}, {41, 40, 5, 102, 211, 183, 4, 1, 221},
   {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {{138, 31, 36, 171, 27, 166, 38, 44, 229}, {67, 87, 58, 169, 82, 115, 26, 59, 179}, {63, 59, 90, 180, 59, 166, 93, 73, 154},
   {40, 40, 21, 116, 143, 209, 34, 39, 175}, {47, 15, 16, 183, 34, 223, 49, 45, 183}, {46, 17, 33, 183, 6, 98, 15, 32, 183},
   {57, 46, 22, 24, 128, 1, 54, 17, 37}, {65, 32, 73, 115, 28, 128, 23, 128, 205}, {40, 3, 9, 115, 51, 192, 18, 6, 223},
   {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {{104, 55, 44, 218, 9, 54, 53, 130, 226}, {64, 90, 70, 205, 40, 41, 23, 26, 57}, {54, 57, 112, 184, 5, 41, 38, 166, 213},
   {30, 34, 26, 133, 152, 116, 10, 32, 134}, {39, 19, 53, 221, 26, 114, 32, 73, 255}, {31, 9, 65, 234, 2, 15, 1, 118, 73},
   {75, 32, 12, 51, 192, 255, 160, 43, 51}, {88, 31, 35, 67, 102, 85, 55, 186, 85}, {56, 21, 23, 111, 59, 205, 45, 37, 192},
   {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {{125, 98, 42, 88, 104, 85, 117, 175, 82}, {95, 84, 53, 89, 128, 100, 113, 101, 45}, {75, 79, 123, 47, 51, 128, 81, 171, 1},
   {57, 17, 5, 71, 102, 57, 53, 41, 49}, {38, 33, 13, 121, 57, 73, 26, 1, 85}, {41, 10, 67, 138, 77, 110, 90, 47, 114},
   {115, 21, 2, 10, 102, 255, 166, 23, 6}, {101, 29, 16, 10, 85, 128, 101, 196, 26}, {57, 18, 10, 102, 102, 213, 34, 20, 43},
   {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {{102, 61, 71, 37, 34, 53, 31, 243, 192}, {69, 60, 71, 38, 73, 119, 28, 222, 37}, {68, 45, 128, 34, 1, 47, 11, 245, 171},
   {62, 17, 19, 70, 146, 85, 55, 62, 70}, {37, 43, 37, 154, 100, 163, 85, 160, 1}, {63, 9, 92, 136, 28, 64, 32, 201, 85},
   {75, 15, 9, 9, 64, 255, 184, 119, 16}, {86, 6, 28, 5, 64, 255, 25, 248, 1}, {56, 8, 17, 132, 137, 255, 55, 116, 128},
   {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {{164, 50, 31, 137, 154, 133, 25, 35, 218}, {51, 103, 44, 131, 131, 123, 31, 6, 158}, {86, 40, 64, 135, 148, 224, 45, 183, 128},
   {22, 26, 17, 131, 240, 154, 14, 1, 209}, {45, 16, 21, 91, 64, 222, 7, 1, 197}, {56, 21, 39, 155, 60, 138, 23, 102, 213},
   {83, 12, 13, 54, 192, 255, 68, 47, 28}, {85, 26, 85, 85, 128, 128, 32, 146, 171}, {18, 11, 7, 63, 144, 171, 4, 4, 246},
   {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {{190, 80, 35, 99, 180, 80, 126, 54, 45}, {85, 126, 47, 87, 176, 51, 41, 20, 32}, {101, 75, 128, 139, 118, 146, 116, 128, 85},
   {56, 41, 15, 176, 236, 85, 37, 9, 62}, {71, 30, 17, 119, 118, 255, 17, 18, 138}, {101, 38, 60, 138, 55, 70, 43, 26, 142},
   {146, 36, 19, 30, 171, 255, 97, 27, 20}, {138, 45, 61, 62, 219, 1, 81, 188, 64}, {32, 41, 20, 117, 151, 142, 20, 21, 163},
   {112, 19, 12, 61, 195, 128, 48, 4, 24}}
};

/* The 4x4 intra-mode tree: a leaf is a mode's negation (RFC 6386 11.2). */
static const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};

/* Quantiser step of each index, DC and AC (RFC 6386 14.1). */
static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

static const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};  /* the extra entry: past the last coefficient */

/* VP8L distance codes 1..120 as (row offset << 4) | (8 - column offset) (RFC 9649 4.2.2). */
static const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55,
    57, 21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59,
    70, 74, 36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86,
    90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119,
    121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110,
    48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

/* -------------------------------------------------------------- VP8L */

enum { LBITS = 64, WBITS = 32, MAX_READ = 24, ROOT_BITS = 8, LENGTHS_ROOT_BITS = 7, MAX_CODE_LENGTH = 15,
       NUM_LITERAL = 256, NUM_LENGTH = 24, NUM_DISTANCE = 40, CODE_LENGTH_CODES = 19, MAX_CACHE_BITS = 11,
       /* a two-level table: 256 root entries and at most 2^15 below them */
       MAX_TABLE = (1 << ROOT_BITS) + (1 << MAX_CODE_LENGTH) };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };

/* Error codes of vpt_vp8l_decode and vpt_webp_alpha; io/codec.py names them. */
enum { E_OK = 0, E_HEADER = -1, E_BITSTREAM = -2, E_MEMORY = -3, E_ALPHA_HEADER = -4, E_ALPHA_SHORT = -5 };

static const uint8_t kCodeLengthCodeOrder[CODE_LENGTH_CODES] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11,
                                                                12, 13, 14, 15};
static const int kAlphabetSize[5] = {NUM_LITERAL + NUM_LENGTH, NUM_LITERAL, NUM_LITERAL, NUM_LITERAL, NUM_DISTANCE};

/* The bit reader: a 64-bit window over the data, least significant bit
 * first.  It runs past the end as libwebp's does: the window stops moving,
 * the stream ends once more than its bits (and no fewer than 64) are read,
 * and a read at a position of 64 or more wraps within the window. */
typedef struct {
    uint64_t val;
    const uint8_t *buf;
    size_t len, pos;
    int bit_pos, eos;
} LReader;

static void lr_init(LReader *br, const uint8_t *start, size_t length) {
    size_t n = length < 8 ? length : 8;
    br->val = 0;
    for (size_t i = 0; i < n; i++) br->val |= (uint64_t)start[i] << (8 * i);
    br->buf = start;
    br->len = length;
    br->pos = n;
    br->bit_pos = 0;
    br->eos = 0;
}

static inline int lr_at_end(const LReader *br) { return br->eos || (br->pos == br->len && br->bit_pos > LBITS); }

static void lr_shift(LReader *br) {
    while (br->bit_pos >= 8 && br->pos < br->len) {
        br->val = (br->val >> 8) | ((uint64_t)br->buf[br->pos++] << (LBITS - 8));
        br->bit_pos -= 8;
    }
    if (lr_at_end(br)) {
        br->eos = 1;
        br->bit_pos = 0;
    }
}

static inline uint32_t lr_peek(const LReader *br) { return (uint32_t)(br->val >> (br->bit_pos & (LBITS - 1))); }

static inline void lr_fill(LReader *br) {
    if (br->bit_pos >= WBITS) lr_shift(br);
}

static uint32_t lr_read(LReader *br, int n) {
    if (!br->eos && n <= MAX_READ) {
        const uint32_t v = lr_peek(br) & ((1u << n) - 1);
        br->bit_pos += n;
        lr_shift(br);
        return v;
    }
    br->eos = 1;
    br->bit_pos = 0;
    return 0;
}

/* A prefix-code table entry: the code's length (for a root entry that
 * points below, root bits + the bits of its second-level table) and the
 * symbol (or the offset of the second-level table from the entry). */
typedef struct {
    uint8_t bits;
    uint16_t value;
} HCode;

static inline int read_symbol(const HCode *table, LReader *br) {
    uint32_t val = lr_peek(br);
    table += val & ((1u << ROOT_BITS) - 1);
    const int nbits = table->bits - ROOT_BITS;
    if (nbits > 0) {
        br->bit_pos += ROOT_BITS;
        val = lr_peek(br);
        table += table->value;
        table += val & ((1u << nbits) - 1);
    }
    br->bit_pos += table->bits;
    return table->value;
}

static uint32_t reverse_bits(uint32_t code, int len) {
    uint32_t r = 0;
    for (int i = 0; i < len; i++) r |= ((code >> i) & 1u) << (len - 1 - i);
    return r;
}

/* The canonical prefix code of code lengths `lengths` (n symbols) as a
 * two-level table with root_bits at the root, into `table` (MAX_TABLE
 * entries) when it is not NULL.  Returns the entries used, or 0 for lengths
 * that are no complete prefix code (a code of one symbol reads no bits and
 * is complete). */
static int build_table(HCode *table, int root_bits, const int *lengths, int n) {
    int count[MAX_CODE_LENGTH + 1] = {0}, first[MAX_CODE_LENGTH + 1];
    for (int s = 0; s < n; s++) {
        if (lengths[s] < 0 || lengths[s] > MAX_CODE_LENGTH) return 0;
        count[lengths[s]]++;
    }
    if (count[0] == n) return 0;
    int coded = n - count[0], open = 1;
    for (int len = 1; len <= MAX_CODE_LENGTH; len++) {
        open = 2 * open - count[len];
        if (open < 0) return 0;
    }
    const int root = 1 << root_bits;
    if (coded == 1) {
        if (table) {
            for (int s = 0; s < n; s++)
                if (lengths[s]) {
                    for (int i = 0; i < root; i++) table[i] = (HCode){0, (uint16_t)s};
                }
        }
        return root;
    }
    if (open != 0) return 0;
    /* canonical codes: the first code of each length */
    uint32_t code = 0;
    first[0] = 0;
    for (int len = 1; len <= MAX_CODE_LENGTH; len++) {
        code = (code + (len > 1 ? (uint32_t)count[len - 1] : 0)) << 1;
        first[len] = (int)code;
    }
    /* the depth of the subtree under each root prefix, for the second-level tables */
    int depth[1 << ROOT_BITS];
    memset(depth, 0, sizeof(depth));
    {
        int next[MAX_CODE_LENGTH + 1];
        for (int len = 1; len <= MAX_CODE_LENGTH; len++) next[len] = first[len];
        for (int s = 0; s < n; s++) {
            const int len = lengths[s];
            if (len > root_bits) {
                const uint32_t r = reverse_bits((uint32_t)next[len], len);
                const int low = (int)(r & (uint32_t)(root - 1));
                if (len - root_bits > depth[low]) depth[low] = len - root_bits;
            }
            if (len) next[len]++;
        }
    }
    int size = root, offset[1 << ROOT_BITS];
    for (int low = 0; low < root; low++) {
        offset[low] = size;
        if (depth[low]) size += 1 << depth[low];
    }
    if (!table) return size;
    int next[MAX_CODE_LENGTH + 1];
    for (int len = 1; len <= MAX_CODE_LENGTH; len++) next[len] = first[len];
    for (int low = 0; low < root; low++)
        if (depth[low]) table[low] = (HCode){(uint8_t)(root_bits + depth[low]), (uint16_t)(offset[low] - low)};
    for (int s = 0; s < n; s++) {
        const int len = lengths[s];
        if (!len) continue;
        const uint32_t r = reverse_bits((uint32_t)next[len]++, len);
        if (len <= root_bits) {
            for (uint32_t i = r; i < (uint32_t)root; i += 1u << len) table[i] = (HCode){(uint8_t)len, (uint16_t)s};
        } else {
            const int low = (int)(r & (uint32_t)(root - 1)), sub = len - root_bits;
            HCode *t = table + offset[low];
            for (uint32_t i = r >> root_bits; i < (1u << depth[low]); i += 1u << sub) t[i] = (HCode){(uint8_t)sub, (uint16_t)s};
        }
    }
    return size;
}

/* The five prefix codes of a group, as offsets into the decoder's pool. */
typedef struct {
    size_t code[5];
} Group;

typedef struct {
    LReader br;
    HCode *pool;
    size_t pool_len, pool_cap;
    int lengths[NUM_LITERAL + NUM_LENGTH + (1 << MAX_CACHE_BITS)];
    HCode scratch[MAX_TABLE];
} LDecoder;

static int pool_add(LDecoder *d, const HCode *t, int size, size_t *at) {
    if (d->pool_len + (size_t)size > d->pool_cap) {
        size_t cap = d->pool_cap ? d->pool_cap : 4096;
        while (cap < d->pool_len + (size_t)size) cap *= 2;
        HCode *p = realloc(d->pool, cap * sizeof(HCode));
        if (!p) return 0;
        d->pool = p;
        d->pool_cap = cap;
    }
    memcpy(d->pool + d->pool_len, t, (size_t)size * sizeof(HCode));
    *at = d->pool_len;
    d->pool_len += (size_t)size;
    return 1;
}

/* The code lengths of a normal prefix code, read with the code-length code. */
static int read_code_lengths(LDecoder *d, const int *cl_lengths, int num_symbols, int *lengths) {
    LReader *br = &d->br;
    HCode table[1 << LENGTHS_ROOT_BITS];
    if (!build_table(table, LENGTHS_ROOT_BITS, cl_lengths, CODE_LENGTH_CODES)) return 0;
    int max_symbol, prev = 8;
    if (lr_read(br, 1)) {
        const int nbits = 2 + 2 * (int)lr_read(br, 3);
        max_symbol = 2 + (int)lr_read(br, nbits);
        if (max_symbol > num_symbols) return 0;
    } else {
        max_symbol = num_symbols;
    }
    int symbol = 0;
    while (symbol < num_symbols) {
        if (max_symbol-- == 0) break;
        lr_fill(br);
        const HCode *p = &table[lr_peek(br) & ((1u << LENGTHS_ROOT_BITS) - 1)];
        br->bit_pos += p->bits;
        const int len = p->value;
        if (len < 16) {
            lengths[symbol++] = len;
            if (len) prev = len;
        } else {
            static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
            int repeat = (int)lr_read(br, extra[len - 16]) + offset[len - 16];
            if (symbol + repeat > num_symbols) return 0;
            const int v = len == 16 ? prev : 0;
            while (repeat-- > 0) lengths[symbol++] = v;
        }
    }
    return 1;
}

/* One prefix code of `alphabet` symbols, built into the scratch table.
 * Returns the table's size, 0 for a stream libwebp refuses. */
static int read_code(LDecoder *d, int alphabet) {
    LReader *br = &d->br;
    int *lengths = d->lengths;
    int ok;
    memset(lengths, 0, (size_t)alphabet * sizeof(int));
    if (lr_read(br, 1)) { /* simple code: one or two symbols */
        const int num = (int)lr_read(br, 1) + 1, first_bits = (int)lr_read(br, 1);
        lengths[lr_read(br, first_bits ? 8 : 1)] = 1;
        if (num == 2) lengths[lr_read(br, 8)] = 1;
        ok = 1;
    } else {
        int cl_lengths[CODE_LENGTH_CODES] = {0};
        const int num = (int)lr_read(br, 4) + 4;
        for (int i = 0; i < num; i++) cl_lengths[kCodeLengthCodeOrder[i]] = (int)lr_read(br, 3);
        ok = read_code_lengths(d, cl_lengths, alphabet, lengths);
    }
    ok = ok && !br->eos;
    return ok ? build_table(d->scratch, ROOT_BITS, lengths, alphabet) : 0;
}

/* An image's prefix codes: the meta image (level 0 only) and the groups. */
typedef struct {
    int cache_bits, meta_bits, meta_width, num_groups;
    uint32_t *meta; /* group of each tile */
    Group *groups;
    uint32_t *cache;
} Codes;

static void free_codes(Codes *c) {
    free(c->meta);
    free(c->groups);
    free(c->cache);
    memset(c, 0, sizeof(*c));
}

static inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

static int decode_image_stream(LDecoder *d, int xsize, int ysize, int is_level0, uint32_t **out, Codes *codes_out,
                               int *xsize_out, void *transforms);
static int decode_image_data(LDecoder *d, const Codes *c, uint32_t *data, int width, int height);

static int read_codes(LDecoder *d, int xsize, int ysize, int cache_bits, int allow_meta, Codes *c) {
    LReader *br = &d->br;
    int num_groups = 1, num_groups_max = 1;
    int *mapping = NULL;
    uint32_t *meta = NULL;
    c->cache_bits = cache_bits;
    if (allow_meta && lr_read(br, 1)) {
        const int bits = 2 + (int)lr_read(br, 3);
        const int mw = subsample(xsize, bits), mh = subsample(ysize, bits);
        if (!decode_image_stream(d, mw, mh, 0, &meta, NULL, NULL, NULL)) return 0;
        c->meta_bits = bits;
        c->meta_width = mw;
        for (int64_t i = 0; i < (int64_t)mw * mh; i++) {
            const int g = (int)((meta[i] >> 8) & 0xffff);
            meta[i] = (uint32_t)g;
            if (g >= num_groups_max) num_groups_max = g + 1;
        }
        if (num_groups_max > 1000 || num_groups_max > xsize * ysize) {
            /* map the groups the meta image uses to 0..num_groups-1 */
            mapping = malloc((size_t)num_groups_max * sizeof(int));
            if (!mapping) {
                free(meta);
                return 0;
            }
            memset(mapping, 0xff, (size_t)num_groups_max * sizeof(int));
            num_groups = 0;
            for (int64_t i = 0; i < (int64_t)mw * mh; i++) {
                int *m = &mapping[meta[i]];
                if (*m == -1) *m = num_groups++;
                meta[i] = (uint32_t)*m;
            }
        } else {
            num_groups = num_groups_max;
        }
    }
    c->meta = meta;
    if (br->eos) goto fail;
    c->groups = calloc((size_t)num_groups, sizeof(Group));
    if (!c->groups) goto fail;
    c->num_groups = num_groups;
    for (int i = 0; i < num_groups_max; i++) {
        const int unused = mapping && mapping[i] == -1;
        Group *g = unused ? NULL : &c->groups[mapping ? mapping[i] : i];
        for (int j = 0; j < 5; j++) {
            const int alphabet = kAlphabetSize[j] + (j == 0 && cache_bits > 0 ? 1 << cache_bits : 0);
            const int size = read_code(d, alphabet);
            if (!size) goto fail;
            if (g && !pool_add(d, d->scratch, size, &g->code[j])) goto fail;
        }
    }
    free(mapping);
    if (cache_bits > 0) {
        c->cache = calloc((size_t)1 << cache_bits, sizeof(uint32_t));
        if (!c->cache) return 0;
    }
    return 1;
fail:
    free(mapping);
    return 0;
}

typedef struct {
    int type, bits, xsize, ysize;
    uint32_t *data;
} Transform;

typedef struct {
    Transform t[4];
    int n;
    unsigned seen;
} Transforms;

static void free_transforms(Transforms *ts) {
    for (int i = 0; i < ts->n; i++) free(ts->t[i].data);
    ts->n = 0;
}

static int read_transform(LDecoder *d, int *xsize, int ysize, Transforms *ts) {
    LReader *br = &d->br;
    const int type = (int)lr_read(br, 2);
    if (ts->seen & (1u << type)) return 0;
    ts->seen |= 1u << type;
    Transform *t = &ts->t[ts->n++];
    t->type = type;
    t->xsize = *xsize;
    t->ysize = ysize;
    t->data = NULL;
    t->bits = 0;
    if (type == PREDICTOR || type == CROSS_COLOR) {
        t->bits = (int)lr_read(br, 3) + 2;
        return decode_image_stream(d, subsample(t->xsize, t->bits), subsample(t->ysize, t->bits), 0, &t->data, NULL,
                                   NULL, NULL);
    }
    if (type == COLOR_INDEXING) {
        const int num = (int)lr_read(br, 8) + 1;
        const int bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
        *xsize = subsample(t->xsize, bits);
        t->bits = bits;
        uint32_t *colors = NULL;
        if (!decode_image_stream(d, num, 1, 0, &colors, NULL, NULL, NULL)) return 0;
        /* the palette is coded as differences; entries past it are transparent black */
        const int final = 1 << (8 >> bits);
        t->data = calloc((size_t)final, sizeof(uint32_t));
        if (!t->data) {
            free(colors);
            return 0;
        }
        uint8_t *src = (uint8_t *)colors, *dst = (uint8_t *)t->data;
        memcpy(dst, src, 4);
        for (int i = 4; i < 4 * num; i++) dst[i] = (uint8_t)(src[i] + dst[i - 4]);
        free(colors);
    }
    return 1;
}

/* An image stream: at level 0 the transforms, the colour cache and the
 * codes (meta image allowed), leaving the entropy-coded data to the caller
 * (its codes in codes_out, its width in xsize_out, the transforms in
 * `transforms`); below level 0 (a transform's data, the meta image) the
 * colour cache, one group of codes and the decoded pixels in *out. */
static int decode_image_stream(LDecoder *d, int xsize, int ysize, int is_level0, uint32_t **out, Codes *codes_out,
                               int *xsize_out, void *transforms) {
    LReader *br = &d->br;
    int ok = 1, cache_bits = 0, tx = xsize;
    if (is_level0) {
        Transforms *ts = transforms;
        while (ok && lr_read(br, 1)) ok = read_transform(d, &tx, ysize, ts);
    }
    if (ok && lr_read(br, 1)) {
        cache_bits = (int)lr_read(br, 4);
        ok = cache_bits >= 1 && cache_bits <= MAX_CACHE_BITS;
    }
    if (!ok) return 0;
    Codes c;
    memset(&c, 0, sizeof(c));
    if (!read_codes(d, tx, ysize, cache_bits, is_level0, &c)) {
        free_codes(&c);
        return 0;
    }
    if (is_level0) {
        *codes_out = c;
        *xsize_out = tx;
        return 1;
    }
    uint32_t *data = malloc((size_t)tx * (size_t)ysize * sizeof(uint32_t));
    if (!data) {
        free_codes(&c);
        return 0;
    }
    ok = decode_image_data(d, &c, data, tx, ysize) && !br->eos;
    free_codes(&c);
    if (!ok) {
        free(data);
        return 0;
    }
    *out = data;
    return 1;
}

static inline const Group *group_at(const Codes *c, int x, int y) {
    if (!c->meta) return &c->groups[0];
    return &c->groups[c->meta[(size_t)c->meta_width * (size_t)(y >> c->meta_bits) + (size_t)(x >> c->meta_bits)]];
}

static inline int copy_length(int sym, LReader *br) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1, offset = (2 + (sym & 1)) << extra;
    return offset + (int)lr_read(br, extra) + 1;
}

static inline int plane_to_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int dc = kCodeToPlane[code - 1], dist = (dc >> 4) * xsize + (8 - (dc & 0xf));
    return dist >= 1 ? dist : 1;
}

static inline uint32_t cache_key(uint32_t argb, int bits) { return (argb * 0x1e35a7bdu) >> (32 - bits); }

/* The entropy-coded ARGB pixels (libwebp's DecodeImageData, whole image,
 * not incremental): any read past the end of the stream refuses it. */
static int decode_image_data(LDecoder *d, const Codes *c, uint32_t *data, int width, int height) {
    LReader *br = &d->br;
    const int64_t total = (int64_t)width * height;
    int64_t pos = 0, cached = 0;
    int col = 0, row = 0;
    const int cache_bits = c->cache_bits;
    const uint32_t mask = c->meta ? (1u << c->meta_bits) - 1 : ~0u;
    const Group *g = total ? group_at(c, 0, 0) : NULL;
    const HCode *pool = d->pool;
    while (pos < total) {
        if ((col & mask) == 0) g = group_at(c, col, row);
        lr_fill(br);
        const int code = read_symbol(pool + g->code[GREEN], br);
        if (lr_at_end(br)) break;
        if (code < NUM_LITERAL) {
            const int red = read_symbol(pool + g->code[RED], br);
            lr_fill(br);
            const int blue = read_symbol(pool + g->code[BLUE], br);
            const int alpha = read_symbol(pool + g->code[ALPHA], br);
            if (lr_at_end(br)) break;
            data[pos] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) | (uint32_t)blue;
        advance:
            pos++;
            if (++col >= width) {
                col = 0;
                row++;
                if (cache_bits)
                    for (; cached < pos; cached++) c->cache[cache_key(data[cached], cache_bits)] = data[cached];
            }
        } else if (code < NUM_LITERAL + NUM_LENGTH) {
            const int length = copy_length(code - NUM_LITERAL, br);
            const int dist_sym = read_symbol(pool + g->code[DIST], br);
            lr_fill(br);
            const int dist = plane_to_distance(width, copy_length(dist_sym, br));
            if (lr_at_end(br)) break;
            if (pos < dist || total - pos < length) return 0;
            for (int i = 0; i < length; i++) data[pos + i] = data[pos + i - dist];
            pos += length;
            col += length;
            while (col >= width) {
                col -= width;
                row++;
            }
            if (col & mask) g = group_at(c, col, row);
            if (cache_bits)
                for (; cached < pos; cached++) c->cache[cache_key(data[cached], cache_bits)] = data[cached];
        } else {
            if (code - (NUM_LITERAL + NUM_LENGTH) >= (1 << cache_bits)) return 0;
            for (; cached < pos; cached++) c->cache[cache_key(data[cached], cache_bits)] = data[cached];
            data[pos] = c->cache[code - (NUM_LITERAL + NUM_LENGTH)];
            goto advance;
        }
    }
    return !lr_at_end(br);
}

/* ----------------------------------------------------- inverse transforms */

static inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u), rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

static inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

static inline int sub3(int a, int b, int c) {
    const int pb = b - c, pa = a - c;
    return abs(pb) - abs(pa);
}

static inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
    const int d = sub3((int)(a >> 24), (int)(b >> 24), (int)(c >> 24)) +
                  sub3((int)((a >> 16) & 0xff), (int)((b >> 16) & 0xff), (int)((c >> 16) & 0xff)) +
                  sub3((int)((a >> 8) & 0xff), (int)((b >> 8) & 0xff), (int)((c >> 8) & 0xff)) +
                  sub3((int)(a & 0xff), (int)(b & 0xff), (int)(c & 0xff));
    return d <= 0 ? a : b;
}

static inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

static inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int v = (int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) - (int)((c2 >> s) & 0xff);
        out |= clip255((uint32_t)v) << s;
    }
    return out;
}

static inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = average2(c0, c1);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int a = (int)((ave >> s) & 0xff), b = (int)((c2 >> s) & 0xff);
        out |= clip255((uint32_t)(a + (a - b) / 2)) << s;
    }
    return out;
}

/* Predictor `mode` for the pixel whose left neighbour is *left and whose
 * upper neighbours are top[-1], top[0], top[1]. */
static inline uint32_t predict(int mode, const uint32_t *left, const uint32_t *top) {
    switch (mode) {
    case 1: return *left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(*left, top[1]), top[0]);
    case 6: return average2(*left, top[-1]);
    case 7: return average2(*left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(*left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], *left, top[-1]);
    case 12: return add_sub_full(*left, top[0], top[-1]);
    case 13: return add_sub_half(*left, top[0], top[-1]);
    default: return 0xff000000u; /* 0, 14 and 15: opaque black */
    }
}

/* In place: each output pixel depends on outputs to its left and above
 * (the last pixel of a row takes the first of its own row as upper right). */
static void inverse_predictor(const Transform *t, uint32_t *px) {
    const int w = t->xsize, tiles = subsample(w, t->bits);
    px[0] = add_pixels(px[0], 0xff000000u);
    for (int x = 1; x < w; x++) px[x] = add_pixels(px[x], px[x - 1]);
    for (int y = 1; y < t->ysize; y++) {
        uint32_t *row = px + (size_t)y * w;
        const uint32_t *modes = t->data + (size_t)(y >> t->bits) * tiles;
        row[0] = add_pixels(row[0], row[-w]);
        for (int x = 1; x < w; x++)
            row[x] = add_pixels(row[x], predict((int)((modes[x >> t->bits] >> 8) & 0xf), &row[x - 1], &row[x - w]));
    }
}

static inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

static void inverse_cross_color(const Transform *t, uint32_t *px) {
    const int w = t->xsize, tiles = subsample(w, t->bits);
    for (int y = 0; y < t->ysize; y++) {
        uint32_t *row = px + (size_t)y * w;
        const uint32_t *codes = t->data + (size_t)(y >> t->bits) * tiles;
        for (int x = 0; x < w; x++) {
            const uint32_t m = codes[x >> t->bits], argb = row[x];
            const int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff), r2b = (int8_t)((m >> 16) & 0xff);
            const int8_t green = (int8_t)(argb >> 8);
            int red = (int)((argb >> 16) & 0xff), blue = (int)(argb & 0xff);
            red = (red + color_delta(g2r, green)) & 0xff;
            blue += color_delta(g2b, green);
            blue = (blue + color_delta(r2b, (int8_t)red)) & 0xff;
            row[x] = (argb & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
        }
    }
}

static void inverse_subtract_green(uint32_t *px, size_t n) {
    for (size_t i = 0; i < n; i++) {
        const uint32_t g = (px[i] >> 8) & 0xff, rb = ((px[i] & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        px[i] = (px[i] & 0xff00ff00u) | rb;
    }
}

/* Palette indices (packed 8 >> bits to a byte for up to 16 colours) in the
 * green of `in` (width subsample(xsize, bits)) to the colours in `out`. */
static void inverse_color_indexing(const Transform *t, const uint32_t *in, uint32_t *out) {
    const int bits_per_pixel = 8 >> t->bits, count_mask = (1 << t->bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    for (int y = 0; y < t->ysize; y++) {
        uint32_t packed = 0;
        for (int x = 0; x < t->xsize; x++) {
            if ((x & count_mask) == 0) packed = (*in++ >> 8) & 0xff;
            *out++ = t->data[packed & bit_mask];
            packed >>= bits_per_pixel;
        }
    }
}

/* The transforms in reverse order of reading, from the decoded pixels (at
 * the width the last transform left) to the image's; frees the pixels. */
static uint32_t *apply_transforms(Transforms *ts, uint32_t *px) {
    for (int i = ts->n - 1; i >= 0; i--) {
        const Transform *t = &ts->t[i];
        switch (t->type) {
        case PREDICTOR: inverse_predictor(t, px); break;
        case CROSS_COLOR: inverse_cross_color(t, px); break;
        case SUBTRACT_GREEN: inverse_subtract_green(px, (size_t)t->xsize * t->ysize); break;
        default: {
            uint32_t *out = malloc((size_t)t->xsize * t->ysize * sizeof(uint32_t));
            if (!out) {
                free(px);
                return NULL;
            }
            inverse_color_indexing(t, px, out);
            free(px);
            px = out;
        }
        }
    }
    return px;
}

/* A VP8L chunk's payload (its padding byte included, as libwebp reads it)
 * as (height, width) RGBA rows `stride` bytes apart; width and height
 * must be the header's. */
int vpt_vp8l_decode(const uint8_t *data, int64_t size, int width, int height, uint8_t *out, int64_t stride) {
    LDecoder *d = calloc(1, sizeof(LDecoder));
    if (!d) return E_MEMORY;
    Transforms ts;
    memset(&ts, 0, sizeof(ts));
    Codes c;
    memset(&c, 0, sizeof(c));
    uint32_t *px = NULL;
    int rc = E_BITSTREAM, tx = 0;
    lr_init(&d->br, data, (size_t)size);
    if (lr_read(&d->br, 8) != 0x2f || (int)lr_read(&d->br, 14) + 1 != width || (int)lr_read(&d->br, 14) + 1 != height) {
        rc = E_HEADER;
        goto done;
    }
    lr_read(&d->br, 1); /* alpha_is_used: the container's mode reads it */
    if (lr_read(&d->br, 3) != 0 || d->br.eos) {
        rc = E_HEADER;
        goto done;
    }
    if (!decode_image_stream(d, width, height, 1, NULL, &c, &tx, &ts)) goto done;
    px = malloc((size_t)tx * (size_t)height * sizeof(uint32_t));
    if (!px) {
        rc = E_MEMORY;
        goto done;
    }
    if (!decode_image_data(d, &c, px, tx, height)) goto done;
    px = apply_transforms(&ts, px);
    if (!px) {
        rc = E_MEMORY;
        goto done;
    }
    for (int y = 0; y < height; y++) {
        uint8_t *o = out + (size_t)y * (size_t)stride;
        const uint32_t *p = px + (size_t)y * width;
        for (int x = 0; x < width; x++) {
            o[4 * x] = (uint8_t)(p[x] >> 16);
            o[4 * x + 1] = (uint8_t)(p[x] >> 8);
            o[4 * x + 2] = (uint8_t)p[x];
            o[4 * x + 3] = (uint8_t)(p[x] >> 24);
        }
    }
    rc = E_OK;
done:
    free(px);
    free_codes(&c);
    free_transforms(&ts);
    free(d->pool);
    free(d);
    return rc;
}

/* -------------------------------------------------------------- ALPH */

/* libwebp's 8-bit path for an alpha stream whose only transform is a
 * palette and whose codes need only green: the entropy-coded indices as
 * bytes.  Unlike the ARGB path it takes a stream whose last symbol runs
 * past its end. */
static int decode_alpha_indices(LDecoder *d, const Codes *c, uint8_t *data, int width, int height) {
    LReader *br = &d->br;
    const int64_t end = (int64_t)width * height;
    int64_t pos = 0;
    int col = 0, row = 0, ok = 1;
    const uint32_t mask = c->meta ? (1u << c->meta_bits) - 1 : ~0u;
    const Group *g = end ? group_at(c, 0, 0) : NULL;
    const HCode *pool = d->pool;
    while (!br->eos && pos < end) {
        if ((col & mask) == 0) g = group_at(c, col, row);
        lr_fill(br);
        const int code = read_symbol(pool + g->code[GREEN], br);
        if (code < NUM_LITERAL) {
            data[pos++] = (uint8_t)code;
            if (++col >= width) {
                col = 0;
                row++;
            }
        } else if (code < NUM_LITERAL + NUM_LENGTH) {
            const int length = copy_length(code - NUM_LITERAL, br);
            const int dist_sym = read_symbol(pool + g->code[DIST], br);
            lr_fill(br);
            const int dist = plane_to_distance(width, copy_length(dist_sym, br));
            if (pos < dist || end - pos < length) {
                ok = 0;
                break;
            }
            for (int i = 0; i < length; i++) data[pos + i] = data[pos + i - dist];
            pos += length;
            col += length;
            while (col >= width) {
                col -= width;
                row++;
            }
            if (pos < end && (col & mask)) g = group_at(c, col, row);
        } else {
            ok = 0;
            break;
        }
        br->eos = lr_at_end(br);
    }
    br->eos = lr_at_end(br);
    return ok && !(br->eos && pos < end);
}

/* The alpha filters' inverses on one row (prev: the row above, NULL for the first). */
static void unfilter_row(int filter, const uint8_t *prev, uint8_t *row, int width) {
    if (filter == 0) return;
    if (filter == 1 || prev == NULL) { /* horizontal, and the first row of every filter */
        uint8_t pred = prev ? prev[0] : 0;
        for (int i = 0; i < width; i++) pred = row[i] = (uint8_t)(pred + row[i]);
    } else if (filter == 2) { /* vertical */
        for (int i = 0; i < width; i++) row[i] = (uint8_t)(prev[i] + row[i]);
    } else { /* gradient: left + top - top-left, clipped */
        uint8_t top = prev[0], top_left = top, left = top;
        for (int i = 0; i < width; i++) {
            top = prev[i];
            const int g = left + top - top_left;
            left = (uint8_t)(row[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
            top_left = top;
            row[i] = left;
        }
    }
}

/* An ALPH chunk's payload (unpadded) as the (height, width) alpha plane of
 * a lossy image: its header byte (compression 0 raw or 1 lossless, filter
 * 0-3, pre-processing 0 or 1 and ignored, reserved bits 0), the plane and
 * the filter undone. */
int vpt_webp_alpha(const uint8_t *data, int64_t size, int width, int height, uint8_t *out) {
    if (size <= 1) return E_ALPHA_HEADER;
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
    if (method > 1 || pre > 1 || rsrv != 0) return E_ALPHA_HEADER;
    const size_t n = (size_t)width * (size_t)height;
    int rc = E_OK;
    if (method == 0) {
        if ((size_t)(size - 1) < n) return E_ALPHA_SHORT;
        memcpy(out, data + 1, n);
    } else {
        LDecoder *d = calloc(1, sizeof(LDecoder));
        if (!d) return E_MEMORY;
        Transforms ts;
        memset(&ts, 0, sizeof(ts));
        Codes c;
        memset(&c, 0, sizeof(c));
        uint32_t *px = NULL;
        uint8_t *idx = NULL;
        int tx = 0;
        rc = E_BITSTREAM;
        lr_init(&d->br, data + 1, (size_t)(size - 1));
        if (!decode_image_stream(d, width, height, 1, NULL, &c, &tx, &ts)) goto done;
        int bytes_only = ts.n == 1 && ts.t[0].type == COLOR_INDEXING && c.cache_bits == 0;
        for (int i = 0; bytes_only && i < c.num_groups; i++)
            for (int j = RED; j <= ALPHA; j++)
                if (d->pool[c.groups[i].code[j]].bits > 0) bytes_only = 0;
        if (bytes_only) {
            idx = malloc((size_t)tx * (size_t)height);
            if (!idx) {
                rc = E_MEMORY;
                goto done;
            }
            if (!decode_alpha_indices(d, &c, idx, tx, height)) goto done;
            const Transform *t = &ts.t[0];
            const int bits_per_pixel = 8 >> t->bits, count_mask = (1 << t->bits) - 1;
            const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
            const uint8_t *in = idx;
            uint8_t *o = out;
            for (int y = 0; y < height; y++) {
                uint32_t packed = 0;
                for (int x = 0; x < width; x++) {
                    if ((x & count_mask) == 0) packed = *in++;
                    *o++ = (uint8_t)(t->data[packed & bit_mask] >> 8);
                    packed >>= bits_per_pixel;
                }
            }
        } else {
            px = malloc((size_t)tx * (size_t)height * sizeof(uint32_t));
            if (!px) {
                rc = E_MEMORY;
                goto done;
            }
            if (!decode_image_data(d, &c, px, tx, height)) goto done;
            px = apply_transforms(&ts, px);
            if (!px) {
                rc = E_MEMORY;
                goto done;
            }
            for (size_t i = 0; i < n; i++) out[i] = (uint8_t)(px[i] >> 8);
        }
        rc = E_OK;
    done:
        free(px);
        free(idx);
        free_codes(&c);
        free_transforms(&ts);
        free(d->pool);
        free(d);
        if (rc != E_OK) return rc;
    }
    for (int y = 0; y < height; y++)
        unfilter_row(filter, y ? out + (size_t)(y - 1) * width : NULL, out + (size_t)y * width, width);
    return E_OK;
}

/* --------------------------------------------------------------- VP8 */

/* The boolean decoder (RFC 6386 7) as libwebp's on a 64-bit machine: the
 * range stored minus one, a 64-bit value window loaded 56 bits at a time
 * while 8 bytes remain and then byte by byte, and the first load past the
 * end shifting in a zero byte and marking the partition ended, which
 * refuses the frame.  Valid data decodes the same under any loading; the
 * loading matters for data whose value leaves the range (a partition that
 * begins with 0xff), where libwebp's 64-bit window drops high bits. */
typedef struct {
    uint64_t value;
    uint32_t range;
    int bits, eof;
    const uint8_t *buf, *end, *max; /* max: the last position from which 8 bytes can be read, plus one */
} BoolReader;

static void br_load(BoolReader *br) {
    if (br->buf < br->max) {
        uint64_t bits = 0;
        for (int i = 0; i < 7; i++) bits = (bits << 8) | br->buf[i];
        br->buf += 7;
        br->value = bits | (br->value << 56);
        br->bits += 56;
    } else if (br->buf < br->end) {
        br->bits += 8;
        br->value = (uint64_t)(*br->buf++) | (br->value << 8);
    } else if (!br->eof) {
        br->value <<= 8;
        br->bits += 8;
        br->eof = 1;
    } else {
        br->bits = 0;
    }
}

static void br_init(BoolReader *br, const uint8_t *start, size_t size) {
    br->range = 255 - 1;
    br->value = 0;
    br->bits = -8;
    br->eof = 0;
    br->buf = start;
    br->end = start + size;
    br->max = size >= 8 ? start + size - 8 + 1 : start;
    br_load(br);
}

static inline int get_bit(BoolReader *br, int prob) {
    uint32_t range = br->range;
    if (br->bits < 0) br_load(br);
    const int pos = br->bits;
    const uint32_t split = (range * (uint32_t)prob) >> 8, value = (uint32_t)(br->value >> pos);
    const int bit = value > split;
    if (bit) {
        range -= split;
        br->value -= (uint64_t)(split + 1) << pos;
    } else {
        range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    br->bits -= shift;
    br->range = range - 1;
    return bit;
}

/* A sign (probability 1/2) applied to v, as libwebp reads it. */
static inline int get_signed(BoolReader *br, int v) {
    if (br->bits < 0) br_load(br);
    const int pos = br->bits;
    const uint32_t split = br->range >> 1, value = (uint32_t)(br->value >> pos);
    const int32_t mask = (int32_t)(split - value) >> 31;
    br->bits -= 1;
    br->range += (uint32_t)mask;
    br->range |= 1;
    br->value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
}

static int get_value(BoolReader *br, int bits) {
    int v = 0;
    while (bits-- > 0) v |= get_bit(br, 0x80) << bits;
    return v;
}

static int get_signed_value(BoolReader *br, int bits) {
    const int v = get_value(br, bits);
    return get_bit(br, 0x80) ? -v : v;
}

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED,
       B_HU_PRED, DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
       /* 16x16 and chroma DC at the frame's edges: without the top, the left or both (as 16x16 modes, 4-6
          are free) */
       B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6 };

/* Error codes of vpt_vp8_decode; io/codec.py names them. */
enum { V_OK = 0, V_FRAME = -10, V_NOT_KEY = -11, V_HIDDEN = -12, V_SIGNATURE = -13, V_PARTITION0 = -14,
       V_PARTITIONS = -15, V_EOF0 = -16, V_EOF = -17, V_MEMORY = -18, V_SIZE = -19 };

enum { BPS = 32, Y_OFF = BPS * 1 + 8, U_OFF = Y_OFF + BPS * 16 + BPS, V_OFF = U_OFF + 16, YUV_SIZE = BPS * 17 + BPS * 9 };

typedef struct {
    uint8_t segment, skip, is_i4x4, uvmode;
    uint8_t imodes[16];
    uint32_t non_zero_y, non_zero_uv;
    int16_t coeffs[384];
} MBData;

typedef struct {
    uint8_t limit, ilevel, inner, hev_thresh;
} FInfo;

typedef struct {
    int y1[2], y2[2], uv[2];
} Quant;

static inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
static inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

/* --- tokens (RFC 6386 13) */

static const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
                     kCat5[] = {180, 157, 141, 134, 130, 0},
                     kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
static const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

typedef uint8_t Probas[8][3][11]; /* [band][context][node] of one block type */

static int large_value(BoolReader *br, const uint8_t *p) {
    int v;
    if (!get_bit(br, p[3])) {
        v = !get_bit(br, p[4]) ? 2 : 3 + get_bit(br, p[5]);
    } else if (!get_bit(br, p[6])) {
        if (!get_bit(br, p[7])) {
            v = 5 + get_bit(br, 159);
        } else {
            v = 7 + 2 * get_bit(br, 165);
            v += get_bit(br, 145);
        }
    } else {
        const int bit1 = get_bit(br, p[8]), bit0 = get_bit(br, p[9 + bit1]), cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t *tab = kCat3456[cat]; *tab; tab++) v += v + get_bit(br, *tab);
        v += 3 + (8 << cat);
    }
    return v;
}

/* One block's coefficients from position n on, dequantised (dq[0] for the
 * DC, dq[1] for the rest) into out in raster order.  Returns the position
 * after the last coefficient read (16 when all were). */
static int get_coeffs(BoolReader *br, const Probas *prob, int ctx, const int *dq, int n, int16_t *out) {
    const uint8_t *p = (*prob)[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!get_bit(br, p[0])) return n;
        while (!get_bit(br, p[1])) {
            p = (*prob)[kBands[++n]][0];
            if (n == 16) return 16;
        }
        int v;
        if (!get_bit(br, p[2])) {
            v = 1;
            p = (*prob)[kBands[n + 1]][1];
        } else {
            v = large_value(br, p);
            p = (*prob)[kBands[n + 1]][2];
        }
        out[kZigzag[n]] = (int16_t)(get_signed(br, v) * dq[n > 0]);
    }
    return 16;
}

static inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : (uint32_t)dc_nz;
    return nz_coeffs;
}

static void transform_wht(const int16_t *in, int16_t *out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

typedef struct {
    uint8_t nz, nz_dc;
} NzCtx;

/* The residuals of one macroblock (libwebp's ParseResiduals).  Returns 1
 * when it has no non-zero coefficient. */
static int parse_residuals(BoolReader *br, const Probas *bands, const Quant *q, MBData *block, NzCtx *mb, NzCtx *left) {
    int16_t *dst = block->coeffs;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    const Probas *ac_proba;
    int first;
    memset(dst, 0, 384 * sizeof(*dst));
    if (!block->is_i4x4) {
        int16_t dc[16] = {0};
        const int ctx = mb->nz_dc + left->nz_dc;
        const int nz = get_coeffs(br, &bands[1], ctx, q->y2, 0, dc);
        mb->nz_dc = left->nz_dc = (nz > 0);
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
        }
        first = 1;
        ac_proba = &bands[0];
    } else {
        first = 0;
        ac_proba = &bands[3];
    }
    uint8_t tnz = mb->nz & 0x0f, lnz = left->nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        uint32_t nz_coeffs = 0;
        for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(br, ac_proba, ctx, q->y1, first, dst);
            l = (nz > first);
            tnz = (uint8_t)((tnz >> 1) | (l << 7));
            nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
            dst += 16;
        }
        tnz >>= 4;
        lnz = (uint8_t)((lnz >> 1) | (l << 7));
        non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
        uint32_t nz_coeffs = 0;
        tnz = (uint8_t)(mb->nz >> (4 + ch));
        lnz = (uint8_t)(left->nz >> (4 + ch));
        for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
                const int ctx = l + (tnz & 1);
                const int nz = get_coeffs(br, &bands[2], ctx, q->uv, 0, dst);
                l = (nz > 0);
                tnz = (uint8_t)((tnz >> 1) | (l << 3));
                nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 2;
            lnz = (uint8_t)((lnz >> 1) | (l << 5));
        }
        non_zero_uv |= nz_coeffs << (4 * ch);
        out_t_nz |= (uint32_t)(tnz << 4) << ch;
        out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
    }
    mb->nz = (uint8_t)out_t_nz;
    left->nz = (uint8_t)out_l_nz;
    block->non_zero_y = non_zero_y;
    block->non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
}

/* --- inverse transform and prediction (RFC 6386 12 and 14) */

static inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
static inline int mul2(int a) { return (a * 35468) >> 16; }

/* The full inverse DCT of one block, added to dst, as libwebp's x86 decoder
 * runs it (Transform_SSE2): every intermediate value in a 16-bit lane,
 * wrapping.  A valid stream never leaves 16 bits, so this is also the C
 * transform; the coefficients of a corrupt one can, and then only the lanes
 * give PIL's pixels. */
static inline int w16(int v) { return (int16_t)v; }
static inline int mul1_16(int a) { return w16(mul1(a)); }

static void transform_full(const int16_t *in, uint8_t *dst) {
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i) { /* vertical pass */
        const int a = w16(in[0] + in[8]), b = w16(in[0] - in[8]);
        const int c = w16(mul2(in[4]) - mul1_16(in[12])), d = w16(mul1_16(in[4]) + mul2(in[12]));
        tmp[0] = w16(a + d);
        tmp[1] = w16(b + c);
        tmp[2] = w16(b - c);
        tmp[3] = w16(a - d);
        tmp += 4;
        in++;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i) { /* horizontal pass */
        const int dc = w16(tmp[0] + 4);
        const int a = w16(dc + tmp[8]), b = w16(dc - tmp[8]);
        const int c = w16(mul2(tmp[4]) - mul1_16(tmp[12])), d = w16(mul1_16(tmp[4]) + mul2(tmp[12]));
        dst[0] = clip8(dst[0] + (w16(a + d) >> 3));
        dst[1] = clip8(dst[1] + (w16(b + c) >> 3));
        dst[2] = clip8(dst[2] + (w16(b - c) >> 3));
        dst[3] = clip8(dst[3] + (w16(a - d) >> 3));
        tmp++;
        dst += BPS;
    }
}

/* The shortcuts libwebp takes (in plain C, 32-bit) for a block whose only
 * coefficient is the DC, or whose only ones are the first three in zigzag
 * order. */
static void transform_dc(const int16_t *in, uint8_t *dst) {
    const int dc = in[0] + 4;
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(dst[x + y * BPS] + (dc >> 3));
}

static void transform_ac3(const int16_t *in, uint8_t *dst) {
    const int a = in[0] + 4, c4 = mul2(in[4]), d4 = mul1(in[4]), c1 = mul2(in[1]), d1 = mul1(in[1]);
    const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
    for (int y = 0; y < 4; ++y) {
        uint8_t *row = dst + y * BPS;
        row[0] = clip8(row[0] + ((dcs[y] + d1) >> 3));
        row[1] = clip8(row[1] + ((dcs[y] + c1) >> 3));
        row[2] = clip8(row[2] + ((dcs[y] - c1) >> 3));
        row[3] = clip8(row[3] + ((dcs[y] - d1) >> 3));
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

static void true_motion(uint8_t *dst, int size) {
    const uint8_t *top = dst - BPS;
    for (int y = 0; y < size; ++y) {
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
        dst += BPS;
    }
}

static void fill_block(uint8_t *dst, int v, int size) {
    for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, (size_t)size);
}

static void predict_luma16(int mode, uint8_t *dst) {
    int dc, j;
    switch (mode) {
    case B_TM_PRED: true_motion(dst, 16); break;
    case B_VE_PRED:
        for (j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
        break;
    case B_HE_PRED:
        for (j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
        break;
    case B_DC_PRED:
        dc = 16;
        for (j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        fill_block(dst, dc >> 5, 16);
        break;
    case B_DC_PRED_NOTOP:
        dc = 8;
        for (j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
        fill_block(dst, dc >> 4, 16);
        break;
    case B_DC_PRED_NOLEFT:
        dc = 8;
        for (j = 0; j < 16; ++j) dc += dst[j - BPS];
        fill_block(dst, dc >> 4, 16);
        break;
    default: fill_block(dst, 0x80, 16); break;
    }
}

static void predict_chroma8(int mode, uint8_t *dst) {
    int dc, j;
    switch (mode) {
    case B_TM_PRED: true_motion(dst, 8); break;
    case B_VE_PRED:
        for (j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
        break;
    case B_HE_PRED:
        for (j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
        break;
    case B_DC_PRED:
        dc = 8;
        for (j = 0; j < 8; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
        fill_block(dst, dc >> 4, 8);
        break;
    case B_DC_PRED_NOTOP:
        dc = 4;
        for (j = 0; j < 8; ++j) dc += dst[-1 + j * BPS];
        fill_block(dst, dc >> 3, 8);
        break;
    case B_DC_PRED_NOLEFT:
        dc = 4;
        for (j = 0; j < 8; ++j) dc += dst[j - BPS];
        fill_block(dst, dc >> 3, 8);
        break;
    default: fill_block(dst, 0x80, 8); break;
    }
}

static void predict_luma4(int mode, uint8_t *dst) {
    const uint8_t *top = dst - BPS;
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
              H = top[7];
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    int i;
    switch (mode) {
    case B_DC_PRED: {
        uint32_t dc = 4;
        for (i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        fill_block(dst, (int)(dc >> 3), 4);
        break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
        const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
        for (i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
        break;
    }
    case B_HE_PRED:
        memset(dst + 0 * BPS, AVG3(X, I, J), 4);
        memset(dst + 1 * BPS, AVG3(I, J, K), 4);
        memset(dst + 2 * BPS, AVG3(J, K, L), 4);
        memset(dst + 3 * BPS, AVG3(K, L, L), 4);
        break;
    case B_RD_PRED:
        DST(0, 3) = AVG3(J, K, L);
        DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
        DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
        DST(3, 0) = AVG3(D, C, B);
        break;
    case B_VR_PRED:
        DST(0, 0) = DST(1, 2) = (uint8_t)AVG2(X, A);
        DST(1, 0) = DST(2, 2) = (uint8_t)AVG2(A, B);
        DST(2, 0) = DST(3, 2) = (uint8_t)AVG2(B, C);
        DST(3, 0) = (uint8_t)AVG2(C, D);
        DST(0, 3) = AVG3(K, J, I);
        DST(0, 2) = AVG3(J, I, X);
        DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
        DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
        DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
        DST(3, 1) = AVG3(B, C, D);
        break;
    case B_LD_PRED:
        DST(0, 0) = AVG3(A, B, C);
        DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
        DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
        DST(3, 3) = AVG3(G, H, H);
        break;
    case B_VL_PRED:
        DST(0, 0) = (uint8_t)AVG2(A, B);
        DST(1, 0) = DST(0, 2) = (uint8_t)AVG2(B, C);
        DST(2, 0) = DST(1, 2) = (uint8_t)AVG2(C, D);
        DST(3, 0) = DST(2, 2) = (uint8_t)AVG2(D, E);
        DST(0, 1) = AVG3(A, B, C);
        DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
        DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
        DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
        DST(3, 2) = AVG3(E, F, G);
        DST(3, 3) = AVG3(F, G, H);
        break;
    case B_HD_PRED:
        DST(0, 0) = DST(2, 1) = (uint8_t)AVG2(I, X);
        DST(0, 1) = DST(2, 2) = (uint8_t)AVG2(J, I);
        DST(0, 2) = DST(2, 3) = (uint8_t)AVG2(K, J);
        DST(0, 3) = (uint8_t)AVG2(L, K);
        DST(3, 0) = AVG3(A, B, C);
        DST(2, 0) = AVG3(X, A, B);
        DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
        DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
        DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
        DST(1, 3) = AVG3(L, K, J);
        break;
    default: /* B_HU_PRED */
        DST(0, 0) = (uint8_t)AVG2(I, J);
        DST(2, 0) = DST(0, 1) = (uint8_t)AVG2(J, K);
        DST(2, 1) = DST(0, 2) = (uint8_t)AVG2(K, L);
        DST(1, 0) = AVG3(I, J, K);
        DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
        DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
        break;
    }
}

/* The mode a macroblock at the frame's top or left edge uses for DC. */
static inline int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
        if (mb_x == 0) return mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
        return mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED;
    }
    return mode;
}

/* --- loop filters (RFC 6386 15) */

static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

static inline void do_filter2(uint8_t *p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

static inline void do_filter4(uint8_t *p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

static inline void do_filter6(uint8_t *p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

static inline int hev(const uint8_t *p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

static inline int needs_filter(const uint8_t *p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

static inline int needs_filter2(const uint8_t *p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return 0;
    return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it && abs(q3 - q2) <= it &&
           abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

/* The simple filter across an edge of 16 pixels: hstride steps across the
 * edge, vstride along it. */
static void simple_filter16(uint8_t *p, int hstride, int vstride, int thresh) {
    const int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
        if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

/* The normal filter across an edge of `size` pixels: the macroblock-edge
 * variant (six taps) or the inner-edge one (four). */
static void filter_loop(uint8_t *p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh,
                        int mb_edge) {
    const int thresh2 = 2 * thresh + 1;
    while (size-- > 0) {
        if (needs_filter2(p, hstride, thresh2, ithresh)) {
            if (hev(p, hstride, hev_thresh)) {
                do_filter2(p, hstride);
            } else if (mb_edge) {
                do_filter6(p, hstride);
            } else {
                do_filter4(p, hstride);
            }
        }
        p += vstride;
    }
}

typedef struct {
    int w, h, mb_w, mb_h;
    int filter_type; /* 0 none, 1 simple, 2 normal */
    int y_stride, uv_stride;
    uint8_t *y, *u, *v;
} Frame;

static void filter_mb(const Frame *f, const FInfo *fi, int mb_x, int mb_y) {
    const int limit = fi->limit;
    if (limit == 0) return;
    const int ys = f->y_stride, uvs = f->uv_stride;
    uint8_t *y = f->y + (size_t)mb_y * 16 * ys + mb_x * 16;
    if (f->filter_type == 1) {
        if (mb_x > 0) simple_filter16(y, 1, ys, limit + 4);
        if (fi->inner)
            for (int k = 1; k <= 3; k++) simple_filter16(y + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_filter16(y, ys, 1, limit + 4);
        if (fi->inner)
            for (int k = 1; k <= 3; k++) simple_filter16(y + 4 * k * ys, ys, 1, limit);
        return;
    }
    uint8_t *u = f->u + (size_t)mb_y * 8 * uvs + mb_x * 8, *v = f->v + (size_t)mb_y * 8 * uvs + mb_x * 8;
    const int il = fi->ilevel, hv = fi->hev_thresh;
    if (mb_x > 0) {
        filter_loop(y, 1, ys, 16, limit + 4, il, hv, 1);
        filter_loop(u, 1, uvs, 8, limit + 4, il, hv, 1);
        filter_loop(v, 1, uvs, 8, limit + 4, il, hv, 1);
    }
    if (fi->inner) {
        for (int k = 1; k <= 3; k++) filter_loop(y + 4 * k, 1, ys, 16, limit, il, hv, 0);
        filter_loop(u + 4, 1, uvs, 8, limit, il, hv, 0);
        filter_loop(v + 4, 1, uvs, 8, limit, il, hv, 0);
    }
    if (mb_y > 0) {
        filter_loop(y, ys, 1, 16, limit + 4, il, hv, 1);
        filter_loop(u, uvs, 1, 8, limit + 4, il, hv, 1);
        filter_loop(v, uvs, 1, 8, limit + 4, il, hv, 1);
    }
    if (fi->inner) {
        for (int k = 1; k <= 3; k++) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hv, 0);
        filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hv, 0);
        filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hv, 0);
    }
}

/* --- YUV 4:2:0 to RGBA (libwebp's fancy upsampler and yuv.h) */

static inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
static inline uint8_t yuv_clip8(int v) { return (uint8_t)(((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255); }

static inline void yuv_to_rgba(int y, int u, int v, uint8_t *rgba) {
    rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
    rgba[3] = 0xff;
}

#define LOAD_UV(u, v) ((uint32_t)(u) | ((uint32_t)(v) << 16))

/* Two output rows between chroma rows `top` and `cur` (the bottom row may
 * be NULL), 9-3-3-1 weights. */
static void upsample_pair(const uint8_t *top_y, const uint8_t *bottom_y, const uint8_t *top_u, const uint8_t *top_v,
                          const uint8_t *cur_u, const uint8_t *cur_v, uint8_t *top_dst, uint8_t *bottom_dst, int len) {
    const int last_pixel_pair = (len - 1) >> 1;
    uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]), l_uv = LOAD_UV(cur_u[0], cur_v[0]);
    {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_rgba(top_y[0], (int)(uv0 & 0xff), (int)(uv0 >> 16), top_dst);
    }
    if (bottom_y != NULL) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_rgba(bottom_y[0], (int)(uv0 & 0xff), (int)(uv0 >> 16), bottom_dst);
    }
    for (int x = 1; x <= last_pixel_pair; ++x) {
        const uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]), uv = LOAD_UV(cur_u[x], cur_v[x]);
        const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
        const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3, diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
        {
            const uint32_t uv0 = (diag_12 + tl_uv) >> 1, uv1 = (diag_03 + t_uv) >> 1;
            yuv_to_rgba(top_y[2 * x - 1], (int)(uv0 & 0xff), (int)(uv0 >> 16), top_dst + (2 * x - 1) * 4);
            yuv_to_rgba(top_y[2 * x - 0], (int)(uv1 & 0xff), (int)(uv1 >> 16), top_dst + (2 * x - 0) * 4);
        }
        if (bottom_y != NULL) {
            const uint32_t uv0 = (diag_03 + l_uv) >> 1, uv1 = (diag_12 + uv) >> 1;
            yuv_to_rgba(bottom_y[2 * x - 1], (int)(uv0 & 0xff), (int)(uv0 >> 16), bottom_dst + (2 * x - 1) * 4);
            yuv_to_rgba(bottom_y[2 * x + 0], (int)(uv1 & 0xff), (int)(uv1 >> 16), bottom_dst + (2 * x + 0) * 4);
        }
        tl_uv = t_uv;
        l_uv = uv;
    }
    if (!(len & 1)) {
        {
            const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
            yuv_to_rgba(top_y[len - 1], (int)(uv0 & 0xff), (int)(uv0 >> 16), top_dst + (len - 1) * 4);
        }
        if (bottom_y != NULL) {
            const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
            yuv_to_rgba(bottom_y[len - 1], (int)(uv0 & 0xff), (int)(uv0 >> 16), bottom_dst + (len - 1) * 4);
        }
    }
}

/* The whole picture, as libwebp's EmitFancyRGB gives it over its rows: the
 * first row on chroma row 0 alone, then row pairs (2k - 1, 2k) between
 * chroma rows k - 1 and k, and the last row of an even height on the last
 * chroma row alone. */
static void emit_rgba(const Frame *f, uint8_t *out, int64_t stride) {
    const uint8_t *cur_y = f->y, *cur_u = f->u, *cur_v = f->v;
    upsample_pair(cur_y, NULL, cur_u, cur_v, cur_u, cur_v, out, NULL, f->w);
    int y = 0;
    for (; y + 2 < f->h; y += 2) {
        const uint8_t *top_u = cur_u, *top_v = cur_v;
        cur_u += f->uv_stride;
        cur_v += f->uv_stride;
        cur_y += 2 * f->y_stride;
        upsample_pair(cur_y - f->y_stride, cur_y, top_u, top_v, cur_u, cur_v, out + (size_t)(y + 1) * stride,
                      out + (size_t)(y + 2) * stride, f->w);
    }
    if (!(f->h & 1)) {
        cur_y += f->y_stride;
        upsample_pair(cur_y, NULL, cur_u, cur_v, cur_u, cur_v, out + (size_t)(f->h - 1) * stride, NULL, f->w);
    }
}

/* --- the frame */

static const int kScan[16] = {0 + 0 * BPS, 4 + 0 * BPS, 8 + 0 * BPS, 12 + 0 * BPS, 0 + 4 * BPS, 4 + 4 * BPS,
                              8 + 4 * BPS, 12 + 4 * BPS, 0 + 8 * BPS, 4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
                              0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

/* A block's transform, chosen by its two bits of non_zero_y as libwebp
 * chooses it: 3 full, 2 the first three coefficients, 1 the DC, 0 none. */
static void do_transform(uint32_t bits, const int16_t *src, uint8_t *dst) {
    switch (bits >> 30) {
    case 3: transform_full(src, dst); break;
    case 2: transform_ac3(src, dst); break;
    case 1: transform_dc(src, dst); break;
    default: break;
    }
}

/* A chroma plane's four blocks: all full where any has an AC coefficient,
 * else each non-zero DC alone. */
static void do_uv_transform(uint32_t bits, const int16_t *src, uint8_t *dst) {
    if (!(bits & 0xff)) return;
    for (int k = 0; k < 4; k++) {
        uint8_t *d = dst + (k & 1) * 4 + (k >> 1) * 4 * BPS;
        if (bits & 0xaa) {
            transform_full(src + 16 * k, d);
        } else if (src[16 * k]) {
            transform_dc(src + 16 * k, d);
        }
    }
}

/* Reconstruct one macroblock row into the frame (unfiltered), as libwebp's
 * ReconstructRow: the 129 left and 127 top borders, the top-right samples
 * of 4x4 prediction, the unfiltered top rows (yuv_t) of the row above. */
static void reconstruct_row(const Frame *f, const MBData *row, int mb_y, uint8_t *yuv_b, uint8_t *yuv_t) {
    uint8_t *y_dst = yuv_b + Y_OFF, *u_dst = yuv_b + U_OFF, *v_dst = yuv_b + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
        u_dst[j * BPS - 1] = 129;
        v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
        memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        memset(u_dst - BPS - 1, 127, 8 + 1);
        memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < f->mb_w; ++mb_x) {
        const MBData *block = row + mb_x;
        uint8_t *top = yuv_t + (size_t)mb_x * 32; /* 16 Y, 8 U, 8 V */
        if (mb_x > 0) {
            for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
            for (int j = -1; j < 8; ++j) {
                memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
                memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
            }
        }
        const int16_t *coeffs = block->coeffs;
        uint32_t bits = block->non_zero_y;
        if (mb_y > 0) {
            memcpy(y_dst - BPS, top, 16);
            memcpy(u_dst - BPS, top + 16, 8);
            memcpy(v_dst - BPS, top + 24, 8);
        }
        if (block->is_i4x4) {
            uint8_t *top_right = y_dst - BPS + 16;
            if (mb_y > 0) {
                if (mb_x >= f->mb_w - 1) {
                    memset(top_right, top[15], 4);
                } else {
                    memcpy(top_right, top + 32, 4);
                }
            }
            for (int k = 1; k <= 3; k++) memcpy(top_right + 4 * k * BPS, top_right, 4);
            for (int n = 0; n < 16; ++n, bits <<= 2) {
                uint8_t *dst = y_dst + kScan[n];
                predict_luma4(block->imodes[n], dst);
                do_transform(bits, coeffs + n * 16, dst);
            }
        } else {
            predict_luma16(check_mode(mb_x, mb_y, block->imodes[0]), y_dst);
            if (bits != 0)
                for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
        }
        const int uv_mode = check_mode(mb_x, mb_y, block->uvmode);
        predict_chroma8(uv_mode, u_dst);
        predict_chroma8(uv_mode, v_dst);
        do_uv_transform(block->non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
        do_uv_transform(block->non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
        if (mb_y < f->mb_h - 1) {
            memcpy(top, y_dst + 15 * BPS, 16);
            memcpy(top + 16, u_dst + 7 * BPS, 8);
            memcpy(top + 24, v_dst + 7 * BPS, 8);
        }
        uint8_t *fy = f->y + (size_t)mb_y * 16 * f->y_stride + mb_x * 16;
        uint8_t *fu = f->u + (size_t)mb_y * 8 * f->uv_stride + mb_x * 8;
        uint8_t *fv = f->v + (size_t)mb_y * 8 * f->uv_stride + mb_x * 8;
        for (int j = 0; j < 16; ++j) memcpy(fy + (size_t)j * f->y_stride, y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
            memcpy(fu + (size_t)j * f->uv_stride, u_dst + j * BPS, 8);
            memcpy(fv + (size_t)j * f->uv_stride, v_dst + j * BPS, 8);
        }
    }
}

/* A VP8 chunk's payload (its padding byte included, as libwebp reads it) as
 * (height, width) RGBA rows `stride` bytes apart, alpha 255; width and
 * height must be the frame header's. */
int vpt_vp8_decode(const uint8_t *data, int64_t size, int width, int height, uint8_t *out, int64_t stride) {
    if (size < 10) return V_FRAME;
    const uint32_t tag = data[0] | (data[1] << 8) | ((uint32_t)data[2] << 16);
    const int key_frame = !(tag & 1), profile = (tag >> 1) & 7, show = (tag >> 4) & 1;
    const uint32_t part0 = tag >> 5;
    if (profile > 3) return V_FRAME;
    if (!show) return V_HIDDEN;
    if (!key_frame) return V_NOT_KEY;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return V_SIGNATURE;
    if (((data[7] << 8 | data[6]) & 0x3fff) != width || ((data[9] << 8 | data[8]) & 0x3fff) != height) return V_SIZE;
    const uint8_t *buf = data + 10;
    size_t buf_size = (size_t)size - 10;
    if (part0 > buf_size) return V_PARTITION0;

    BoolReader br;
    br_init(&br, buf, part0);
    buf += part0;
    buf_size -= part0;
    get_value(&br, 1); /* colour space */
    get_value(&br, 1); /* clamping type: the decoder always clamps */

    /* segments */
    int use_segment = get_value(&br, 1), update_map = 0, absolute_delta = 1;
    int quantizer[4] = {0}, filter_strength[4] = {0};
    uint8_t seg_proba[3] = {255, 255, 255};
    if (use_segment) {
        update_map = get_value(&br, 1);
        if (get_value(&br, 1)) {
            absolute_delta = get_value(&br, 1);
            for (int s = 0; s < 4; ++s) quantizer[s] = get_value(&br, 1) ? get_signed_value(&br, 7) : 0;
            for (int s = 0; s < 4; ++s) filter_strength[s] = get_value(&br, 1) ? get_signed_value(&br, 6) : 0;
        }
        if (update_map)
            for (int s = 0; s < 3; ++s) seg_proba[s] = (uint8_t)(get_value(&br, 1) ? get_value(&br, 8) : 255);
    }
    if (br.eof) return V_PARTITION0;

    /* loop filter */
    const int simple = get_value(&br, 1), level = get_value(&br, 6), sharpness = get_value(&br, 3);
    const int use_lf_delta = get_value(&br, 1);
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
    if (use_lf_delta && get_value(&br, 1)) {
        for (int i = 0; i < 4; ++i)
            if (get_value(&br, 1)) ref_lf_delta[i] = get_signed_value(&br, 6);
        for (int i = 0; i < 4; ++i)
            if (get_value(&br, 1)) mode_lf_delta[i] = get_signed_value(&br, 6);
    }
    if (br.eof) return V_PARTITION0;

    /* token partitions: sizes of all but the last, which takes the rest */
    const int num_parts = 1 << get_value(&br, 2);
    BoolReader parts[8];
    {
        const size_t last = (size_t)num_parts - 1;
        if (buf_size < 3 * last) return V_PARTITIONS;
        const uint8_t *sz = buf, *part_start = buf + last * 3, *buf_end = buf + buf_size;
        size_t size_left = buf_size - last * 3;
        for (size_t p = 0; p < last; ++p) {
            size_t psize = sz[0] | (sz[1] << 8) | ((size_t)sz[2] << 16);
            if (psize > size_left) psize = size_left;
            br_init(&parts[p], part_start, psize);
            part_start += psize;
            size_left -= psize;
            sz += 3;
        }
        br_init(&parts[last], part_start, size_left);
        if (part_start >= buf_end) return V_PARTITIONS;
    }

    /* quantisers */
    Quant dqm[4];
    {
        const int base_q0 = get_value(&br, 7);
        const int dqy1_dc = get_value(&br, 1) ? get_signed_value(&br, 4) : 0;
        const int dqy2_dc = get_value(&br, 1) ? get_signed_value(&br, 4) : 0;
        const int dqy2_ac = get_value(&br, 1) ? get_signed_value(&br, 4) : 0;
        const int dquv_dc = get_value(&br, 1) ? get_signed_value(&br, 4) : 0;
        const int dquv_ac = get_value(&br, 1) ? get_signed_value(&br, 4) : 0;
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
            Quant *m = &dqm[i];
            m->y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
            m->y1[1] = kAcTable[clip(q + 0, 127)];
            m->y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
            /* x * 155 / 100 for every AC step, in integers */
            m->y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
            if (m->y2[1] < 8) m->y2[1] = 8;
            m->uv[0] = kDcTable[clip(q + dquv_dc, 117)];
            m->uv[1] = kAcTable[clip(q + dquv_ac, 127)];
        }
    }
    get_value(&br, 1); /* refresh_entropy_probs: one key frame, nothing to keep */

    /* coefficient probabilities */
    Probas *bands = malloc(4 * sizeof(Probas));
    if (!bands) return V_MEMORY;
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p)
                    bands[t][b][c][p] = (uint8_t)(get_bit(&br, kCoeffsUpdateProba[t][b][c][p]) ? get_value(&br, 8)
                                                                                                 : kCoeffsProba0[t][b][c][p]);
    const int use_skip_proba = get_value(&br, 1);
    const int skip_p = use_skip_proba ? get_value(&br, 8) : 0;

    /* filter strengths per segment and 4x4 mode */
    const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
    FInfo fstrengths[4][2];
    memset(fstrengths, 0, sizeof(fstrengths));
    if (filter_type > 0) {
        for (int s = 0; s < 4; ++s) {
            int base_level = level;
            if (use_segment) {
                base_level = filter_strength[s];
                if (!absolute_delta) base_level += level;
            }
            for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
                FInfo *info = &fstrengths[s][i4x4];
                int lv = base_level;
                if (use_lf_delta) {
                    lv += ref_lf_delta[0];
                    if (i4x4) lv += mode_lf_delta[0];
                }
                lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
                if (lv > 0) {
                    int ilevel = lv;
                    if (sharpness > 0) {
                        ilevel >>= sharpness > 4 ? 2 : 1;
                        if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
                    }
                    if (ilevel < 1) ilevel = 1;
                    info->ilevel = (uint8_t)ilevel;
                    info->limit = (uint8_t)(2 * lv + ilevel);
                    info->hev_thresh = (uint8_t)(lv >= 40 ? 2 : lv >= 15 ? 1 : 0);
                } else {
                    info->limit = 0;
                }
                info->inner = (uint8_t)i4x4;
            }
        }
    }

    Frame f;
    f.w = width;
    f.h = height;
    f.mb_w = (width + 15) >> 4;
    f.mb_h = (height + 15) >> 4;
    f.filter_type = filter_type;
    f.y_stride = f.mb_w * 16;
    f.uv_stride = f.mb_w * 8;
    const size_t ysize = (size_t)f.y_stride * f.mb_h * 16, uvsize = (size_t)f.uv_stride * f.mb_h * 8;
    uint8_t *planes = malloc(ysize + 2 * uvsize);
    MBData *row = malloc((size_t)f.mb_w * sizeof(MBData));
    FInfo *finfo = malloc((size_t)f.mb_w * f.mb_h * sizeof(FInfo));
    NzCtx *nz = calloc((size_t)f.mb_w + 1, sizeof(NzCtx));
    uint8_t *intra_t = malloc((size_t)f.mb_w * 4), *yuv_t = calloc((size_t)f.mb_w + 1, 32);
    uint8_t *yuv_b = calloc(1, YUV_SIZE);
    int rc = V_MEMORY;
    if (!planes || !row || !finfo || !nz || !intra_t || !yuv_t || !yuv_b) goto done;
    f.y = planes;
    f.u = planes + ysize;
    f.v = planes + ysize + uvsize;
    memset(intra_t, B_DC_PRED, (size_t)f.mb_w * 4);
    for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
        uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
        /* the row's modes, from the first partition */
        for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
            MBData *block = &row[mb_x];
            uint8_t *top = intra_t + 4 * mb_x;
            block->segment = update_map ? (uint8_t)(!get_bit(&br, seg_proba[0]) ? get_bit(&br, seg_proba[1])
                                                                                 : get_bit(&br, seg_proba[2]) + 2)
                                        : 0;
            block->skip = use_skip_proba ? (uint8_t)get_bit(&br, skip_p) : 0;
            block->is_i4x4 = !get_bit(&br, 145);
            if (!block->is_i4x4) {
                const int ymode = get_bit(&br, 156) ? (get_bit(&br, 128) ? TM_PRED : H_PRED)
                                                    : (get_bit(&br, 163) ? V_PRED : DC_PRED);
                block->imodes[0] = (uint8_t)ymode;
                memset(top, ymode, 4);
                memset(intra_l, ymode, 4);
            } else {
                uint8_t *modes = block->imodes;
                for (int y = 0; y < 4; ++y) {
                    int ymode = intra_l[y];
                    for (int x = 0; x < 4; ++x) {
                        const uint8_t *prob = kBModesProba[top[x]][ymode];
                        int i = kYModesIntra4[get_bit(&br, prob[0])];
                        while (i > 0) i = kYModesIntra4[2 * i + get_bit(&br, prob[i])];
                        ymode = -i;
                        top[x] = (uint8_t)ymode;
                    }
                    memcpy(modes, top, 4);
                    modes += 4;
                    intra_l[y] = (uint8_t)ymode;
                }
            }
            block->uvmode = !get_bit(&br, 142) ? DC_PRED : !get_bit(&br, 114) ? V_PRED : get_bit(&br, 183) ? TM_PRED
                                                                                                         : H_PRED;
        }
        if (br.eof) {
            rc = V_EOF0;
            goto done;
        }
        /* the row's residuals, from its token partition */
        BoolReader *tbr = &parts[mb_y & (num_parts - 1)];
        NzCtx *left = &nz[f.mb_w];
        left->nz = left->nz_dc = 0;
        for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
            MBData *block = &row[mb_x];
            NzCtx *mb = &nz[mb_x];
            int skip = use_skip_proba ? block->skip : 0;
            if (!skip) {
                skip = parse_residuals(tbr, bands, &dqm[block->segment], block, mb, left);
            } else {
                left->nz = mb->nz = 0;
                if (!block->is_i4x4) left->nz_dc = mb->nz_dc = 0;
                block->non_zero_y = 0;
                block->non_zero_uv = 0;
            }
            if (filter_type > 0) {
                FInfo *fi = &finfo[(size_t)mb_y * f.mb_w + mb_x];
                *fi = fstrengths[block->segment][block->is_i4x4];
                fi->inner |= (uint8_t)!skip;
            }
            if (tbr->eof) {
                rc = V_EOF;
                goto done;
            }
        }
        reconstruct_row(&f, row, mb_y, yuv_b, yuv_t);
    }
    if (filter_type > 0)
        for (int mb_y = 0; mb_y < f.mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) filter_mb(&f, &finfo[(size_t)mb_y * f.mb_w + mb_x], mb_x, mb_y);
    emit_rgba(&f, out, stride);
    rc = V_OK;
done:
    free(bands);
    free(planes);
    free(row);
    free(finfo);
    free(nz);
    free(intra_t);
    free(yuv_t);
    free(yuv_b);
    return rc;
}
