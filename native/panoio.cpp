// Native I/O runtime: fast RGBA PNG encode/decode on libpng/zlib.
//
// The reference's runtime layer is C++ (image I/O via OpenCV wrappers,
// CPU/util.cpp:19-46); this is the framework's native counterpart:
// a small C core driving libpng directly with interlace-free, filter-
// tuned settings, exposed to Python over a plain C ABI (ctypes -- no
// pybind11 dependency).  Decode/encode avoid PIL's per-row Python
// overhead and release the GIL for the whole operation, so a host
// thread can stream the next panorama while the device stitches the
// current one (utils/native_io.py builds the double-buffered loader on
// top).
//
// Build: see native/build.sh (g++ -O3 -fPIC -shared -lpng -lz).

#include <png.h>
#include <zlib.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct MemReader {
  const unsigned char* data;
  size_t size;
  size_t pos;
};

void mem_read(png_structp png, png_bytep out, png_size_t n) {
  MemReader* r = static_cast<MemReader*>(png_get_io_ptr(png));
  if (r->pos + n > r->size) {
    png_error(png, "read past end");
  }
  std::memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

struct MemWriter {
  std::vector<unsigned char> buf;
};

void mem_write(png_structp png, png_bytep data, png_size_t n) {
  MemWriter* w = static_cast<MemWriter*>(png_get_io_ptr(png));
  w->buf.insert(w->buf.end(), data, data + n);
}

void mem_flush(png_structp) {}

}  // namespace

extern "C" {

// Decode a PNG buffer to RGBA8.  Returns 0 on success.  On the first
// call pass *out = nullptr and receive dimensions; the caller allocates
// h*w*4 bytes and calls again with the buffer.
int panoio_png_decode(const unsigned char* data, size_t size,
                      unsigned char* out, int* height, int* width) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -1;
  }
  MemReader reader{data, size, 0};
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -2;
  }
  png_set_read_fn(png, &reader, mem_read);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  *height = static_cast<int>(h);
  *width = static_cast<int>(w);
  if (out == nullptr) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }

  // normalise everything to 8-bit RGBA
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (!(color_type & PNG_COLOR_MASK_ALPHA) &&
      !png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_filler(png, 0xFF, PNG_FILLER_AFTER);
  png_read_update_info(png, info);

  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out + y * w * 4;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// Encode RGBA8 to PNG.  Returns the encoded size, or <0 on error.  Two
// phase: first call with out=nullptr to get the size upper bound is not
// supported -- instead the callback-grown buffer is copied into `out`
// (capacity `out_cap`); if too small, returns -(needed).
long panoio_png_encode(const unsigned char* rgba, int height, int width,
                       int compress_level, unsigned char* out,
                       size_t out_cap) {
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    return -1;
  }
  MemWriter writer;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    return -2;
  }
  png_set_write_fn(png, &writer, mem_write, mem_flush);
  png_set_IHDR(png, info, width, height, 8, PNG_COLOR_TYPE_RGBA,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_set_compression_level(png, compress_level);
  // SUB filter alone is a good speed/size point for photographic RGBA
  png_set_filter(png, 0, PNG_FILTER_SUB);
  png_write_info(png, info);

  std::vector<png_bytep> rows(height);
  for (int y = 0; y < height; ++y)
    rows[y] = const_cast<png_bytep>(rgba + static_cast<size_t>(y) * width * 4);
  png_write_image(png, rows.data());
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);

  if (writer.buf.size() > out_cap)
    return -static_cast<long>(writer.buf.size());
  std::memcpy(out, writer.buf.data(), writer.buf.size());
  return static_cast<long>(writer.buf.size());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TIFF codec (libtiff) -- the reference pipeline's input format
// (1.tif..5.tif, top.tif; imreadExceptionOnFail at CPU/util.cpp:19-26).
// File-path API: panoramas are large, streaming through the OS cache is
// fine, and TIFFOpen keeps the surface small.
// ---------------------------------------------------------------------------

#include <tiffio.h>

extern "C" {

// Decode a striped, contiguous, 8-bit gray/RGB/RGBA TIFF to RGBA8,
// top-left origin, alpha passed through bit-exactly.  (libtiff's RGBA
// convenience interface premultiplies unassociated alpha into the
// colour channels, which would corrupt the alpha-as-footprint canvases
// this pipeline stitches -- so read raw scanlines instead and reject
// exotic layouts; the Python layer falls back to PIL for those.)
// First call with out=nullptr fills *height/*width; second call fills
// the caller-allocated h*w*4 buffer.  Returns 0 on success.
int panoio_tiff_decode(const char* path, unsigned char* out, int* height,
                       int* width) {
  TIFFSetWarningHandler(nullptr);  // noisy unknown-tag warnings
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return -1;
  uint32_t w = 0, h = 0;
  uint16_t bps = 0, spp = 0, planar = PLANARCONFIG_CONTIG;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &w);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &h);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &planar);
  *height = static_cast<int>(h);
  *width = static_cast<int>(w);
  if (out == nullptr) {
    TIFFClose(tif);
    return 0;
  }
  if (bps != 8 || (spp != 1 && spp != 3 && spp != 4) ||
      planar != PLANARCONFIG_CONTIG || TIFFIsTiled(tif)) {
    TIFFClose(tif);
    return -3;  // unsupported layout: caller falls back
  }
  std::vector<unsigned char> row(TIFFScanlineSize(tif));
  for (uint32_t y = 0; y < h; ++y) {
    if (TIFFReadScanline(tif, row.data(), y, 0) < 0) {
      TIFFClose(tif);
      return -2;
    }
    unsigned char* dst = out + static_cast<size_t>(y) * w * 4;
    const unsigned char* src = row.data();
    if (spp == 4) {
      std::memcpy(dst, src, static_cast<size_t>(w) * 4);
    } else if (spp == 3) {
      for (uint32_t x = 0; x < w; ++x) {
        dst[4 * x + 0] = src[3 * x + 0];
        dst[4 * x + 1] = src[3 * x + 1];
        dst[4 * x + 2] = src[3 * x + 2];
        dst[4 * x + 3] = 0xFF;
      }
    } else {  // gray
      for (uint32_t x = 0; x < w; ++x) {
        dst[4 * x + 0] = dst[4 * x + 1] = dst[4 * x + 2] = src[x];
        dst[4 * x + 3] = 0xFF;
      }
    }
  }
  TIFFClose(tif);
  return 0;
}

// Encode 8-bit RGBA to a striped LZW TIFF with an unassociated-alpha
// extra sample (what cv::imwrite produces for CV_8UC4 and what the
// decoder above reads back bit-exactly).  Returns 0 on success.
int panoio_tiff_encode(const char* path, const unsigned char* rgba,
                       int height, int width) {
  TIFF* tif = TIFFOpen(path, "w");
  if (!tif) return -1;
  TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, static_cast<uint32_t>(width));
  TIFFSetField(tif, TIFFTAG_IMAGELENGTH, static_cast<uint32_t>(height));
  TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, 4);
  TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, 8);
  TIFFSetField(tif, TIFFTAG_ORIENTATION, ORIENTATION_TOPLEFT);
  TIFFSetField(tif, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
  TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
  TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_LZW);
  uint16_t extra[] = {EXTRASAMPLE_UNASSALPHA};
  TIFFSetField(tif, TIFFTAG_EXTRASAMPLES, 1, extra);
  TIFFSetField(tif, TIFFTAG_ROWSPERSTRIP,
               TIFFDefaultStripSize(tif, static_cast<uint32_t>(-1)));
  for (int y = 0; y < height; ++y) {
    if (TIFFWriteScanline(
            tif,
            const_cast<unsigned char*>(rgba +
                                       static_cast<size_t>(y) * width * 4),
            y, 0) < 0) {
      TIFFClose(tif);
      return -2;
    }
  }
  TIFFClose(tif);
  return 0;
}

}  // extern "C"
