// Native data plane of the port's data pipeline (a copy of the JAX
// package's flash_diffusion_tpu/data/native/fastjpeg.cpp, the same code):
// JPEG decode -> DCT prescale -> bilinear cover-resize -> center crop ->
// float32 [-1, 1] HWC in one call, no Python objects. Called through ctypes
// from the decode workers; ctypes releases the GIL for the call, so thread
// workers decode on several host cores at once.
//
// Build: g++ -O3 -shared -fPIC fastjpeg.cpp -ljpeg -o libfastjpeg.so
// (data/native_decode.py builds it at first use under build/native/;
// libjpeg-turbo gives the SIMD decode and the 1/8..8/8 DCT-space prescale).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jump, 1);
}

// warnings (e.g. "Premature end of JPEG file" on truncated-but-decodable
// members) stay silent — warn_and_continue pipelines over dirty datasets
// would otherwise spam stderr per image
void on_message(j_common_ptr) {}

// Horizontal bilinear pass for ONE source row: uint8 (w x 3) -> float
// (tw x 3) using precomputed left indices + weights. Plain indexed loops
// so -O3 auto-vectorizes.
inline void hresample_row(const uint8_t* src, int /*w*/, int tw,
                          const int* x0s, const float* fxs, float* dst) {
  for (int x = 0; x < tw; ++x) {
    const int x0 = x0s[2 * x], x1 = x0s[2 * x + 1];
    const float fx = fxs[x], gx = 1.0f - fx;
    const uint8_t* a = src + static_cast<size_t>(x0) * 3;
    const uint8_t* b = src + static_cast<size_t>(x1) * 3;
    dst[x * 3] = gx * a[0] + fx * b[0];
    dst[x * 3 + 1] = gx * a[1] + fx * b[1];
    dst[x * 3 + 2] = gx * a[2] + fx * b[2];
  }
}

}  // namespace

extern "C" {

// Decode jpeg bytes; cover-resize + center-crop to (th, tw); write float32
// [-1, 1] HWC into out (th*tw*3 floats). Returns 0 on success, negative on
// error. orig_hw (optional, may be null) receives the pre-resize (h, w) —
// callers emit SDXL-style micro-cond tuples from it.
int fj_decode_to_tensor(const uint8_t* data, size_t len, int th, int tw,
                        float* out, int* orig_hw) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.output_message = on_message;
  // Heap buffers via volatile raw pointers: longjmp back here would SKIP
  // C++ destructors of anything constructed after setjmp (leaking the
  // decoded image on every corrupt JPEG under warn_and_continue), and
  // non-volatile locals modified after setjmp are indeterminate at the
  // jump target. volatile pointers survive and get freed explicitly.
  uint8_t* volatile buf = nullptr;
  uint8_t* volatile rowmem = nullptr;
  if (setjmp(err.jump)) {
    std::free(const_cast<uint8_t*>(buf));
    std::free(const_cast<uint8_t*>(rowmem));
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  if (orig_hw) {
    orig_hw[0] = static_cast<int>(cinfo.image_height);
    orig_hw[1] = static_cast<int>(cinfo.image_width);
  }
  // DCT-space prescale: smallest num/8 (libjpeg-turbo supports 1..16/8)
  // whose output still COVERS (th, tw) — decode cost drops ~quadratically.
  cinfo.scale_denom = 8;
  unsigned num = 8;
  for (unsigned n = 1; n <= 8; ++n) {
    unsigned long sh = (cinfo.image_height * n + 7) / 8;
    unsigned long sw = (cinfo.image_width * n + 7) / 8;
    if (sh >= static_cast<unsigned long>(th) &&
        sw >= static_cast<unsigned long>(tw)) {
      num = n;
      break;
    }
  }
  cinfo.scale_num = num;
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height, w = cinfo.output_width;
  const int comps = cinfo.output_components;
  if (comps != 3) {  // grayscale etc.: decode then expand
    if (comps != 1) {
      jpeg_destroy_decompress(&cinfo);
      return -3;
    }
  }
  buf = static_cast<uint8_t*>(std::malloc(static_cast<size_t>(h) * w * 3));
  rowmem = static_cast<uint8_t*>(std::malloc(static_cast<size_t>(w) * comps));
  if (!buf || !rowmem) {
    std::free(const_cast<uint8_t*>(buf));
    std::free(const_cast<uint8_t*>(rowmem));
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  {
    uint8_t* bufp = const_cast<uint8_t*>(buf);
    uint8_t* rowq = const_cast<uint8_t*>(rowmem);
    JSAMPROW rowp = rowq;
    for (int y = 0; y < h; ++y) {
      jpeg_read_scanlines(&cinfo, &rowp, 1);
      uint8_t* dst = bufp + static_cast<size_t>(y) * w * 3;
      if (comps == 3) {
        std::memcpy(dst, rowq, static_cast<size_t>(w) * 3);
      } else {
        for (int x = 0; x < w; ++x) {
          dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = rowq[x];
        }
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::free(const_cast<uint8_t*>(rowmem));
  rowmem = nullptr;
  const uint8_t* bufr = const_cast<const uint8_t*>(buf);  // no jpeg calls follow

  // cover-resize scale, then center-crop offsets in SOURCE coordinates.
  // Separable bilinear: precomputed x taps, one horizontal pass per needed
  // source row (cached), vertical blend fused with the [-1,1] normalize.
  const float scale_h = static_cast<float>(th) / h;
  const float scale_w = static_cast<float>(tw) / w;
  const float s = scale_h > scale_w ? scale_h : scale_w;  // cover
  const float src_h_used = th / s, src_w_used = tw / s;
  const float oy = (h - src_h_used) * 0.5f;
  const float ox = (w - src_w_used) * 0.5f;
  const float inv = 1.0f / s;

  std::vector<int> x0s(2 * tw);
  std::vector<float> fxs(tw);
  for (int x = 0; x < tw; ++x) {
    float sx = ox + (x + 0.5f) * inv - 0.5f;
    if (sx < 0) sx = 0;
    int x0 = static_cast<int>(sx);
    if (x0 > w - 1) x0 = w - 1;
    x0s[2 * x] = x0;
    x0s[2 * x + 1] = x0 + 1 < w ? x0 + 1 : w - 1;
    fxs[x] = sx - x0;
  }

  // two-row cache of horizontally-resampled source rows
  std::vector<float> rowa(static_cast<size_t>(tw) * 3);
  std::vector<float> rowb(static_cast<size_t>(tw) * 3);
  int ya = -1, yb = -1;
  const float k = 2.0f / 255.0f;
  for (int y = 0; y < th; ++y) {
    float sy = oy + (y + 0.5f) * inv - 0.5f;
    if (sy < 0) sy = 0;
    int y0 = static_cast<int>(sy);
    if (y0 > h - 1) y0 = h - 1;
    const int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    const float fy = sy - y0, gy = 1.0f - fy;
    if (ya != y0) {
      if (yb == y0) {  // rows advance by at most one: reuse the cache
        std::swap(rowa, rowb);
        ya = y0;
        yb = -1;
      } else {
        hresample_row(bufr + static_cast<size_t>(y0) * w * 3, w, tw,
                      x0s.data(), fxs.data(), rowa.data());
        ya = y0;
      }
    }
    if (yb != y1) {
      hresample_row(bufr + static_cast<size_t>(y1) * w * 3, w, tw,
                    x0s.data(), fxs.data(), rowb.data());
      yb = y1;
    }
    float* orow = out + static_cast<size_t>(y) * tw * 3;
    const float* a = rowa.data();
    const float* b = rowb.data();
    for (int i = 0; i < tw * 3; ++i) {
      orow[i] = (gy * a[i] + fy * b[i]) * k - 1.0f;
    }
  }
  std::free(const_cast<uint8_t*>(buf));
  return 0;
}

}  // extern "C"
