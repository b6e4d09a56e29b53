// ReID crops: crop, resize and standardize boxes of a uint8 BGR frame into
// the backbone's (N, 3, oh, ow) input, in one launch.
//
// Replaces boxmot_tpu/ops/crops.py::extract_crops with crop_resize_aabb,
// crop_resize_obb and standardize (no Pallas kernel: on the TPU the
// axis-aligned resize runs as two fp32 products with dense (N, oh, H) and
// (N, ow, W) interpolation matrices at HIGHEST precision, because a gather
// costs about a millisecond a crop there; at 64 crops of a 1080p frame those
// products do about 115 GFLOP, all but two terms of every sum zero).  Here a
// gather is cheap: output pixel (n, i, j) maps to its source coordinates,
// reads the four taps of each channel from the frame (BGR, read as RGB:
// output channel c reads frame channel 2 - c), divides them by 255,
// interpolates horizontally then vertically, subtracts the ImageNet mean,
// divides by the ImageNet std and stores the three channels, fp32 or rounded
// to bf16.
//
// Bound on this card: bytes.  A call reads the frame (H * W * 3 bytes, 6.2
// MB at 1080p) and the boxes once, and writes N * 3 * oh * ow outputs: at 64
// crops of 256 x 128 in fp32, 25.2 MB, about 9.4 us at 3.35 TB/s.
//
// Design.  A block of 256 threads covers one crop's band of 16 output rows
// and up to 512 columns.  What a pixel shares with its row or its column is
// computed once a block into shared memory:
//   * the 256 quotients k / 255 (k = 0..255) as a table: a tap's value is a
//     table read, bit-equal to the true division because the dividend is an
//     exact integer;
//   * axis-aligned: each column's and each row's taps (c0, c1, the weight
//     and its complement);
//   * rotated: each column's cx + u cos a and cy + u sin a, each row's
//     v sin a and v cos a, the terms of the source coordinates that
//     separate; a pixel adds them in the twin's order and takes its taps.
// A thread computes two adjacent output columns of a row (four took 58
// registers a thread, which halved the blocks an SM holds).  The two horizontal taps of a row are adjacent pixels (c1 is c0 +
// 1, or c0 at the border), six bytes read as two or three aligned 32-bit
// words when the frame is 4-byte aligned and they lie inside it (bytes
// otherwise).  Stores are 8 bytes a channel for fp32 and 4 for bf16 when ow
// is even and the output is aligned; scalar otherwise.
//
// Arithmetic equals the plain twin (ops/crops.py::extract_crops_plain) bit
// for bit: every operation is an explicitly rounded intrinsic in the twin's
// order, divisions are true divisions (never by a reciprocal), the library
// is built with -fmad=false, and a rotated box's cos and sin come from the
// wrapper (float64, rounded once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one table entry a thread
constexpr int kRows = 16;      // output rows a block covers
constexpr int kCols = 512;     // output columns a block covers, at most (<= 2 x kThreads)
constexpr int kFrameAligned = 1;  // flags: the frame's start is 4-byte aligned
constexpr int kVectorStores = 2;  // rows of 2-column groups are store-aligned
__constant__ float kMean[3] = {0.485f, 0.456f, 0.406f};
__constant__ float kStd[3] = {0.229f, 0.224f, 0.225f};

// Clamped-bilinear taps on one axis: c0, c1, the weight of c1 and 1 - it.
__device__ __forceinline__ float4 axis_taps(float g, int size) {
  const float hi = static_cast<float>(size - 1);
  const float c = fminf(fmaxf(g, 0.0f), hi);
  const float c0 = floorf(c);
  const float c1 = fminf(__fadd_rn(c0, 1.0f), hi);
  const float w = __fsub_rn(c, c0);
  return make_float4(__int_as_float(static_cast<int>(c0)), __int_as_float(static_cast<int>(c1)),
                     w, __fsub_rn(1.0f, w));
}

// The bytes of the pixels at byte offset off (p0) and off + 3 (p1) of the
// frame, 3 a pixel in the low bytes; p1 = p0 when `same`.
__device__ __forceinline__ void pixel_pair(const unsigned char* __restrict__ f, long off,
                                           long total, bool aligned, bool same, unsigned& p0,
                                           unsigned& p1) {
  const long a = off & ~3L;
  if (aligned && a + 12 <= total) {
    const unsigned* w = reinterpret_cast<const unsigned*>(f + a);
    const int s = static_cast<int>(off - a);
    const unsigned w0 = __ldg(w), w1 = __ldg(w + 1), w2 = s == 3 ? __ldg(w + 2) : 0u;
    const unsigned x = __funnelshift_r(w0, w1, 8 * s);  // bytes off .. off + 3
    const unsigned y = __funnelshift_r(w1, w2, 8 * s);  // bytes off + 4 ..
    p0 = x & 0xffffffu;
    p1 = same ? p0 : (x >> 24) | ((y & 0xffffu) << 8);
  } else {
    p0 = __ldg(f + off) | (__ldg(f + off + 1) << 8) | (__ldg(f + off + 2) << 16);
    p1 = same ? p0 : __ldg(f + off + 3) | (__ldg(f + off + 4) << 8) | (__ldg(f + off + 5) << 16);
  }
}

__device__ __forceinline__ float byte_of(const float* t255, unsigned p, int ch) {
  return t255[(p >> (8 * ch)) & 0xffu];
}

template <typename Out>
struct Store;
template <>
struct Store<float> {
  static __device__ __forceinline__ void two(float* p, const float v[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
  static __device__ __forceinline__ void one(float* p, float v) { *p = v; }
};
template <>
struct Store<__nv_bfloat16> {
  static __device__ __forceinline__ void two(__nv_bfloat16* p, const float v[2]) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  }
  static __device__ __forceinline__ void one(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// boxes: (N, 4) xyxy, or (N, 5) xywha with trig (2, N): cos then sin.
// blockIdx.x: column tile + col_tiles * row band; blockIdx.y: the crop.
template <bool kObb, typename Out>
__global__ void __launch_bounds__(kThreads)
    crops_kernel(const unsigned char* __restrict__ frame, const float* __restrict__ boxes,
                 const float* __restrict__ trig, Out* __restrict__ out, int H, int W, int N,
                 int oh, int ow, int col_tiles, int flags) {
  __shared__ float t255[256];
  __shared__ float4 col[kCols];  // AABB: x0, x1 (int bits), wx, rx; OBB: cx + u ca, cy + u sa
  __shared__ float4 row[kRows];  // AABB: y0, y1 (int bits), wy, ry; OBB: v sa, v ca
  const int t = threadIdx.x, n = blockIdx.y;
  const int j_begin = (blockIdx.x % col_tiles) * kCols, i_begin = (blockIdx.x / col_tiles) * kRows;
  const int ncols = min(kCols, ow - j_begin), nrows = min(kRows, oh - i_begin);
  t255[t] = __fdiv_rn(static_cast<float>(t), 255.0f);
  const float* b = boxes + n * (kObb ? 5 : 4);
  float ca = 0.0f, sa = 0.0f;
  if (kObb) {
    ca = trig[n];
    sa = trig[N + n];
  }
  for (int q = t; q < ncols; q += kThreads) {
    const float fj = __fadd_rn(static_cast<float>(j_begin + q), 0.5f);
    if (kObb) {
      const float u = __fmul_rn(__fsub_rn(__fdiv_rn(fj, static_cast<float>(ow)), 0.5f), b[2]);
      col[q] = make_float4(__fadd_rn(b[0], __fmul_rn(u, ca)), __fadd_rn(b[1], __fmul_rn(u, sa)),
                           0.0f, 0.0f);
    } else {
      const float sx = __fdiv_rn(__fsub_rn(b[2], b[0]), static_cast<float>(ow));
      col[q] = axis_taps(__fadd_rn(__fmul_rn(fj, sx), __fsub_rn(b[0], 0.5f)), W);
    }
  }
  for (int q = t; q < nrows; q += kThreads) {
    const float fi = __fadd_rn(static_cast<float>(i_begin + q), 0.5f);
    if (kObb) {
      const float v = __fmul_rn(__fsub_rn(__fdiv_rn(fi, static_cast<float>(oh)), 0.5f), b[3]);
      row[q] = make_float4(__fmul_rn(v, sa), __fmul_rn(v, ca), 0.0f, 0.0f);
    } else {
      const float sy = __fdiv_rn(__fsub_rn(b[3], b[1]), static_cast<float>(oh));
      row[q] = axis_taps(__fadd_rn(__fmul_rn(fi, sy), __fsub_rn(b[1], 0.5f)), H);
    }
  }
  __syncthreads();

  const long total = static_cast<long>(H) * W * 3;
  const bool aligned = flags & kFrameAligned;
  const long plane = static_cast<long>(oh) * ow;
  // thread t: the pair of columns t % pairs, rows t / pairs, t / pairs + step, ...
  const int pairs = (ncols + 1) >> 1;  // at most kCols / 2 <= kThreads
  const int step = kThreads / pairs;
  if (t < step * pairs) {
    const int q0 = (t % pairs) * 2;
    for (int qi = t / pairs; qi < nrows; qi += step) {
      const float4 r = row[qi];
      float4 ax[2], ay[2];
      unsigned p[2][4];  // per column: the taps (y0, x0), (y0, x1), (y1, x0), (y1, x1)
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // every load first; past ncols a column repeats the last
        const float4 c = col[min(q0 + k, ncols - 1)];
        if (kObb) {
          ax[k] = axis_taps(__fsub_rn(__fsub_rn(c.x, r.x), 0.5f), W);
          ay[k] = axis_taps(__fsub_rn(__fadd_rn(c.y, r.y), 0.5f), H);
        } else {
          ax[k] = c;
          ay[k] = r;
        }
        const int x0 = __float_as_int(ax[k].x), x1 = __float_as_int(ax[k].y);
        const int y0 = __float_as_int(ay[k].x), y1 = __float_as_int(ay[k].y);
        const long off0 = (static_cast<long>(y0) * W + x0) * 3;
        pixel_pair(frame, off0, total, aligned, x1 == x0, p[k][0], p[k][1]);
        pixel_pair(frame, off0 + static_cast<long>(y1 - y0) * W * 3, total, aligned, x1 == x0,
                   p[k][2], p[k][3]);
      }
      float v[3][2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int ch3 = 0; ch3 < 3; ++ch3) {
          const int ch = 2 - ch3;  // BGR frame, RGB crop
          const float top = __fadd_rn(__fmul_rn(byte_of(t255, p[k][0], ch), ax[k].w),
                                      __fmul_rn(byte_of(t255, p[k][1], ch), ax[k].z));
          const float bot = __fadd_rn(__fmul_rn(byte_of(t255, p[k][2], ch), ax[k].w),
                                      __fmul_rn(byte_of(t255, p[k][3], ch), ax[k].z));
          const float val = __fadd_rn(__fmul_rn(top, ay[k].w), __fmul_rn(bot, ay[k].z));
          v[ch3][k] = __fdiv_rn(__fsub_rn(val, kMean[ch3]), kStd[ch3]);
        }
      }
      Out* o = out + n * 3 * plane + static_cast<long>(i_begin + qi) * ow + j_begin + q0;
#pragma unroll
      for (int ch3 = 0; ch3 < 3; ++ch3) {
        if ((flags & kVectorStores) && q0 + 2 <= ncols) {
          Store<Out>::two(o + ch3 * plane, v[ch3]);
        } else {
          for (int k = 0; k < 2 && q0 + k < ncols; ++k)
            Store<Out>::one(o + ch3 * plane + k, v[ch3][k]);
        }
      }
    }
  }
}

template <bool kObb, typename Out>
cudaError_t launch(const unsigned char* frame, const float* boxes, const float* trig, void* out,
                   int H, int W, int N, int oh, int ow, int flags, cudaStream_t st) {
  const int col_tiles = (ow + kCols - 1) / kCols, bands = (oh + kRows - 1) / kRows;
  const dim3 grid(col_tiles * bands, N);
  crops_kernel<kObb, Out><<<grid, kThreads, 0, st>>>(frame, boxes, trig, static_cast<Out*>(out), H,
                                                     W, N, oh, ow, col_tiles, flags);
  return cudaGetLastError();
}

}  // namespace

// frame: (H, W, 3) uint8 BGR; boxes: (N, 4) xyxy or, with obb, (N, 5) xywha
// and trig (2, N) their angles' cos and sin; out: (N, 3, oh, ow), float32
// (out_dtype 0) or bf16 (1).  All contiguous, on the stream's card; out need
// not be aligned (its stores are then scalar).
extern "C" int bmt_crops(const void* frame, const void* boxes, const void* trig, void* out, int H,
                         int W, int N, int oh, int ow, int obb, int out_dtype, void* stream) {
  if (N <= 0 || oh <= 0 || ow <= 0) return static_cast<int>(cudaGetLastError());
  if (H <= 0 || W <= 0 || N > 65535 || (obb && trig == nullptr) || out_dtype < 0 ||
      out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long col_tiles = (ow + kCols - 1) / kCols, bands = (oh + kRows - 1) / kRows;
  if (col_tiles * bands > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* f = static_cast<const unsigned char*>(frame);
  const auto* b = static_cast<const float*>(boxes);
  const auto* t = static_cast<const float*>(trig);
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t store_align = out_dtype ? 4 : 8;  // two outputs
  const int flags = (reinterpret_cast<size_t>(frame) % 4 == 0 ? kFrameAligned : 0) |
                    (ow % 2 == 0 && reinterpret_cast<size_t>(out) % store_align == 0
                         ? kVectorStores
                         : 0);
  cudaError_t err;
  if (obb) {
    err = out_dtype ? launch<true, __nv_bfloat16>(f, b, t, out, H, W, N, oh, ow, flags, st)
                    : launch<true, float>(f, b, t, out, H, W, N, oh, ow, flags, st);
  } else {
    err = out_dtype ? launch<false, __nv_bfloat16>(f, b, t, out, H, W, N, oh, ow, flags, st)
                    : launch<false, float>(f, b, t, out, H, W, N, oh, ow, flags, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
