// ReID crops: crop, resize and standardize boxes of a uint8 BGR frame into
// the backbone's (N, 3, oh, ow) input, in one launch.
//
// Replaces boxmot_tpu/ops/crops.py::extract_crops with crop_resize_aabb,
// crop_resize_obb and standardize (no Pallas kernel: on the TPU the
// axis-aligned resize runs as two fp32 products with dense (N, oh, H) and
// (N, ow, W) interpolation matrices at HIGHEST precision, because a gather
// costs about a millisecond a crop there; at 64 crops of a 1080p frame those
// products do about 115 GFLOP, all but two terms of every sum zero).  Here a
// gather is cheap, so a thread computes one output pixel (n, i, j): it maps
// (i, j) to its source coordinates, reads the four taps of each channel from
// the frame (BGR, read as RGB: output channel c reads frame channel 2 - c),
// divides them by 255, interpolates horizontally then vertically, subtracts
// the ImageNet mean, divides by the ImageNet std and stores the three
// channels, fp32 or rounded to bf16.
//
// Bound on this card: bytes.  A call reads the frame (H * W * 3 bytes, 6.2
// MB at 1080p) and the boxes, and writes N * 3 * oh * ow outputs: at 64
// crops of 256 x 128 in fp32, 25.2 MB, about 9.4 us at 3.35 TB/s.  The
// arithmetic (some 60 flops a pixel) is far below the card's rate.  This
// first design takes the simplest layout that writes coalesced: a block of
// 32 x 8 threads covers 32 columns of 8 rows of one crop, so neighbouring
// threads store neighbouring floats of each channel plane; the taps are
// scattered byte reads that the L1 and L2 caches serve (a crop's taps lie
// within its box).
//
// Arithmetic equals the plain twin (ops/crops.py::extract_crops_plain) bit
// for bit: every operation is an explicitly rounded intrinsic in the twin's
// order, divisions are true divisions (never by a reciprocal), the library
// is built with -fmad=false, and a rotated box's cos and sin come from the
// wrapper (float64, rounded once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;  // output columns a block covers
constexpr int kBlockY = 8;   // output rows a block covers
__constant__ float kMean[3] = {0.485f, 0.456f, 0.406f};
__constant__ float kStd[3] = {0.229f, 0.224f, 0.225f};

// Clamped-bilinear taps on one axis: c0, c1 and the weight of c1.
struct Axis {
  int c0, c1;
  float w;
};

__device__ __forceinline__ Axis axis_taps(float g, int size) {
  const float hi = static_cast<float>(size - 1);
  const float c = fminf(fmaxf(g, 0.0f), hi);
  const float c0 = floorf(c);
  const float c1 = fminf(__fadd_rn(c0, 1.0f), hi);
  return {static_cast<int>(c0), static_cast<int>(c1), __fsub_rn(c, c0)};
}

__device__ __forceinline__ float tap(const unsigned char* frame, int W, int y, int x, int ch) {
  const float v = static_cast<float>(frame[(static_cast<long>(y) * W + x) * 3 + ch]);
  return __fdiv_rn(v, 255.0f);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// boxes: (N, 4) xyxy, or (N, 5) xywha with trig (2, N): cos then sin.
template <bool kObb, typename Out>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    crops_kernel(const unsigned char* __restrict__ frame, const float* __restrict__ boxes,
                 const float* __restrict__ trig, Out* __restrict__ out, int H, int W, int N, int oh,
                 int ow) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int n = blockIdx.z;
  if (i >= oh || j >= ow) return;
  const float fi = __fadd_rn(static_cast<float>(i), 0.5f);
  const float fj = __fadd_rn(static_cast<float>(j), 0.5f);
  Axis ay, ax;
  if (kObb) {
    const float* b = boxes + n * 5;
    const float ca = trig[n], sa = trig[N + n];
    const float u = __fmul_rn(__fsub_rn(__fdiv_rn(fj, static_cast<float>(ow)), 0.5f), b[2]);
    const float v = __fmul_rn(__fsub_rn(__fdiv_rn(fi, static_cast<float>(oh)), 0.5f), b[3]);
    const float xs =
        __fsub_rn(__fsub_rn(__fadd_rn(b[0], __fmul_rn(u, ca)), __fmul_rn(v, sa)), 0.5f);
    const float ys =
        __fsub_rn(__fadd_rn(__fadd_rn(b[1], __fmul_rn(u, sa)), __fmul_rn(v, ca)), 0.5f);
    ay = axis_taps(ys, H);
    ax = axis_taps(xs, W);
  } else {
    const float* b = boxes + n * 4;
    const float sy = __fdiv_rn(__fsub_rn(b[3], b[1]), static_cast<float>(oh));
    const float sx = __fdiv_rn(__fsub_rn(b[2], b[0]), static_cast<float>(ow));
    ay = axis_taps(__fadd_rn(__fmul_rn(fi, sy), __fsub_rn(b[1], 0.5f)), H);
    ax = axis_taps(__fadd_rn(__fmul_rn(fj, sx), __fsub_rn(b[0], 0.5f)), W);
  }
  const float rx = __fsub_rn(1.0f, ax.w), ry = __fsub_rn(1.0f, ay.w);
  const long plane = static_cast<long>(oh) * ow;
  Out* o = out + n * 3 * plane + static_cast<long>(i) * ow + j;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int ch = 2 - c;  // BGR frame, RGB crop
    const float top = __fadd_rn(__fmul_rn(tap(frame, W, ay.c0, ax.c0, ch), rx),
                                __fmul_rn(tap(frame, W, ay.c0, ax.c1, ch), ax.w));
    const float bot = __fadd_rn(__fmul_rn(tap(frame, W, ay.c1, ax.c0, ch), rx),
                                __fmul_rn(tap(frame, W, ay.c1, ax.c1, ch), ax.w));
    const float val = __fadd_rn(__fmul_rn(top, ry), __fmul_rn(bot, ay.w));
    store(o + c * plane, __fdiv_rn(__fsub_rn(val, kMean[c]), kStd[c]));
  }
}

template <bool kObb, typename Out>
cudaError_t launch(const unsigned char* frame, const float* boxes, const float* trig, void* out,
                   int H, int W, int N, int oh, int ow, cudaStream_t st) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ow + kBlockX - 1) / kBlockX, (oh + kBlockY - 1) / kBlockY, N);
  crops_kernel<kObb, Out><<<grid, block, 0, st>>>(frame, boxes, trig, static_cast<Out*>(out), H,
                                                  W, N, oh, ow);
  return cudaGetLastError();
}

}  // namespace

// frame: (H, W, 3) uint8 BGR; boxes: (N, 4) xyxy or, with obb, (N, 5) xywha
// and trig (2, N) their angles' cos and sin; out: (N, 3, oh, ow), float32
// (out_dtype 0) or bf16 (1).  All contiguous, on the stream's card.
extern "C" int bmt_crops(const void* frame, const void* boxes, const void* trig, void* out, int H,
                         int W, int N, int oh, int ow, int obb, int out_dtype, void* stream) {
  if (N <= 0 || oh <= 0 || ow <= 0) return static_cast<int>(cudaGetLastError());
  if (H <= 0 || W <= 0 || N > 65535 || (obb && trig == nullptr) || out_dtype < 0 ||
      out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f = static_cast<const unsigned char*>(frame);
  const auto* b = static_cast<const float*>(boxes);
  const auto* t = static_cast<const float*>(trig);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (obb) {
    err = out_dtype ? launch<true, __nv_bfloat16>(f, b, t, out, H, W, N, oh, ow, st)
                    : launch<true, float>(f, b, t, out, H, W, N, oh, ow, st);
  } else {
    err = out_dtype ? launch<false, __nv_bfloat16>(f, b, t, out, H, W, N, oh, ow, st)
                    : launch<false, float>(f, b, t, out, H, W, N, oh, ow, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
