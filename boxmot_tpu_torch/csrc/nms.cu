// Greedy non-maximum suppression (kernel K6): the detector's NMS in one
// launch, with no host read of the loop's condition.
//
// Replaces boxmot_tpu/ops/nms.py::nms (no Pallas kernel: a lax.while_loop
// over a dense N x N IoU matrix, 2.2 GB at YOLOX's N = 23,625 anchors of an
// 800 x 1440 input).  Semantics, equal bit for bit to the plain twin
// (ops/nms.py::nms_plain) and to the JAX loop:
//   * alive = score > 0 (a NaN, -inf or non-positive score is never kept);
//   * each step keeps the first index of the largest alive score (a tie goes
//     to the lowest index, as argmax does), then drops the kept box and every
//     alive box whose IoU with it is > iou_thresh (strictly greater);
//   * it stops when no box is alive or max_out boxes are kept;
//   * keep_idx (max_out,) int32 is padded with -1, keep_mask (max_out,) says
//     which entries are kept.
// The IoU is ops/iou.py::iou_batch(kept, candidate) with its float operations
// in its order (explicitly rounded intrinsics, -fmad=false) and the union
// clamped at 1e-12.  NaN propagates as in PyTorch: torch.maximum,
// torch.minimum and clamp_min keep a NaN where fmaxf and fminf would drop it,
// so a box with a NaN coordinate gets a NaN IoU, which suppresses nothing.
//
// Design (the literal loop).  One block of 1024 threads.  Thread t owns the
// indices t, t + 1024, t + 2048, ...: their alive bits sit in shared memory as
// words that only thread t reads or writes (word w of thread t holds its
// indices 32 w .. 32 w + 31), so no bit is shared between threads.  A step:
//   1. each thread walks its alive bits and takes the largest score (its
//      indices rise, so a strict > keeps the lowest index of a tie);
//   2. a warp reduction on the key (score, -index), then one over the warps'
//      winners in shared memory: two barriers a step;
//   3. every thread tests its alive indices against the winner's box (read
//      once, a broadcast) and clears the bits the winner suppresses.
// The dense N x N matrix is never formed: a step evaluates one IoU per alive
// candidate.
//
// Bound on this card.  A call must read the boxes and scores (N x 20 bytes,
// 0.47 MB at N = 23,625, 0.14 us at 3.35 TB/s) and write max_out x 5 bytes;
// its arithmetic is the IoUs the steps evaluate (about 17 flops each), far
// below the card's rate.  The loop is sequential: up to max_out dependent
// steps, each a scan, two block barriers and a round of IoUs, so the kernel
// is bound by the latency of its steps on one SM, far from that bound.  A
// sorted scan over many blocks (ROADMAP Queue B) is the later redesign.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kUnionEps = 1e-12f;  // iou_batch's clamp

// PyTorch's NaN-propagating maximum, minimum and clamp_min.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fminf(a, b);
}

// iou_batch(a, b) for one pair: a is the kept box (boxes1), b the candidate.
__device__ __forceinline__ float pair_iou(const float4 a, const float4 b) {
  const float xx1 = max_nan(a.x, b.x);
  const float yy1 = max_nan(a.y, b.y);
  const float xx2 = min_nan(a.z, b.z);
  const float yy2 = min_nan(a.w, b.w);
  const float wh =
      __fmul_rn(max_nan(__fsub_rn(xx2, xx1), 0.0f), max_nan(__fsub_rn(yy2, yy1), 0.0f));
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), wh);
  return __fdiv_rn(wh, max_nan(uni, kUnionEps));
}

// (s, i) replaces (bs, bi) when its score is larger, or equal at a lower index.
__device__ __forceinline__ void better(float s, int i, float& bs, int& bi) {
  if (s > bs || (s == bs && i < bi)) {
    bs = s;
    bi = i;
  }
}

__global__ void __launch_bounds__(kThreads)
    nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, int N,
               int words, float iou_thresh, int max_out, int* __restrict__ keep_idx,
               unsigned char* __restrict__ keep_mask, unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned alive[];  // [words][kThreads]
  __shared__ float warp_s[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float best_s;
  __shared__ int best_i;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (int j = t; j < max_out; j += kThreads) {
    keep_idx[j] = -1;
    keep_mask[j] = 0;
  }
  for (int w = 0; w < words; ++w) {
    unsigned bits = 0;
    for (int b = 0; b < 32; ++b) {
      const long i = t + static_cast<long>(w * 32 + b) * kThreads;
      if (i < N && scores[i] > 0.0f) bits |= 1u << b;
    }
    alive[w * kThreads + t] = bits;
  }
  __syncthreads();

  unsigned long long n_iou = 0;
  for (int n = 0; n < max_out; ++n) {
    // 1. this thread's best alive score
    float bs = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int w = 0; w < words; ++w) {
      unsigned bits = alive[w * kThreads + t];
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        const int i = t + (w * 32 + b) * kThreads;
        const float s = scores[i];
        if (s > bs) {
          bs = s;
          bi = i;
        }
      }
    }
    // 2. the block's best: warps, then the warps' winners
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      better(os, oi, bs, bi);
    }
    if (lane == 0) {
      warp_s[warp] = bs;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = warp_s[lane];
      bi = warp_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        better(os, oi, bs, bi);
      }
      if (lane == 0) {
        best_s = bs;
        best_i = bi;
        if (bs > 0.0f) {
          keep_idx[n] = bi;
          keep_mask[n] = 1;
        }
      }
    }
    __syncthreads();
    if (!(best_s > 0.0f)) break;  // nothing alive: every thread leaves together
    // 3. drop the kept box and the alive boxes it suppresses
    const int k = best_i;
    const float4 kept = boxes[k];
    for (int w = 0; w < words; ++w) {
      unsigned bits = alive[w * kThreads + t], keep = bits;
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        const int i = t + (w * 32 + b) * kThreads;
        if (i == k) {
          keep &= ~(1u << b);
          continue;
        }
        ++n_iou;
        if (pair_iou(kept, boxes[i]) > iou_thresh) keep &= ~(1u << b);
      }
      alive[w * kThreads + t] = keep;
    }
  }
  if (counts != nullptr) atomicAdd(counts, n_iou);
}

}  // namespace

// boxes: (N, 4) float32 xyxy, 16-byte aligned; scores: (N,) float32;
// keep_idx: (max_out,) int32; keep_mask: (max_out,) bool (one byte each);
// counts: null, or one uint64 to which the IoUs evaluated are added.  All
// contiguous, on the stream's card.
extern "C" int bmt_nms(const void* boxes, const void* scores, int N, float iou_thresh,
                       int max_out, void* keep_idx, void* keep_mask, void* counts, void* stream) {
  if (N < 0 || max_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (max_out == 0) return static_cast<int>(cudaGetLastError());
  const int per_thread = (N + kThreads - 1) / kThreads;
  const int words = (per_thread + 31) / 32;
  const size_t smem = static_cast<size_t>(words) * kThreads * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), N, words, iou_thresh,
      max_out, static_cast<int*>(keep_idx), static_cast<unsigned char*>(keep_mask),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
