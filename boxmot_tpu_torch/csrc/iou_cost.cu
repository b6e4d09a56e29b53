// Fused pairwise IoU + ByteTrack fused-score cost, batched over S problems.
//
// Replaces the TPU kernel boxmot_tpu/ops/pallas_kernels.py::_iou_cost_kernel
// (launched by _fused_iou_cost_pallas): from track boxes (S, K, 4) xyxy,
// detection boxes (S, D, 4) xyxy and detection confidences (S, D) it writes
// iou (S, K, D) and cost = 1 - iou * conf (S, K, D) in one pass, with no
// intermediate in device memory.  In the IoU-only mode (conf and cost null,
// the tracker step's duplicate suppression) it writes iou alone.  The TPU
// kernel took detections transposed as (4, D) for its lane layout; here a
// thread reads its detections' 16-byte boxes, so the natural (D, 4) layout is
// kept.
//
// The union is clamped at `eps`, an argument: the TPU kernel clamps at 1e-9,
// the JAX tracker steps' iou_batch at 1e-12, and the two differ on boxes
// whose union is below 1e-9 (a track and a detection of 1e-5 x 1e-5 have
// IoU 1 under iou_batch and 0.1 under a 1e-9 clamp).  The tracker steps pass
// iou_batch's 1e-12; the tests that hold K1 against the TPU kernel pass
// 1e-9.
//
// Bound on this card.  On the tracker's paths K <= 256 and D <= 512: a call
// reads a few KB of boxes and writes S*K*D floats per output, 2.1 MB for
// the bench step's (8, 256, 128) IoU and cost and for its (8, 256, 256)
// IoU-only launch, 0.64 us of HBM traffic each.  An empty kernel already
// takes about 0.9 us on the card, so a launch's time is mostly fixed cost:
// the launch, the grid's scheduling and one chain of dependent latencies
// (load the boxes, compute, store).  The first design (one thread a pair,
// 256-thread blocks) paid for a grid of 1024-2048 blocks (an empty kernel of
// 2048 x 256 threads takes about 2 us), an integer division a pair, two
// scalar stores a pair, and two reloads and two area computations a pair.
// This design:
//   * one wave: the host (ops/fused_iou_cost.py::launch_geometry) gives each
//     block TK whole track rows of one problem, with TK chosen from (S, K)
//     and the card's SM count so that the S * ceil(K / TK) blocks fill the
//     SMs about once;
//   * 16-byte stores: a thread owns 4 consecutive detections of a row
//     (blockDim.x threads across a row, blockDim.y rows in flight), loads
//     their boxes and confidences once into registers, computes their areas
//     once and walks the tile's rows, storing one float4 of IoU and one of
//     cost a row; neighbouring threads write neighbouring 16-byte chunks.
//     A row with D % 4 != 0, or confidences that are not 16-byte aligned,
//     take scalar loads and stores in the same kernel;
//   * no index division: the block and thread indices give the rows and the
//     detections directly;
//   * no division for a zero intersection (most pairs): the quotient is the
//     intersection itself, and an IEEE division of 0 takes its slow path.
// Two variants were measured against this one at the bench step and are not
// kept (PERF.md, PR 4): staging the block's boxes and areas in shared memory
// (the prologue's extra store, barrier and reload cost more than the areas
// it saves), and staging the tile in shared memory for one bulk asynchronous
// copy (cp.async.bulk) per output (the staging and the copy's completion wait
// cost more than the float4 stores).
//
// Arithmetic must equal the plain PyTorch twin bit for bit (the cost decides
// near-ties in the auction): every operation is written with an
// explicitly rounded intrinsic, and the library is built with -fmad=false,
// so `1 - iou * conf` is never contracted into an FMA.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // the most threads a block has (quads * lanes)

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float pair_iou(const float4 t, const float area_t, const float4 b,
                                          const float area_d, const float eps) {
  const float xx1 = fmaxf(t.x, b.x);
  const float yy1 = fmaxf(t.y, b.y);
  const float xx2 = fminf(t.z, b.z);
  const float yy2 = fminf(t.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(xx2, xx1), 0.0f),
                                fmaxf(__fsub_rn(yy2, yy1), 0.0f));
  // a zero intersection is the quotient itself: the clamped union is at
  // least eps > 0 and never NaN
  if (inter == 0.0f) return inter;
  const float uni = __fsub_rn(__fadd_rn(area_t, area_d), inter);
  return __fdiv_rn(inter, fmaxf(uni, eps));
}

// the first n (1..4) of v to p: one float4 when kVec (then n == 4 and p is
// 16-byte aligned), else scalars
template <bool kVec>
__device__ __forceinline__ void store4(float* p, const float (&v)[4], const int n) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n) p[i] = v[i];
    }
  }
}

// grid (row_blocks, S); block (quads, lanes); block bx covers track rows
// [bx * TK, min(K, (bx + 1) * TK)) of problem blockIdx.y; thread (x, y)
// covers detections 4c .. 4c + 3 for c = x, x + quads, ... < ceil(D / 4)
// and the block's rows y, y + lanes, ...
template <bool kCost, bool kVec>
__global__ void __launch_bounds__(kThreads)
    iou_cost_kernel(const float4* __restrict__ trk, const float4* __restrict__ det,
                    const float* __restrict__ conf, float* __restrict__ iou_out,
                    float* __restrict__ cost_out, int K, int D, int TK, float eps) {
  const int s = blockIdx.y;
  const int k0 = blockIdx.x * TK;
  const int rows = min(TK, K - k0);
  const float4* trk_s = trk + static_cast<size_t>(s) * K + k0;
  const float4* det_s = det + static_cast<size_t>(s) * D;
  const float* conf_s = kCost ? conf + static_cast<size_t>(s) * D : nullptr;
  // the block's rows are one contiguous span of rows * D floats per output
  const size_t tile = (static_cast<size_t>(s) * K + k0) * D;
  float* iou_tile = iou_out + tile;
  float* cost_tile = kCost ? cost_out + tile : nullptr;

  const int quads = (D + 3) >> 2;
  for (int c = threadIdx.x; c < quads; c += blockDim.x) {
    const int d0 = 4 * c;
    const int n = min(4, D - d0);
    float4 b[4];
    float area_d[4], cf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = min(d0 + i, D - 1);  // a partial quad repeats its last box
      b[i] = det_s[j];
      area_d[i] = box_area(b[i]);
      if (kCost && !kVec) cf[i] = conf_s[j];
    }
    if (kCost && kVec) {
      const float4 c4 = *reinterpret_cast<const float4*>(conf_s + d0);
      cf[0] = c4.x;
      cf[1] = c4.y;
      cf[2] = c4.z;
      cf[3] = c4.w;
    }
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const float4 t = trk_s[r];
      const float area_t = box_area(t);
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = pair_iou(t, area_t, b[i], area_d[i], eps);
      const size_t at = static_cast<size_t>(r) * D + d0;
      store4<kVec>(iou_tile + at, v, n);
      if (kCost) {
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = __fsub_rn(1.0f, __fmul_rn(v[i], cf[i]));
        store4<kVec>(cost_tile + at, w, n);
      }
    }
  }
}

template <bool kCost>
cudaError_t launch(int vec, const dim3 grid, const dim3 block, const float4* trk,
                   const float4* det, const float* conf, float* iou, float* cost, int K, int D,
                   int TK, float eps, cudaStream_t st) {
  if (vec) {
    iou_cost_kernel<kCost, true><<<grid, block, 0, st>>>(trk, det, conf, iou, cost, K, D, TK, eps);
  } else {
    iou_cost_kernel<kCost, false><<<grid, block, 0, st>>>(trk, det, conf, iou, cost, K, D, TK, eps);
  }
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// The launch comes from ops/fused_iou_cost.py::launch_geometry: rows (TK)
// track rows per block, row_blocks = ceil(K / TK), quads x lanes threads,
// vec: float4 loads of the confidences and float4 stores (D % 4 == 0 and
// every pointer 16-byte aligned).  conf and cost both null: the IoU-only
// mode.  eps (> 0): the union clamp.
extern "C" int bmt_iou_cost(const void* trk, const void* det, const void* conf, void* iou,
                            void* cost, int S, int K, int D, int rows, int row_blocks, int quads,
                            int lanes, int vec, float eps, void* stream) {
  if (S <= 0 || K <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if (rows <= 0 || row_blocks <= 0 || static_cast<long>(rows) * row_blocks < K || quads <= 0 ||
      lanes <= 0 || quads * lanes > kThreads || S > 65535 ||
      (conf == nullptr) != (cost == nullptr) || !(eps > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(row_blocks, S);
  const dim3 block(quads, lanes);
  const auto* t = static_cast<const float4*>(trk);
  const auto* d = static_cast<const float4*>(det);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      conf ? launch<true>(vec, grid, block, t, d, static_cast<const float*>(conf),
                          static_cast<float*>(iou), static_cast<float*>(cost), K, D, rows, eps, st)
           : launch<false>(vec, grid, block, t, d, nullptr, static_cast<float*>(iou), nullptr, K,
                           D, rows, eps, st);
  return static_cast<int>(err);
}

// An empty kernel of `blocks` x `threads`, launched through the same ctypes
// path as bmt_iou_cost: its device time is the card's floor for a launch of
// that grid.
extern "C" int bmt_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
