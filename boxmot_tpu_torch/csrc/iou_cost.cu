// Fused pairwise IoU + ByteTrack fused-score cost, batched over S problems.
//
// Replaces the TPU kernel boxmot_tpu/ops/pallas_kernels.py::_iou_cost_kernel
// (launched by _fused_iou_cost_pallas): from track boxes (S, K, 4) xyxy,
// detection boxes (S, D, 4) xyxy and detection confidences (S, D) it writes
// iou (S, K, D) and cost = 1 - iou * conf (S, K, D) in one pass, with no
// intermediate in device memory.  The TPU kernel took detections transposed
// as (4, D) for its lane layout; here each thread reads its own 16-byte box,
// so the natural (D, 4) layout is kept.
//
// The union is clamped at 1e-9, as in the TPU kernel.  The JAX tracker step
// uses iou_batch, which clamps at 1e-12; on the step the two agree, because
// union >= max(area_t, area_d), every detection is either a detector box or
// a unit padding box, and a clamp can only bind where both areas, and so the
// intersection, are below 1e-9: a zero intersection gives IoU 0 under
// either clamp.
//
// Bound on this card: K, D <= 256, so one call reads at most a few KB and
// writes 2 * S*K*D floats (4 MB at S = 8, 256 x 256).  It is bound by the
// launch and by the output writes, never by arithmetic.  Design: one thread
// per (track, detection) pair, with neighbouring threads on neighbouring
// detections, so the two output writes are coalesced; the box loads repeat
// across threads and are served by L1.
//
// Arithmetic must equal the plain PyTorch twin bit for bit (the cost decides
// near-ties in the auction): every operation is written with an
// explicitly rounded intrinsic, and the library is built with -fmad=false,
// so `1 - iou * conf` is never contracted into an FMA.

#include <cuda_runtime.h>

namespace {

__global__ void iou_cost_kernel(const float* __restrict__ trk,
                                const float* __restrict__ det,
                                const float* __restrict__ conf,
                                float* __restrict__ iou_out,
                                float* __restrict__ cost_out,
                                int K, int D) {
  const int s = blockIdx.y;
  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= K * D) return;
  const int k = pair / D;
  const int d = pair - k * D;

  const float4 t = reinterpret_cast<const float4*>(trk)[(size_t)s * K + k];
  const float4 b = reinterpret_cast<const float4*>(det)[(size_t)s * D + d];

  const float xx1 = fmaxf(t.x, b.x);
  const float yy1 = fmaxf(t.y, b.y);
  const float xx2 = fminf(t.z, b.z);
  const float yy2 = fminf(t.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(xx2, xx1), 0.0f),
                                fmaxf(__fsub_rn(yy2, yy1), 0.0f));
  const float area_t = __fmul_rn(__fsub_rn(t.z, t.x), __fsub_rn(t.w, t.y));
  const float area_d = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_t, area_d), inter);
  const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));

  const size_t out = (size_t)s * K * D + pair;
  iou_out[out] = iou;
  cost_out[out] = __fsub_rn(1.0f, __fmul_rn(iou, conf[(size_t)s * D + d]));
}

}  // namespace

extern "C" int bmt_iou_cost(const void* trk, const void* det, const void* conf,
                            void* iou, void* cost, int S, int K, int D,
                            void* stream) {
  if (S > 0 && K > 0 && D > 0) {
    const int threads = 256;
    const dim3 grid((K * D + threads - 1) / threads, S);
    iou_cost_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(trk), static_cast<const float*>(det),
        static_cast<const float*>(conf), static_cast<float*>(iou),
        static_cast<float*>(cost), K, D);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
