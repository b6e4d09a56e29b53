// Pairwise rotated-rectangle IoU, batched over S problems.
//
// Replaces the TPU kernel boxmot_tpu/ops/pallas_rotated_iou.py::_iou_obb_kernel
// (launched by _rotated_iou_pallas_padded, with _clip_stage for each clip), and
// the jnp clip boxmot_tpu/ops/rotated_iou.py::iou_batch_obb that the JAX
// tracker steps run at tracker sizes.  From boxes (S, N, 5) and (S, M, 5) xywha
// and their corners (S, N, 4, 2) and (S, M, 4, 2), computed once per box by the
// wrapper, it writes iou (S, N, M).  Each pair is centred on the mean of the
// two boxes' (cx, cy), as in the jnp clip (the Pallas kernel centres on the
// diagonal midpoints instead, and agrees with it only to 1e-5); the subject
// polygon (box 1) is clipped by the four edges of box 2 (Sutherland-Hodgman),
// and the area is the shoelace sum; a union <= 0 gives 0.
//
// Bound on this card: per-pair serial ALU work with data-dependent control
// flow, and the registers and local memory that a vertex list takes.  Bytes
// are few: 13 floats in per box, one float out per pair.
//
// Design: one thread per pair, neighbouring threads on neighbouring columns,
// so the output write is coalesced and the row box is shared by the block.
// The TPU versions carry 4 -> 8 -> 16 -> 32 -> 64 duplicate-padded vertex
// slots per pair, because XLA and Pallas need static shapes.  Here each
// thread keeps a compact list of the vertices Sutherland-Hodgman emits.  A
// padded duplicate is neutral to the geometry: it has the inside flag of its
// original, so it emits no crossing, and it adds x*y - x*y, an exact 0 without
// FMA, to the shoelace sum.  What the padding does change is where the
// cyclic list starts: when slot 0 of the padded list holds a copy of the last
// vertex ("lead"), the padded clip meets the list's closing edge first, and
// the padded shoelace sum adds the closing term first.  The kernel tracks
// that flag, and whether padded slots 0 and 1 hold different vertices, from
// stage to stage, and walks its edges in the padded order; so it adds the
// same nonzero terms in the same order as the plain twin (ops/rotated_iou.py),
// which sums its padded slots one at a time in slot order.  Every operation
// is an explicitly rounded intrinsic and the library is built with
// -fmad=false, so the kernel equals the twin bit for bit.
//
// The list bound: each clip emits at most two vertices per input edge, so the
// list holds at most 4 * 2^4 = 64 vertices, the padded scheme's own bound,
// however rounding bends a sliver.  The two lists and the side values live in
// local memory (1.3 KB a thread), cached in L1; on real boxes a list holds at
// most 8 vertices.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxVerts = 64;
constexpr int kThreads = 128;

__device__ __forceinline__ float cross_term(float xa, float ya, float xb, float yb) {
  return __fsub_rn(__fmul_rn(xa, yb), __fmul_rn(xb, ya));
}

__global__ void __launch_bounds__(kThreads)
rotated_iou_kernel(const float* __restrict__ b1, const float4* __restrict__ c1,
                   const float* __restrict__ b2, const float4* __restrict__ c2,
                   float* __restrict__ out, int N, int M) {
  const int s = blockIdx.z;
  const int i = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= M) return;
  const size_t r1 = (size_t)s * N + i;
  const size_t r2 = (size_t)s * M + j;
  const float* o1 = b1 + r1 * 5;
  const float* o2 = b2 + r2 * 5;
  const float4 p1a = c1[r1 * 2], p1b = c1[r1 * 2 + 1];
  const float4 p2a = c2[r2 * 2], p2b = c2[r2 * 2 + 1];
  const float ax[4] = {p1a.x, p1a.z, p1b.x, p1b.z}, ay[4] = {p1a.y, p1a.w, p1b.y, p1b.w};
  const float bx[4] = {p2a.x, p2a.z, p2b.x, p2b.z}, by[4] = {p2a.y, p2a.w, p2b.y, p2b.w};

  const float ox = __fdiv_rn(__fadd_rn(o1[0], o2[0]), 2.0f);
  const float oy = __fdiv_rn(__fadd_rn(o1[1], o2[1]), 2.0f);

  // winding of the clip polygon, from its uncentred corners
  float wind = 0.0f;
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) & 3;
    wind = __fadd_rn(wind, cross_term(bx[k], by[k], bx[kn], by[kn]));
  }
  const float orient = __fmul_rn(0.5f, wind) >= 0.0f ? 1.0f : -1.0f;

  float ex[4], ey[4];
  float vx[2][kMaxVerts], vy[2][kMaxVerts], side[kMaxVerts];
  for (int k = 0; k < 4; ++k) {
    ex[k] = __fsub_rn(bx[k], ox);
    ey[k] = __fsub_rn(by[k], oy);
    vx[0][k] = __fsub_rn(ax[k], ox);
    vy[0][k] = __fsub_rn(ay[k], oy);
  }
  int cur = 0, n = 4;
  bool lead = false;  // padded slot 0 holds a copy of the list's last vertex
  bool split = true;  // padded slots 0 and 1 hold different vertices

  for (int k = 0; k < 4 && n > 0; ++k) {
    const int kn = (k + 1) & 3;
    const float dx = __fsub_rn(ex[kn], ex[k]);
    const float dy = __fsub_rn(ey[kn], ey[k]);
    const float* x = vx[cur];
    const float* y = vy[cur];
    float* nx = vx[cur ^ 1];
    float* ny = vy[cur ^ 1];
    for (int q = 0; q < n; ++q) {
      side[q] = __fmul_rn(__fsub_rn(__fmul_rn(dx, __fsub_rn(y[q], ey[k])),
                                    __fmul_rn(dy, __fsub_rn(x[q], ex[k]))), orient);
    }
    int m = 0;
    bool s0 = false, s1 = false;
    for (int q = 0; q < n; ++q) {
      // the padded clip meets the closing edge first when `lead`
      const int a = lead ? (q == 0 ? n - 1 : q - 1) : q;
      const int b = a + 1 == n ? 0 : a + 1;
      const bool in_a = side[a] >= 0.0f, in_b = side[b] >= 0.0f;
      if (in_a != in_b) {
        const float denom = __fsub_rn(side[a], side[b]);
        const float t = __fdiv_rn(side[a], fabsf(denom) < 1e-30f ? 1e-30f : denom);
        nx[m] = __fadd_rn(x[a], __fmul_rn(t, __fsub_rn(x[b], x[a])));
        ny[m] = __fadd_rn(y[a], __fmul_rn(t, __fsub_rn(y[b], y[a])));
        ++m;
      }
      if (in_b) {
        nx[m] = x[b];
        ny[m] = y[b];
        ++m;
      }
      if (q == 0) {
        // padded output slot 0: the crossing of padded edge 0, which is this
        // edge when padded slots 0 and 1 differ; slot 1: padded slot 1 if inside
        s0 = split && in_a != in_b;
        s1 = split ? in_b : in_a;
      }
    }
    lead = !s0;
    split = s0 ? s1 : (s1 && split);
    n = m;
    cur ^= 1;
  }

  float inter = 0.0f;
  if (n > 0) {
    const float* x = vx[cur];
    const float* y = vy[cur];
    float acc = 0.0f;
    if (lead) acc = __fadd_rn(acc, cross_term(x[n - 1], y[n - 1], x[0], y[0]));
    for (int q = 0; q < (lead ? n - 1 : n); ++q) {
      const int b = q + 1 == n ? 0 : q + 1;
      acc = __fadd_rn(acc, cross_term(x[q], y[q], x[b], y[b]));
    }
    inter = __fmul_rn(0.5f, fabsf(acc));
  }
  const float uni = __fsub_rn(__fadd_rn(__fmul_rn(o1[2], o1[3]), __fmul_rn(o2[2], o2[3])), inter);
  out[r1 * M + j] = uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

}  // namespace

extern "C" int bmt_rotated_iou(const void* b1, const void* c1, const void* b2, const void* c2,
                               void* out, int S, int N, int M, void* stream) {
  if (N > 65535 || S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0 && N > 0 && M > 0) {
    const dim3 grid((M + kThreads - 1) / kThreads, N, S);
    rotated_iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(b1), static_cast<const float4*>(c1),
        static_cast<const float*>(b2), static_cast<const float4*>(c2),
        static_cast<float*>(out), N, M);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
