// OC-SORT's observation-centric re-update (ORU), batched over S x K slots.
//
// Replaces the ORU block of boxmot_tpu/trackers/ocsort.py::ocsort_step (a
// lax.cond around a lax.fori_loop, lines 310-388), which has no Pallas
// kernel: a slot that rejoins (matched again after misses) restores the mean
// and covariance frozen at its first miss and replays the XYSR Kalman filter
// over measurements interpolated between its last real measurement and the
// new one, for i = 1 .. min(gap, MAX_ORU): a predict from i = 2 on, the i-th
// interpolated measurement (x, y, w, h stepped linearly, then s = w h and
// r = w / h with their clamps; for oriented boxes the angle stepped along the
// wrapped delta and the measurement aligned to the replay's own mean), the
// masked Joseph-form update and, for oriented boxes, the angular velocity
// damped x0.8.  Eager PyTorch could only bound that loop by reading the
// largest gap on the host; here one launch a step does it on the device.
//
// Design: one thread per slot.  A slot that does not rejoin copies its mean
// and covariance through and exits.  A rejoining slot keeps its mean and
// covariance in registers (spilling to local memory, which L1 caches, for
// the 9 x 9 oriented case) and runs its replay serially: the work is a chain
// of small dependent matrix products, with nothing to share between slots.
//
// Bound on this card: the bytes of the rejoining slots (each reads a frozen
// mean and covariance and writes them back, under 1 KB) and their few
// thousand operations an iteration are far below a microsecond for the
// handful of slots that rejoin in a frame; a launch's time is the launch and
// the longest slot's chain of dependent operations (ops/oru.py::oru_work
// counts the work).
//
// Arithmetic must equal the plain PyTorch twin (ops/oru.py::oru_replay_plain
// with motion/kalman.py's predict and update) bit for bit: the operations are
// theirs, in their order, each written with an explicitly rounded intrinsic
// (the library is built with -fmad=false); products with an exact zero and
// adds of an exact zero are kept where the twin has them, so signed zeros
// agree too; sqrt and log are evaluated in double and rounded once, as
// ops/geometry.py::exact does; wrap_angle is torch.remainder's floor modulo
// (fmod, then the divisor added where the signs differ); divisions are true
// divisions, never multiplies by a reciprocal.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kHalfPi = 1.57079632679489661923f;

struct Noise {
  float q[9];  // process variances (dx of them)
  float r[5];  // measurement variances (dz of them)
};

// torch.clamp_min: NaN propagates
__device__ __forceinline__ float clamp_min(const float x, const float lo) {
  return x < lo ? lo : x;
}

// the port's wrap_angle: torch.remainder(a + pi, 2 pi) - pi
__device__ __forceinline__ float wrap_angle(const float a) {
  float mod = fmodf(__fadd_rn(a, kPi), kTwoPi);
  if (mod != 0.0f && (mod < 0.0f)) mod = __fadd_rn(mod, kTwoPi);
  return __fsub_rn(mod, kPi);
}

__device__ __forceinline__ float exact_sqrt(const float x) {
  return __double2float_rn(sqrt(static_cast<double>(x)));
}

__device__ __forceinline__ float exact_log(const float x) {
  return __double2float_rn(log(static_cast<double>(x)));
}

// the velocity index of state row a, or -1 (XYSR: x, y, s have velocities,
// r has none; oriented: theta too)
template <int DX>
__device__ __forceinline__ int vel_of(const int a) {
  if (DX == 7) return a < 3 ? a + 4 : -1;
  return a < 3 ? a + 5 : (a == 4 ? 8 : -1);
}

template <int DX>
__device__ __forceinline__ void enforce(float (&m)[DX]) {
  m[2] = clamp_min(m[2], 1e-6f);
  m[3] = clamp_min(m[3], 1e-6f);
  if (DX == 9) m[4] = wrap_angle(m[4]);
}

// motion/kalman.py::predict with the XYSR transition: F x, F P F^T (rows,
// then columns, one add where F has an off-diagonal 1), the process noise on
// the diagonal (an exact zero added off it), then the mean's constraints
template <int DX>
__device__ void predict(float (&m)[DX], float (&P)[DX][DX], const Noise& nz) {
  float nm[DX];
#pragma unroll
  for (int a = 0; a < DX; ++a) {
    const int v = vel_of<DX>(a);
    nm[a] = v >= 0 ? __fadd_rn(m[a], m[v]) : m[a];
  }
  enforce<DX>(nm);
#pragma unroll
  for (int a = 0; a < DX; ++a) m[a] = nm[a];
#pragma unroll
  for (int a = 0; a < DX; ++a) {  // rows: FP = F P
    const int v = vel_of<DX>(a);
    if (v >= 0) {
#pragma unroll
      for (int c = 0; c < DX; ++c) P[a][c] = __fadd_rn(P[a][c], P[v][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < DX; ++r) {  // columns: (F P) F^T, then the noise
#pragma unroll
    for (int a = 0; a < DX; ++a) {
      const int v = vel_of<DX>(a);
      const float x = v >= 0 ? __fadd_rn(P[r][a], P[r][v]) : P[r][a];
      P[r][a] = x;
    }
  }
#pragma unroll
  for (int r = 0; r < DX; ++r) {
#pragma unroll
    for (int a = 0; a < DX; ++a) P[r][a] = __fadd_rn(P[r][a], r == a ? nz.q[a] : 0.0f);
  }
}

// motion/kalman.py::update: the unrolled Cholesky of S = P[:dz, :dz] + R, its
// inverse M = L^-1 and Sinv = M^T M (summed over every k, zeros included),
// the gain, the mean, and P = (I - K H) P (I - K H)^T + K R K^T
template <int DX, int DZ>
__device__ void update(float (&m)[DX], float (&P)[DX][DX], const float (&z)[DZ],
                       const Noise& nz) {
  float L[DZ][DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = __fadd_rn(P[i][j], i == j ? nz.r[i] : 0.0f);
#pragma unroll
      for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], L[j][k]));
      L[i][j] = i == j ? exact_sqrt(clamp_min(s, 1e-9f)) : __fdiv_rn(s, L[j][j]);
    }
  }
  float M[DZ][DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
#pragma unroll
    for (int j = 0; j < DZ; ++j) M[i][j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    M[i][i] = __frcp_rn(L[i][i]);
#pragma unroll
    for (int j = 0; j < i; ++j) {
      float s = __fmul_rn(L[i][j], M[j][j]);
#pragma unroll
      for (int k = j + 1; k < i; ++k) s = __fadd_rn(s, __fmul_rn(L[i][k], M[k][j]));
      M[i][j] = __fdiv_rn(-s, L[i][i]);
    }
  }
  float Si[DZ][DZ];
#pragma unroll
  for (int a = 0; a < DZ; ++a) {
#pragma unroll
    for (int b = 0; b < DZ; ++b) {
      float s = __fmul_rn(M[0][a], M[0][b]);
#pragma unroll
      for (int k = 1; k < DZ; ++k) s = __fadd_rn(s, __fmul_rn(M[k][a], M[k][b]));
      Si[a][b] = s;
    }
  }
  float G[DX][DZ];
#pragma unroll
  for (int a = 0; a < DX; ++a) {
#pragma unroll
    for (int c = 0; c < DZ; ++c) {
      float s = __fmul_rn(P[a][0], Si[0][c]);
#pragma unroll
      for (int d = 1; d < DZ; ++d) s = __fadd_rn(s, __fmul_rn(P[a][d], Si[d][c]));
      G[a][c] = s;
    }
  }
  float innov[DZ];
#pragma unroll
  for (int c = 0; c < DZ; ++c) innov[c] = __fsub_rn(z[c], m[c]);
#pragma unroll
  for (int a = 0; a < DX; ++a) {
    float delta = __fmul_rn(innov[0], G[a][0]);
#pragma unroll
    for (int c = 1; c < DZ; ++c) delta = __fadd_rn(delta, __fmul_rn(innov[c], G[a][c]));
    m[a] = __fadd_rn(m[a], delta);
  }
  enforce<DX>(m);

  // A = I - K H: A[a][b] = eye - G[a][b] for b < dz, eye beyond
  float A[DX][DX];
#pragma unroll
  for (int a = 0; a < DX; ++a) {
#pragma unroll
    for (int b = 0; b < DX; ++b) {
      const float eye = a == b ? 1.0f : 0.0f;
      A[a][b] = b < DZ ? __fsub_rn(eye, G[a][b < DZ ? b : 0]) : eye;
    }
  }
  float AP[DX][DX];
#pragma unroll
  for (int a = 0; a < DX; ++a) {
#pragma unroll
    for (int c = 0; c < DX; ++c) {
      float s = __fmul_rn(A[a][0], P[0][c]);
#pragma unroll
      for (int b = 1; b < DX; ++b) s = __fadd_rn(s, __fmul_rn(A[a][b], P[b][c]));
      AP[a][c] = s;
    }
  }
#pragma unroll
  for (int a = 0; a < DX; ++a) {
#pragma unroll
    for (int b = 0; b < DX; ++b) {
      float s = __fmul_rn(AP[a][0], A[b][0]);
#pragma unroll
      for (int c = 1; c < DX; ++c) s = __fadd_rn(s, __fmul_rn(AP[a][c], A[b][c]));
      float krk = __fmul_rn(__fmul_rn(G[a][0], nz.r[0]), G[b][0]);
#pragma unroll
      for (int c = 1; c < DZ; ++c)
        krk = __fadd_rn(krk, __fmul_rn(__fmul_rn(G[a][c], nz.r[c]), G[b][c]));
      P[a][b] = __fadd_rn(s, krk);
    }
  }
}

// motion/kalman.py::align_obb_xysr against the replay's mean: of (s, r, th),
// (s, r, th + pi), (s, 1/r, th + pi/2), (s, 1/r, th - pi/2), the first with
// the least |wrapped angle delta| + 0.05 |log(r / ref_r)|
__device__ void align_obb_xysr(float (&z)[5], const float (&m)[9]) {
  const float r = clamp_min(z[3], 1e-6f);
  const float th = wrap_angle(z[4]);
  const float ref_r = clamp_min(m[3], 1e-6f);
  const float ref_th = m[4];
  const float inv_r = __frcp_rn(r);
  const float cand_r[4] = {r, r, inv_r, inv_r};
  const float cand_t[4] = {th, __fadd_rn(th, kPi), __fadd_rn(th, kHalfPi),
                           __fsub_rn(th, kHalfPi)};
  int best = 0;
  float best_cost = 0.0f, best_t = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float aligned = __fadd_rn(ref_th, wrap_angle(__fsub_rn(cand_t[c], ref_th)));
    const float angle_cost = fabsf(__fsub_rn(aligned, ref_th));
    const float size_cost = fabsf(exact_log(__fdiv_rn(cand_r[c], ref_r)));
    const float cost = __fadd_rn(angle_cost, __fmul_rn(0.05f, size_cost));
    if (c == 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
      best_t = aligned;
    }
  }
  z[2] = clamp_min(z[2], 1e-6f);
  z[3] = clamp_min(cand_r[best], 1e-6f);
  z[4] = best_t;
}

// w = sqrt(max(s r, 1e-12)), h = sqrt(max(s / max(r, 1e-12), 1e-12))
__device__ __forceinline__ void meas_wh(const float s, const float r, float& w, float& h) {
  w = exact_sqrt(clamp_min(__fmul_rn(s, r), 1e-12f));
  h = exact_sqrt(clamp_min(__fdiv_rn(s, clamp_min(r, 1e-12f)), 1e-12f));
}

template <int DX, int DZ>
__global__ void __launch_bounds__(kThreads)
    oru_kernel(const float* __restrict__ mean_in, const float* __restrict__ cov_in,
               const float* __restrict__ frozen_mean, const float* __restrict__ frozen_cov,
               const float* __restrict__ last_meas, const float* __restrict__ z2,
               const bool* __restrict__ rejoin, const int* __restrict__ gap,
               float* __restrict__ mean_out, float* __restrict__ cov_out,
               int* __restrict__ replayed, const Noise nz, int S, int K, int max_oru) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= S * K) return;
  const size_t mo = static_cast<size_t>(slot) * DX;
  const size_t co = static_cast<size_t>(slot) * DX * DX;
  if (!rejoin[slot]) {
#pragma unroll
    for (int a = 0; a < DX; ++a) mean_out[mo + a] = mean_in[mo + a];
    for (int e = 0; e < DX * DX; ++e) cov_out[co + e] = cov_in[co + e];
    return;
  }
  float m[DX], P[DX][DX], m1[DZ], zz[DZ];
#pragma unroll
  for (int a = 0; a < DX; ++a) m[a] = frozen_mean[mo + a];
#pragma unroll
  for (int a = 0; a < DX; ++a) {
#pragma unroll
    for (int b = 0; b < DX; ++b) P[a][b] = frozen_cov[co + a * DX + b];
  }
#pragma unroll
  for (int c = 0; c < DZ; ++c) {
    m1[c] = last_meas[static_cast<size_t>(slot) * DZ + c];
    zz[c] = z2[static_cast<size_t>(slot) * DZ + c];
  }
  const int g = gap[slot];
  float w1, h1, w2, h2;
  meas_wh(m1[2], m1[3], w1, h1);
  meas_wh(zz[2], zz[3], w2, h2);
  const float gapf = clamp_min(static_cast<float>(g), 1.0f);
  const float dx = __fdiv_rn(__fsub_rn(zz[0], m1[0]), gapf);
  const float dy = __fdiv_rn(__fsub_rn(zz[1], m1[1]), gapf);
  const float dw = __fdiv_rn(__fsub_rn(w2, w1), gapf);
  const float dh = __fdiv_rn(__fsub_rn(h2, h1), gapf);
  const float dth = DZ == 5 ? __fdiv_rn(wrap_angle(__fsub_rn(zz[DZ - 1], m1[DZ - 1])), gapf) : 0.0f;
  const int n = min(g, max_oru);
  for (int i = 1; i <= n; ++i) {
    if (i > 1) predict<DX>(m, P, nz);
    const float fi = static_cast<float>(i);
    const float wi = __fadd_rn(w1, __fmul_rn(fi, dw));
    const float hi = __fadd_rn(h1, __fmul_rn(fi, dh));
    float zi[DZ];
    zi[0] = __fadd_rn(m1[0], __fmul_rn(fi, dx));
    zi[1] = __fadd_rn(m1[1], __fmul_rn(fi, dy));
    zi[2] = clamp_min(__fmul_rn(wi, hi), 1e-6f);
    zi[3] = clamp_min(__fdiv_rn(wi, clamp_min(hi, 1e-12f)), 1e-6f);
    if constexpr (DZ == 5) {
      zi[4] = wrap_angle(__fadd_rn(m1[4], __fmul_rn(fi, dth)));
      align_obb_xysr(zi, m);
    }
    update<DX, DZ>(m, P, zi, nz);
    if constexpr (DX == 9) m[8] = __fmul_rn(m[8], 0.8f);
  }
#pragma unroll
  for (int a = 0; a < DX; ++a) mean_out[mo + a] = m[a];
#pragma unroll
  for (int a = 0; a < DX; ++a) {
#pragma unroll
    for (int b = 0; b < DX; ++b) cov_out[co + a * DX + b] = P[a][b];
  }
  atomicAdd(replayed + slot / K, 1);
}

}  // namespace

// One launch over the S x K slots: mean_in/cov_in (S, K, dx[, dx]) after the
// frame's predict, frozen_mean/frozen_cov likewise, last_meas and z2
// (S, K, dz), rejoin (S, K) bool, gap (S, K) int32; writes mean_out/cov_out
// and adds each sequence's rejoining slots to replayed (S,) int32.  noise:
// a host array of the dx process variances, then the dz measurement ones.
// obb: 0 for the 7-state XYSR filter, 1 for the 9-state oriented one.
extern "C" int bmt_oru(const void* mean_in, const void* cov_in, const void* frozen_mean,
                       const void* frozen_cov, const void* last_meas, const void* z2,
                       const void* rejoin, const void* gap, void* mean_out, void* cov_out,
                       void* replayed, const float* noise, int S, int K, int obb, int max_oru,
                       void* stream) {
  if (S <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (noise == nullptr || max_oru < 0 || static_cast<long>(S) * K > (1L << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dx = obb ? 9 : 7;
  const int dz = obb ? 5 : 4;
  Noise nz{};
  for (int i = 0; i < dx; ++i) nz.q[i] = noise[i];
  for (int i = 0; i < dz; ++i) nz.r[i] = noise[dx + i];
  const int blocks = (S * K + kThreads - 1) / kThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* mi = static_cast<const float*>(mean_in);
  const auto* ci = static_cast<const float*>(cov_in);
  const auto* fm = static_cast<const float*>(frozen_mean);
  const auto* fc = static_cast<const float*>(frozen_cov);
  const auto* lm = static_cast<const float*>(last_meas);
  const auto* zz = static_cast<const float*>(z2);
  const auto* rj = static_cast<const bool*>(rejoin);
  const auto* gp = static_cast<const int*>(gap);
  auto* mo = static_cast<float*>(mean_out);
  auto* co = static_cast<float*>(cov_out);
  auto* rp = static_cast<int*>(replayed);
  if (obb) {
    oru_kernel<9, 5><<<blocks, kThreads, 0, st>>>(mi, ci, fm, fc, lm, zz, rj, gp, mo, co, rp, nz,
                                                  S, K, max_oru);
  } else {
    oru_kernel<7, 4><<<blocks, kThreads, 0, st>>>(mi, ci, fm, fc, lm, zz, rj, gp, mo, co, rp, nz,
                                                  S, K, max_oru);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
