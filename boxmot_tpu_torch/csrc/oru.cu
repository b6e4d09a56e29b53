// The observation-centric re-update (ORU), batched over S x K slots.
//
// Replaces the ORU block of boxmot_tpu/trackers/ocsort.py::ocsort_step (a
// lax.cond around a lax.fori_loop, lines 310-391), repeated in
// deepocsort.py and, over the XYSCR filter, in hybridsort.py (lines
// 339-388); none has a Pallas kernel.  A slot that rejoins (matched again
// after misses) restores the mean and covariance frozen at its first miss
// and replays the Kalman filter over measurements interpolated between its
// last real measurement and the new one, for i = 1 .. min(gap, MAX_ORU): a
// predict from i = 2 on, the i-th interpolated measurement (x, y, w, h
// stepped linearly, w and h from s and r, then s = w h and r = w / h with
// their clamps; for oriented boxes the angle stepped along the wrapped delta
// and the measurement aligned to the replay's own mean; for XYSCR the
// confidence c stepped linearly), the masked Joseph-form update and, for
// oriented boxes, the angular velocity damped x0.8.  Eager PyTorch could
// only bound that loop by reading the largest gap on the host; here one
// launch a step does it on the device.
//
// Three layouts, a template tag each (ops/oru.py::LAYOUT_TAGS): XYSR, the
// 7-state [x, y, s, r, vx, vy, vs]; XYSR_OBB, the 9-state [x, y, s, r,
// theta, vx, vy, vs, vtheta]; XYSCR, HybridSORT's 9-state [x, y, s, c, r,
// vx, vy, vs, vc].  They differ in which rows have a velocity, which are
// clamped or wrapped, where s and r sit in a measurement, and in OBB's
// alignment and damping.
//
// Design: one warp per slot, blocks of four warps (ops/oru.py::
// launch_geometry gives the grid and the shared memory).  A warp whose slot
// does not rejoin copies the slot's mean and covariance through, lane i
// taking floats i, i + 32, ..., so that each load touches neighbouring
// addresses, and exits.  A rejoining slot's warp keeps the replay's state
// (mean, covariance and a second covariance buffer, L^-1, S^-1, gain and
// I - K H) in a tile of shared memory of its own, about 1-1.5 KB, and runs
// each stage of the filter as a function of the lane over that tile: the
// lanes share out a stage's elements, each lane computing all its values
// before it stores them, and __syncwarp separates the stages, so no lane
// reads in a stage what another writes in it.  An iteration is seven
// stages: F P F^T with the noise (each lane forms the rows of F P that its
// element needs) beside the predicted mean and the next measurement; the
// factor; S^-1 = M^T M; the gain; the mean and I - K H; A P; the Joseph
// covariance.  The serial parts stay on one lane or a few: the Cholesky of
// the dz x dz innovation covariance and its inverse M on one lane, in
// registers; the interpolation on one lane; the oriented alignment's four
// candidates on four lanes and the pick on one.  XYSR's innovation
// covariance is diagonal, so most of the factor's divisions divide an exact
// zero, which sends the card's IEEE division to its slow path: div_rn forms
// those quotients, signed zeros, as products.
//
// Bound on this card: the function is out of place, so it reads and writes
// every slot's mean and covariance once (about 0.9 MB at 8 x 256 slots, 7
// states); the rejoining slots add a few thousand operations an update.  A
// launch's time is the launch, that copy, and the longest slot's replay: a
// lone warp issuing some hundreds of mostly dependent instructions an
// iteration, divergent lanes' paths one after another, the factor's chain
// of square roots and divisions the longest of them (ops/oru.py,
// chip_smoke.py::k4_bound counts the work).
//
// Arithmetic must equal the plain PyTorch twin (ops/oru.py::oru_replay_plain
// with motion/kalman.py's predict and update) bit for bit: each output
// element is computed by one lane with the twin's operations in the twin's
// order, each written with an explicitly rounded intrinsic (the library is
// built with -fmad=false); products with an exact zero and adds of an exact
// zero are kept where the twin has them, so signed zeros agree too; sqrt and
// log are evaluated in double and rounded once, as ops/geometry.py::exact
// does; wrap_angle is torch.remainder's floor modulo (fmod, then the divisor
// added where the signs differ); divisions are true divisions, never
// multiplies by a reciprocal.  Only where an element is computed, and where
// it lives, differs from the twin.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 128;  // ops/oru.py::THREADS
constexpr int kStepLane = kWarp - 1;  // the lane that interpolates the measurements
constexpr int kCandLane = kWarp - 4;  // lanes kCandLane .. +3: the OBB alignment's candidates
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kHalfPi = 1.57079632679489661923f;

// the layout tags (ops/oru.py::LAYOUT_TAGS)
constexpr int kXysr = 0;
constexpr int kXysrObb = 1;
constexpr int kXyscr = 2;

template <int L>
struct Dims {
  static constexpr int DX = L == kXysr ? 7 : 9;
  static constexpr int DZ = L == kXysr ? 4 : 5;
  static constexpr int R = L == kXyscr ? 4 : 3;  // the aspect r's row
};

struct Noise {
  float q[9];  // process variances (dx of them)
  float r[5];  // measurement variances (dz of them)
};

struct Args {
  const float* mean_in;  // (S, K, dx) after the frame's predict
  const float* cov_in;  // (S, K, dx, dx)
  const float* frozen_mean;
  const float* frozen_cov;
  const float* last_meas;  // (S, K, dz)
  const float* z2;  // (S, K, dz)
  const bool* rejoin;  // (S, K)
  const int* gap;  // (S, K)
  float* mean_out;
  float* cov_out;
  int* replayed;  // (S,)
  Noise nz;
  int S, K, max_oru;
};

// A rejoining slot's replay state and workspace, in its warp's tile of
// shared memory; ops/oru.py::tile_floats counts the same floats (the
// factor L lives in the factoring lane's registers).
template <int DX, int DZ>
struct Tile {
  float m[DX];  // the replay's mean
  float z[DZ];  // this iteration's measurement
  float innov[DZ];
  float m1[DZ];  // the last real measurement
  float step[8];  // w1, h1, then the steps of x, y, w, h and the angle or c
  float cand[3][4];  // the OBB alignment: each candidate's cost, angle and r
  float M[DZ][DZ];  // L^-1 of S's Cholesky factor L; the upper triangle stays 0
  float Si[DZ][DZ];
  float G[DX][DZ];  // the gain
  float A[DX][DX];  // I - K H
  float P[2][DX][DX];  // the covariance, and a second buffer (predict's output, A P)
};

// The lanes of one warp: a stage is a function of the lane, and the lanes
// meet at __syncwarp after it.
struct Lanes {
  int lane;
  template <class F>
  __device__ __forceinline__ void stage(F&& f) const {
    f(lane);
    __syncwarp();
  }
};

// The elements e = lane, lane + 32, ... below N of a stage: every value
// computed first, so that a lane's elements overlap, then stored.
template <int N, class V, class S>
__device__ __forceinline__ void each(const int lane, V&& value, S&& store) {
  constexpr int kPer = (N + kWarp - 1) / kWarp;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (lane + k * kWarp < N) v[k] = value(lane + k * kWarp);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (lane + k * kWarp < N) store(lane + k * kWarp, v[k]);
  }
}

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

// IEEE division n / d.  A zero dividend sends the card's division to its
// slow path, so where d is finite and not zero the quotient, a zero with the
// sign of the product, is formed as n * d.
__device__ __forceinline__ float div_rn(const float n, const float d) {
  return n == 0.0f && d != 0.0f && isfinite(d) ? __fmul_rn(n, d) : __fdiv_rn(n, d);
}

__device__ __forceinline__ float exact_sqrt(const float x) {
  return __double2float_rn(sqrt(static_cast<double>(x)));
}

__device__ __forceinline__ float exact_log(const float x) {
  return __double2float_rn(log(static_cast<double>(x)));
}

// the velocity index of state row a, or -1 (XYSR: x, y, s have velocities,
// r has none; oriented: theta too; XYSCR: x, y, s and c, r none)
template <int L>
__device__ __forceinline__ int vel_of(const int a) {
  if (L == kXysr) return a < 3 ? a + 4 : -1;
  if (L == kXyscr) return a < 4 ? a + 5 : -1;
  return a < 3 ? a + 5 : (a == 4 ? 8 : -1);
}

// the layout's constraint on mean element a: s and r clamped, theta wrapped
template <int L>
__device__ __forceinline__ float enforce(const int a, const float x) {
  if (a == 2 || a == Dims<L>::R) return clamp_min(x, 1e-6f);
  if (L == kXysrObb && a == 4) return wrap_angle(x);
  return x;
}

// w = sqrt(max(s r, 1e-12)), h = sqrt(max(s / max(r, 1e-12), 1e-12))
__device__ __forceinline__ void meas_wh(const float s, const float r, float& w, float& h) {
  w = exact_sqrt(clamp_min(__fmul_rn(s, r), 1e-12f));
  h = exact_sqrt(clamp_min(div_rn(s, clamp_min(r, 1e-12f)), 1e-12f));
}

// one lane: the start and steps of the interpolation between the last real
// measurement and the new one (the fifth step: OBB's wrapped angle, XYSCR's
// confidence)
template <int L, int DX, int DZ>
__device__ void interpolation(Tile<DX, DZ>& t, const Args& a, const size_t zo, const int g) {
  constexpr int R = Dims<L>::R;
  float m1[DZ], zz[DZ];
#pragma unroll
  for (int c = 0; c < DZ; ++c) {
    m1[c] = a.last_meas[zo + c];
    zz[c] = a.z2[zo + c];
    t.m1[c] = m1[c];
  }
  float w1, h1, w2, h2;
  meas_wh(m1[2], m1[R], w1, h1);
  meas_wh(zz[2], zz[R], w2, h2);
  const float gapf = clamp_min(static_cast<float>(g), 1.0f);
  t.step[0] = w1;
  t.step[1] = h1;
  t.step[2] = div_rn(__fsub_rn(zz[0], m1[0]), gapf);
  t.step[3] = div_rn(__fsub_rn(zz[1], m1[1]), gapf);
  t.step[4] = div_rn(__fsub_rn(w2, w1), gapf);
  t.step[5] = div_rn(__fsub_rn(h2, h1), gapf);
  t.step[6] = L == kXysrObb ? div_rn(wrap_angle(__fsub_rn(zz[4], m1[4])), gapf)
              : L == kXyscr ? div_rn(__fsub_rn(zz[3], m1[3]), gapf)
                            : 0.0f;
}

// one lane: the i-th interpolated measurement
template <int L, int DX, int DZ>
__device__ void measurement(Tile<DX, DZ>& t, const int i) {
  constexpr int R = Dims<L>::R;
  const float fi = static_cast<float>(i);
  const float wi = __fadd_rn(t.step[0], __fmul_rn(fi, t.step[4]));
  const float hi = __fadd_rn(t.step[1], __fmul_rn(fi, t.step[5]));
  t.z[0] = __fadd_rn(t.m1[0], __fmul_rn(fi, t.step[2]));
  t.z[1] = __fadd_rn(t.m1[1], __fmul_rn(fi, t.step[3]));
  t.z[2] = clamp_min(__fmul_rn(wi, hi), 1e-6f);
  t.z[R] = clamp_min(div_rn(wi, clamp_min(hi, 1e-12f)), 1e-6f);
  if (L == kXysrObb) t.z[4] = wrap_angle(__fadd_rn(t.m1[4], __fmul_rn(fi, t.step[6])));
  if (L == kXyscr) t.z[3] = __fadd_rn(t.m1[3], __fmul_rn(fi, t.step[6]));
}

// motion/kalman.py::align_obb_xysr against the replay's mean, candidate c of
// (s, r, th), (s, r, th + pi), (s, 1/r, th + pi/2), (s, 1/r, th - pi/2): its
// cost |wrapped angle delta| + 0.05 |log(r / ref_r)|, its angle and its r
template <int DX, int DZ>
__device__ void candidate(Tile<DX, DZ>& t, const int c) {
  const float r = clamp_min(t.z[3], 1e-6f);
  const float th = wrap_angle(t.z[4]);
  const float ref_r = clamp_min(t.m[3], 1e-6f);
  const float ref_th = t.m[4];
  const float cand_r = c < 2 ? r : __frcp_rn(r);
  const float cand_t = c == 0 ? th
                       : c == 1 ? __fadd_rn(th, kPi)
                       : c == 2 ? __fadd_rn(th, kHalfPi)
                                : __fsub_rn(th, kHalfPi);
  const float aligned = __fadd_rn(ref_th, wrap_angle(__fsub_rn(cand_t, ref_th)));
  const float angle_cost = fabsf(__fsub_rn(aligned, ref_th));
  const float size_cost = fabsf(exact_log(div_rn(cand_r, ref_r)));
  t.cand[0][c] = __fadd_rn(angle_cost, __fmul_rn(0.05f, size_cost));
  t.cand[1][c] = aligned;
  t.cand[2][c] = cand_r;
}

// one lane: the first candidate of least cost (jnp.argmin's tie rule)
template <int DX, int DZ>
__device__ void pick(Tile<DX, DZ>& t) {
  int best = 0;
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    if (t.cand[0][c] < t.cand[0][best]) best = c;
  }
  t.z[2] = clamp_min(t.z[2], 1e-6f);
  t.z[3] = clamp_min(t.cand[2][best], 1e-6f);
  t.z[4] = t.cand[1][best];
}

// one lane: the unrolled Cholesky of S = P[:dz, :dz] + R and its inverse
// M = L^-1, in registers (a chain of dependent square roots and divisions
// with nothing to share out); M's lower triangle written to the tile, whose
// upper triangle stays 0
template <int DX, int DZ>
__device__ void factor(Tile<DX, DZ>& t, const float (&P)[DX][DX], const Noise& nz) {
  float L[DZ][DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = __fadd_rn(P[i][j], i == j ? nz.r[i] : 0.0f);
#pragma unroll
      for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], L[j][k]));
      L[i][j] = i == j ? exact_sqrt(clamp_min(s, 1e-9f)) : div_rn(s, L[j][j]);
    }
  }
  float M[DZ][DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    M[i][i] = __frcp_rn(L[i][i]);
#pragma unroll
    for (int j = 0; j < i; ++j) {
      float s = __fmul_rn(L[i][j], M[j][j]);
#pragma unroll
      for (int k = j + 1; k < i; ++k) s = __fadd_rn(s, __fmul_rn(L[i][k], M[k][j]));
      M[i][j] = div_rn(-s, L[i][i]);
    }
#pragma unroll
    for (int j = 0; j <= i; ++j) t.M[i][j] = M[i][j];
  }
}

// The replay of one rejoining slot by one warp: motion/kalman.py::predict
// with the layout's transition (F x, F P F^T by rows then columns with one add
// where F has an off-diagonal 1, the process noise on the diagonal and an
// exact zero added off it, the mean's constraints) and ::update (the
// Cholesky of S, M = L^-1, Sinv = M^T M summed over every k, zeros
// included, the gain, the mean, P = (I - K H) P (I - K H)^T + K R K^T).
template <int L, class W, int DX = Dims<L>::DX, int DZ = Dims<L>::DZ>
__device__ void replay_slot(const W& lanes, Tile<DX, DZ>& t, const Args& a, const int slot) {
  const Noise& nz = a.nz;
  const size_t mo = static_cast<size_t>(slot) * DX;
  const size_t co = static_cast<size_t>(slot) * DX * DX;
  const size_t zo = static_cast<size_t>(slot) * DZ;
  const int g = a.gap[slot];
  lanes.stage([&](const int lane) {
    for (int e = lane; e < DX; e += kWarp) t.m[e] = a.frozen_mean[mo + e];
    for (int e = lane; e < DX * DX; e += kWarp) (&t.P[0][0][0])[e] = a.frozen_cov[co + e];
    for (int e = lane; e < DZ * DZ; e += kWarp) (&t.M[0][0])[e] = 0.0f;
    if (lane == kStepLane) {
      interpolation<L>(t, a, zo, g);
      measurement<L>(t, 1);
    }
  });
  const int n = min(g, a.max_oru);
  int cur = 0;
  for (int i = 1; i <= n; ++i) {
    if (i > 1) {
      float(&P)[DX][DX] = t.P[cur];
      float(&Q)[DX][DX] = t.P[cur ^ 1];
      // the predicted mean (its velocities do not change), F P F^T and the
      // noise into the second buffer (each lane forms the rows of F P that
      // its element needs), the measurement
      lanes.stage([&](const int lane) {
        if (lane < DZ) {
          const int v = vel_of<L>(lane);
          t.m[lane] = enforce<L>(lane, v >= 0 ? __fadd_rn(t.m[lane], t.m[v]) : t.m[lane]);
        }
        each<DX * DX>(lane, [&](const int e) {
          const int r = e / DX, c = e % DX, vr = vel_of<L>(r), vc = vel_of<L>(c);
          float x = vr >= 0 ? __fadd_rn(P[r][c], P[vr][c]) : P[r][c];
          if (vc >= 0) x = __fadd_rn(x, vr >= 0 ? __fadd_rn(P[r][vc], P[vr][vc]) : P[r][vc]);
          return __fadd_rn(x, r == c ? nz.q[c] : 0.0f);
        }, [&](const int e, const float x) { (&Q[0][0])[e] = x; });
        if (lane == kStepLane) measurement<L>(t, i);
      });
      cur ^= 1;
    }
    float(&P)[DX][DX] = t.P[cur];
    float(&AP)[DX][DX] = t.P[cur ^ 1];
    lanes.stage([&](const int lane) {  // S's factor and inverse; the alignment's candidates
      if (lane == 0) factor(t, P, nz);
      if (L == kXysrObb && lane >= kCandLane) candidate(t, lane - kCandLane);
    });
    lanes.stage([&](const int lane) {  // Sinv = M^T M; the aligned measurement
      each<DZ * DZ>(lane, [&](const int e) {
        const int r = e / DZ, c = e % DZ;
        float s = __fmul_rn(t.M[0][r], t.M[0][c]);
#pragma unroll
        for (int k = 1; k < DZ; ++k) s = __fadd_rn(s, __fmul_rn(t.M[k][r], t.M[k][c]));
        return s;
      }, [&](const int e, const float x) { (&t.Si[0][0])[e] = x; });
      if (L == kXysrObb && lane == kStepLane) pick(t);
    });
    lanes.stage([&](const int lane) {  // the gain, and the innovation
      each<DX * DZ>(lane, [&](const int e) {
        const int r = e / DZ, c = e % DZ;
        float s = __fmul_rn(P[r][0], t.Si[0][c]);
#pragma unroll
        for (int d = 1; d < DZ; ++d) s = __fadd_rn(s, __fmul_rn(P[r][d], t.Si[d][c]));
        return s;
      }, [&](const int e, const float x) { (&t.G[0][0])[e] = x; });
      if (lane < DZ) t.innov[lane] = __fsub_rn(t.z[lane], t.m[lane]);
    });
    lanes.stage([&](const int lane) {  // the mean; A = I - K H (eye beyond dz)
      if (lane < DX) {
        float delta = __fmul_rn(t.innov[0], t.G[lane][0]);
#pragma unroll
        for (int c = 1; c < DZ; ++c) delta = __fadd_rn(delta, __fmul_rn(t.innov[c], t.G[lane][c]));
        float x = enforce<L>(lane, __fadd_rn(t.m[lane], delta));
        if (L == kXysrObb && lane == 8) x = __fmul_rn(x, 0.8f);  // the angular velocity damped
        t.m[lane] = x;
      }
      each<DX * DX>(lane, [&](const int e) {
        const int r = e / DX, c = e % DX;
        const float eye = r == c ? 1.0f : 0.0f;
        return c < DZ ? __fsub_rn(eye, t.G[r][c < DZ ? c : 0]) : eye;
      }, [&](const int e, const float x) { (&t.A[0][0])[e] = x; });
    });
    lanes.stage([&](const int lane) {  // A P
      each<DX * DX>(lane, [&](const int e) {
        const int r = e / DX, c = e % DX;
        float s = __fmul_rn(t.A[r][0], P[0][c]);
#pragma unroll
        for (int b = 1; b < DX; ++b) s = __fadd_rn(s, __fmul_rn(t.A[r][b], P[b][c]));
        return s;
      }, [&](const int e, const float x) { (&AP[0][0])[e] = x; });
    });
    lanes.stage([&](const int lane) {  // P = A P A^T + K R K^T
      each<DX * DX>(lane, [&](const int e) {
        const int r = e / DX, c = e % DX;
        float s = __fmul_rn(AP[r][0], t.A[c][0]);
#pragma unroll
        for (int k = 1; k < DX; ++k) s = __fadd_rn(s, __fmul_rn(AP[r][k], t.A[c][k]));
        float krk = __fmul_rn(__fmul_rn(t.G[r][0], nz.r[0]), t.G[c][0]);
#pragma unroll
        for (int k = 1; k < DZ; ++k)
          krk = __fadd_rn(krk, __fmul_rn(__fmul_rn(t.G[r][k], nz.r[k]), t.G[c][k]));
        return __fadd_rn(s, krk);
      }, [&](const int e, const float x) { (&P[0][0])[e] = x; });
    });
  }
  lanes.stage([&](const int lane) {
    for (int e = lane; e < DX; e += kWarp) a.mean_out[mo + e] = t.m[e];
    for (int e = lane; e < DX * DX; e += kWarp) a.cov_out[co + e] = (&t.P[cur][0][0])[e];
    if (lane == 0) atomicAdd(a.replayed + slot / a.K, 1);
  });
}

// a slot that does not rejoin: its mean and covariance copied through,
// neighbouring lanes on neighbouring floats
template <int DX>
__device__ void copy_slot(const int lane, const Args& a, const int slot) {
  const size_t mo = static_cast<size_t>(slot) * DX;
  const size_t co = static_cast<size_t>(slot) * DX * DX;
  for (int e = lane; e < DX; e += kWarp) a.mean_out[mo + e] = __ldg(a.mean_in + mo + e);
  for (int e = lane; e < DX * DX; e += kWarp) a.cov_out[co + e] = __ldg(a.cov_in + co + e);
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads) oru_kernel(const Args a) {
  constexpr int DX = Dims<L>::DX, DZ = Dims<L>::DZ;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int slot = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (slot >= a.S * a.K) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  if (a.rejoin[slot]) {
    replay_slot<L>(Lanes{lane}, reinterpret_cast<Tile<DX, DZ>*>(smem)[warp], a, slot);
  } else {
    copy_slot<DX>(lane, a, slot);
  }
}

template <int L>
int launch(const Args& a, const int blocks, const int threads, const int smem_bytes,
           cudaStream_t st) {
  using T = Tile<Dims<L>::DX, Dims<L>::DZ>;
  if (smem_bytes < (threads / kWarp) * static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  oru_kernel<L><<<blocks, threads, smem_bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over the S x K slots: mean_in/cov_in (S, K, dx[, dx]) after the
// frame's predict, frozen_mean/frozen_cov likewise, last_meas and z2
// (S, K, dz), rejoin (S, K) bool, gap (S, K) int32; writes mean_out/cov_out
// and adds each sequence's rejoining slots to replayed (S,) int32.  noise:
// a host array of the dx process variances, then the dz measurement ones.
// layout: the tag, 0 for the 7-state XYSR filter, 1 for the 9-state
// oriented one, 2 for the 9-state XYSCR one.
// blocks, threads, smem_bytes: ops/oru.py::launch_geometry, a warp a slot
// (threads a multiple of 32, at most 128) and a tile of shared memory a warp.
extern "C" int bmt_oru(const void* mean_in, const void* cov_in, const void* frozen_mean,
                       const void* frozen_cov, const void* last_meas, const void* z2,
                       const void* rejoin, const void* gap, void* mean_out, void* cov_out,
                       void* replayed, const float* noise, int S, int K, int layout, int max_oru,
                       int blocks, int threads, int smem_bytes, void* stream) {
  if (S <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const long slots = static_cast<long>(S) * K;
  if (noise == nullptr || layout < kXysr || layout > kXyscr || max_oru < 0 ||
      slots > (1L << 30) || threads <= 0 ||
      threads > kMaxThreads || threads % kWarp != 0 ||
      static_cast<long>(blocks) * (threads / kWarp) < slots || smem_bytes > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dx = layout == kXysr ? 7 : 9;
  const int dz = layout == kXysr ? 4 : 5;
  Args a{};
  a.mean_in = static_cast<const float*>(mean_in);
  a.cov_in = static_cast<const float*>(cov_in);
  a.frozen_mean = static_cast<const float*>(frozen_mean);
  a.frozen_cov = static_cast<const float*>(frozen_cov);
  a.last_meas = static_cast<const float*>(last_meas);
  a.z2 = static_cast<const float*>(z2);
  a.rejoin = static_cast<const bool*>(rejoin);
  a.gap = static_cast<const int*>(gap);
  a.mean_out = static_cast<float*>(mean_out);
  a.cov_out = static_cast<float*>(cov_out);
  a.replayed = static_cast<int*>(replayed);
  for (int i = 0; i < dx; ++i) a.nz.q[i] = noise[i];
  for (int i = 0; i < dz; ++i) a.nz.r[i] = noise[dx + i];
  a.S = S;
  a.K = K;
  a.max_oru = max_oru;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kXysr:
      return launch<kXysr>(a, blocks, threads, smem_bytes, st);
    case kXysrObb:
      return launch<kXysrObb>(a, blocks, threads, smem_bytes, st);
    default:
      return launch<kXyscr>(a, blocks, threads, smem_bytes, st);
  }
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
