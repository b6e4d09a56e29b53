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
// The order of the walk.  The TPU versions carry 4 -> 8 -> 16 -> 32 -> 64
// duplicate-padded vertex slots per pair, because XLA and Pallas need static
// shapes.  Here a pair keeps a compact list of the vertices Sutherland-Hodgman
// emits.  A padded duplicate is neutral to the geometry: it has the inside
// flag of its original, so it emits no crossing, and it adds x*y - x*y, an
// exact 0 without FMA, to the shoelace sum.  What the padding does change is
// where the cyclic list starts: when slot 0 of the padded list holds a copy of
// the last vertex ("lead"), the padded clip meets the list's closing edge
// first, and the padded shoelace sum adds the closing term first.  The kernel
// tracks that flag, and whether padded slots 0 and 1 hold different vertices
// ("split"), from stage to stage, and walks its edges in the padded order; so
// it adds the same nonzero terms in the same order as the plain twin
// (ops/rotated_iou.py), which sums its padded slots one at a time in slot
// order.  Every operation is an explicitly rounded intrinsic and the library
// is built with -fmad=false, so the kernel equals the twin bit for bit.
//
// Bound on this card: per-pair ALU work with data-dependent control flow;
// bytes are few (13 floats in per box, one float out per pair).  A warp's
// lanes hold different pairs, so a pair that needs the full clip holds up
// the 31 that do not: the old design (one pair a thread, 64-slot lists in
// local memory) spent its time there.  The design:
//   * Provable zeros first.  Pass 1 tests every pair of the block's tile,
//     uniformly (no divergence), for a clip edge that all four subject
//     corners lie outside of by a margin (clipped_away says why that gives
//     the twin's exact 0); such a pair gets 0 at once.  The rest are queued
//     in shared memory (a ballot and one atomic per warp), and pass 2 clips
//     them densely, one a thread, so the warps of pass 2 are full of pairs
//     that need the clip.
//   * Vertex lists in shared memory.  Clipping a convex polygon by a
//     half-plane adds at most one vertex, so on real boxes the stages hold 5,
//     6, 7 and 8 vertices: each thread keeps two lists of kFast = 8 slots and
//     their side values in shared memory, slot q of thread t at [q][t], so
//     the data-dependent indexing costs one shared access and no bank
//     conflict.  A stage whose vertices are all outside ends the clip; one
//     whose vertices are all inside keeps the list (rotated by one unless
//     `lead`) without walking it; both give exactly the walk's list.
//   * Overflow detection.  Rounding can bend a near-collinear sliver so that
//     a stage emits more than 8 vertices (at most two per input edge, so at
//     most 4 * 2^4 = 64, the padded scheme's own bound).  Such a pair is
//     detected and recomputed in the same kernel by the same walk over
//     64-slot lists in local memory (clip_slow), so the bits do not depend
//     on the path taken.
//   * Staged boxes.  A block covers up to kRows rows x kThreads columns: the
//     rows' and columns' corners, centres, areas and the clip polygons'
//     windings are staged once in shared memory, so no pair reloads a box or
//     recomputes a winding.  The host picks the rows per block from the
//     shape and the card's SM count, so a tracker-sized problem still spreads
//     over the SMs.
// A counting instantiation (kCount) writes each pair's arithmetic operations:
// those of the function itself (centring, the walk, the quotient), so it
// also walks the pairs that pass 1 rejects and leaves the reject test
// uncounted.  It counts the queued pairs that took the slow path; the timed
// instantiation does neither.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kMaxVerts = 64;  // the slow path's list bound
constexpr int kFast = 8;       // the fast path's list capacity
constexpr int kThreads = 128;  // columns per block
constexpr int kRows = 8;       // rows per block: pass 1 tests kRows pairs a thread

__device__ __forceinline__ float cross_term(float xa, float ya, float xb, float yb) {
  return __fsub_rn(__fmul_rn(xa, yb), __fmul_rn(xb, ya));
}

__device__ __forceinline__ float side_of(float x, float y, float exk, float eyk, float dx,
                                         float dy, float orient) {
  return __fmul_rn(__fsub_rn(__fmul_rn(dx, __fsub_rn(y, eyk)), __fmul_rn(dy, __fsub_rn(x, exk))),
                   orient);
}

// where edge (a, b) crosses the clip line, as a fraction of the edge
__device__ __forceinline__ float crossing_t(float sa, float sb) {
  const float denom = __fsub_rn(sa, sb);
  return __fdiv_rn(sa, fabsf(denom) < 1e-30f ? 1e-30f : denom);
}

__device__ __forceinline__ float lerp(float t, float pa, float pb) {
  return __fadd_rn(pa, __fmul_rn(t, __fsub_rn(pb, pa)));
}

// The compact walk over two vertex lists of kCap slots and their side values,
// slot q of a list at p[q * kStride].  Returns false, with *inter unset, when
// a stage would emit more than kCap vertices (never for kCap = kMaxVerts).
// With kCount it adds the arithmetic operations it did to *ops.
template <int kCap, int kStride, bool kCount>
__device__ __forceinline__ bool clip(const float* ax, const float* ay, const float* ex,
                                          const float* ey, float orient, float* lx0, float* ly0,
                                          float* lx1, float* ly1, float* ls, float* inter,
                                          int* ops) {
#define AT(p, q) (p)[(q) * kStride]
  float* lx[2] = {lx0, lx1};
  float* ly[2] = {ly0, ly1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    AT(lx0, k) = ax[k];
    AT(ly0, k) = ay[k];
  }
  int cur = 0, n = 4, count = 0;
  bool lead = false, split = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (n == 0) break;
    const int kn = (k + 1) & 3;
    const float dx = __fsub_rn(ex[kn], ex[k]);
    const float dy = __fsub_rn(ey[kn], ey[k]);
    const float* x = lx[cur];
    const float* y = ly[cur];
    float* nx = lx[cur ^ 1];
    float* ny = ly[cur ^ 1];
    bool any_in = false, all_in = true;
    for (int q = 0; q < n; ++q) {
      const float s = side_of(AT(x, q), AT(y, q), ex[k], ey[k], dx, dy, orient);
      AT(ls, q) = s;
      any_in |= s >= 0.0f;
      all_in &= s >= 0.0f;
    }
    if (kCount) count += 2 + 6 * n;
    if (!any_in) {  // no vertex inside, so no crossing either: the list empties
      n = 0;
      break;
    }
    if (all_in) {
      // every vertex passes and none crosses: the walk emits the list as it
      // is (`lead`) or rotated left by one; after it `lead` holds, `split` stays
      if (!lead) {
        for (int q = 0; q < n; ++q) {
          AT(nx, q) = AT(x, q + 1 == n ? 0 : q + 1);
          AT(ny, q) = AT(y, q + 1 == n ? 0 : q + 1);
        }
        cur ^= 1;
      }
      lead = true;
      continue;
    }
    int m = 0;
    bool s0 = false, s1 = false;
    for (int q = 0; q < n; ++q) {
      // the padded clip meets the closing edge first when `lead`
      const int a = lead ? (q == 0 ? n - 1 : q - 1) : q;
      const int b = a + 1 == n ? 0 : a + 1;
      const float sa = AT(ls, a), sb = AT(ls, b);
      const bool in_a = sa >= 0.0f, in_b = sb >= 0.0f;
      if (in_a != in_b) {
        if (m == kCap) return false;
        const float tc = crossing_t(sa, sb);
        AT(nx, m) = lerp(tc, AT(x, a), AT(x, b));
        AT(ny, m) = lerp(tc, AT(y, a), AT(y, b));
        ++m;
        if (kCount) count += 8;
      }
      if (in_b) {
        if (m == kCap) return false;
        AT(nx, m) = AT(x, b);
        AT(ny, m) = AT(y, b);
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
  float area = 0.0f;
  if (n > 0) {
    const float* x = lx[cur];
    const float* y = ly[cur];
    float acc = 0.0f;
    if (lead) acc = __fadd_rn(acc, cross_term(AT(x, n - 1), AT(y, n - 1), AT(x, 0), AT(y, 0)));
    for (int q = 0; q < (lead ? n - 1 : n); ++q) {
      const int b = q + 1 == n ? 0 : q + 1;
      acc = __fadd_rn(acc, cross_term(AT(x, q), AT(y, q), AT(x, b), AT(y, b)));
    }
    area = __fmul_rn(0.5f, fabsf(acc));
    if (kCount) count += 4 * n + 1;
  }
#undef AT
  *inter = area;
  if (kCount) *ops += count;
  return true;
}

// The walk over 64-slot lists in local memory, for a pair whose list
// outgrew the fast path's kFast slots; kept out of line, so that the fast
// path's frame holds no local lists.
template <bool kCount>
__device__ __noinline__ float clip_slow(const float* ax, const float* ay, const float* ex,
                                        const float* ey, float orient, int* ops) {
  float vx[2][kMaxVerts], vy[2][kMaxVerts], side[kMaxVerts], inter;
  clip<kMaxVerts, 1, kCount>(ax, ay, ex, ey, orient, vx[0], vy[0], vx[1], vy[1], side, &inter,
                             ops);
  return inter;
}

// Whether the clip provably empties the subject, from its 4 centred corners
// alone.  Sutherland-Hodgman keeps every vertex in the convex hull of the
// subject's corners: a crossing is a + t (b - a) with t in [0, 1] (|sa| <=
// |sa - sb| when the signs differ, and rounding is monotone), so rounding
// moves it off its edge by an ulp or two of the largest coordinate A, and
// three stages by less than 1e-6 A.  The side value is linear, so such a move
// changes it by at most (|dx| + |dy|) 1e-6 A, and rounding the side itself
// errs by less than (|dx| + |dy|) 1e-6 A too.  So when all 4 corners lie
// outside one clip edge by more than (|dx| + |dy|) 1e-4 A, every vertex that
// reaches that edge's stage has a computed side < 0: the stage empties the
// list, as it does in the twin, and the IoU is the twin's exact 0.  A
// degenerate edge (dx = dy = 0) has side 0 everywhere and never rejects.
__device__ __forceinline__ bool clipped_away(const float* ax, const float* ay, const float* ex,
                                             const float* ey, float orient) {
  float big = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    big = fmaxf(big, fmaxf(fmaxf(fabsf(ax[k]), fabsf(ay[k])), fmaxf(fabsf(ex[k]), fabsf(ey[k]))));
  bool away = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) & 3;
    const float dx = __fsub_rn(ex[kn], ex[k]);
    const float dy = __fsub_rn(ey[kn], ey[k]);
    const float margin = (fabsf(dx) + fabsf(dy)) * big * 1e-4f;
    bool out = true;
#pragma unroll
    for (int q = 0; q < 4; ++q) out &= side_of(ax[q], ay[q], ex[k], ey[k], dx, dy, orient) < -margin;
    away |= out;
  }
  return away;
}

// a pair's operations besides its walk: centring (4 for the centre, 16
// corner subtractions), the union (2) and the quotient (1)
constexpr int kPairOps = 4 + 16 + 3;

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
rotated_iou_kernel(const float* __restrict__ b1, const float4* __restrict__ c1,
                   const float* __restrict__ b2, const float4* __restrict__ c2,
                   float* __restrict__ out, int* __restrict__ ops_out,
                   unsigned* __restrict__ slow_pairs, int N, int M, int rows_per_block) {
  // the block's boxes: up to kRows rows and kThreads columns
  __shared__ float row_x[kRows][4], row_y[kRows][4], row_c[kRows][2], row_area[kRows];
  __shared__ float col_x[4][kThreads], col_y[4][kThreads], col_c[2][kThreads];
  __shared__ float col_area[kThreads], col_orient[kThreads];
  // the pairs pass 1 could not reject: row * kThreads + column
  __shared__ int queue[kRows * kThreads];
  __shared__ int n_queue;
  // each thread's two vertex lists and side values: slot q of thread t at
  // [q][t], so a warp's accesses fall in distinct banks whatever its slots
  __shared__ float list_x[2][kFast][kThreads], list_y[2][kFast][kThreads];
  __shared__ float list_side[kFast][kThreads];
  const int s = blockIdx.z;
  const int i0 = blockIdx.y * rows_per_block;
  const int tx = threadIdx.x;
  const int lane = tx & 31;
  const int j = blockIdx.x * kThreads + tx;
  const int rows = min(rows_per_block, N - i0);

  if (tx < rows) {
    const size_t r1 = (size_t)s * N + i0 + tx;
    const float4 pa = c1[r1 * 2], pb = c1[r1 * 2 + 1];
    const float* o1 = b1 + r1 * 5;
    row_x[tx][0] = pa.x, row_y[tx][0] = pa.y, row_x[tx][1] = pa.z, row_y[tx][1] = pa.w;
    row_x[tx][2] = pb.x, row_y[tx][2] = pb.y, row_x[tx][3] = pb.z, row_y[tx][3] = pb.w;
    row_c[tx][0] = o1[0];
    row_c[tx][1] = o1[1];
    row_area[tx] = __fmul_rn(o1[2], o1[3]);
  }
  if (tx == 0) n_queue = 0;
  const bool has_col = j < M;
  if (has_col) {
    // the column box, and the winding of the clip polygon from its uncentred corners
    const size_t r2 = (size_t)s * M + j;
    const float4 qa = c2[r2 * 2], qb = c2[r2 * 2 + 1];
    const float bx[4] = {qa.x, qa.z, qb.x, qb.z}, by[4] = {qa.y, qa.w, qb.y, qb.w};
    const float* o2 = b2 + r2 * 5;
    float wind = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wind = __fadd_rn(wind, cross_term(bx[k], by[k], bx[(k + 1) & 3], by[(k + 1) & 3]));
      col_x[k][tx] = bx[k];
      col_y[k][tx] = by[k];
    }
    col_c[0][tx] = o2[0];
    col_c[1][tx] = o2[1];
    col_area[tx] = __fmul_rn(o2[2], o2[3]);
    col_orient[tx] = __fmul_rn(0.5f, wind) >= 0.0f ? 1.0f : -1.0f;
  }
  __syncthreads();

  // the pair (row r, this thread's column), centred on the mean of the centres
  auto centre = [&](int r, int c, float* ax, float* ay, float* ex, float* ey) {
    // halving is exact up to the same rounding as the twin's division by 2
    const float ox = __fmul_rn(__fadd_rn(row_c[r][0], col_c[0][c]), 0.5f);
    const float oy = __fmul_rn(__fadd_rn(row_c[r][1], col_c[1][c]), 0.5f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ex[k] = __fsub_rn(col_x[k][c], ox);
      ey[k] = __fsub_rn(col_y[k][c], oy);
      ax[k] = __fsub_rn(row_x[r][k], ox);
      ay[k] = __fsub_rn(row_y[r][k], oy);
    }
  };

  // the intersection area of a centred pair, by the fast path or, when its
  // list outgrows kFast slots, by the slow path (then *slow is set); the
  // thread's own shared-memory lists
  auto intersect = [&](const float* ax, const float* ay, const float* ex, const float* ey,
                       float orient, int* ops, bool* slow) {
    float inter;
    *slow = !clip<kFast, kThreads, kCount>(ax, ay, ex, ey, orient, &list_x[0][0][tx],
                                           &list_y[0][0][tx], &list_x[1][0][tx],
                                           &list_y[1][0][tx], &list_side[0][tx], &inter, ops);
    if (*slow) inter = clip_slow<kCount>(ax, ay, ex, ey, orient, ops);
    return inter;
  };
  auto iou = [&](int r, int c, float inter) {
    const float uni = __fsub_rn(__fadd_rn(row_area[r], col_area[c]), inter);
    return uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
  };

  // pass 1: write the provable zeros, queue the rest (warp-aggregated)
  for (int r = 0; r < rows; ++r) {
    bool keep = false;
    if (has_col) {
      float ax[4], ay[4], ex[4], ey[4];
      centre(r, tx, ax, ay, ex, ey);
      keep = !clipped_away(ax, ay, ex, ey, col_orient[tx]);
      if (!keep) {
        const size_t o = ((size_t)s * N + i0 + r) * M + j;
        out[o] = 0.0f;
        if (kCount) {
          // the function's work for this pair is its walk, not the reject
          // test: count the walk, and write its IoU, the test's exact 0, so
          // that holding this output against the twin checks the test too
          int ops = 0;
          bool slow;
          out[o] = iou(r, tx, intersect(ax, ay, ex, ey, col_orient[tx], &ops, &slow));
          ops_out[o] = kPairOps + ops;
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&n_queue, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (keep) queue[base + __popc(ballot & ((1u << lane) - 1u))] = r * kThreads + tx;
  }
  __syncthreads();

  // pass 2: the queued pairs, one a thread, clipped
  const int n = n_queue;
  for (int qi = tx; qi < n; qi += kThreads) {
    const int r = queue[qi] / kThreads;
    const int c = queue[qi] - r * kThreads;
    float ax[4], ay[4], ex[4], ey[4];
    centre(r, c, ax, ay, ex, ey);
    int ops = 0;
    bool slow;
    const float inter = intersect(ax, ay, ex, ey, col_orient[c], &ops, &slow);
    const size_t o = ((size_t)s * N + i0 + r) * M + blockIdx.x * kThreads + c;
    out[o] = iou(r, c, inter);
    if (kCount) {
      ops_out[o] = kPairOps + ops;
      if (slow) atomicAdd(slow_pairs, 1u);
    }
  }
}

}  // namespace

// ops, slow_pairs: both null for the timed kernel; both set for the counting
// one, which writes each pair's operations (S, N, M) and adds the pairs that
// took the slow path to *slow_pairs
extern "C" int bmt_rotated_iou(const void* b1, const void* c1, const void* b2, const void* c2,
                               void* out, void* ops, void* slow_pairs, int S, int N, int M,
                               void* stream) {
  if (S <= 0 || N <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  // rows per block: as many as keep about 4 blocks on each SM (one wave at
  // the tracker's sizes), at most kRows
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long col_blocks = (M + kThreads - 1) / kThreads;
  const int rows_per_block =
      static_cast<int>(std::max(1L, std::min<long>(kRows, S * col_blocks * N / (4L * sms))));
  const int row_blocks = (N + rows_per_block - 1) / rows_per_block;
  if (row_blocks > 65535 || S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  {
    const dim3 grid(col_blocks, row_blocks, S);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* p1 = static_cast<const float*>(b1);
    const auto* q1 = static_cast<const float4*>(c1);
    const auto* p2 = static_cast<const float*>(b2);
    const auto* q2 = static_cast<const float4*>(c2);
    if (ops) {
      rotated_iou_kernel<true><<<grid, kThreads, 0, st>>>(
          p1, q1, p2, q2, static_cast<float*>(out), static_cast<int*>(ops),
          static_cast<unsigned*>(slow_pairs), N, M, rows_per_block);
    } else {
      rotated_iou_kernel<false><<<grid, kThreads, 0, st>>>(p1, q1, p2, q2, static_cast<float*>(out),
                                                           nullptr, nullptr, N, M,
                                                           rows_per_block);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
