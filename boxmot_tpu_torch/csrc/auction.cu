// Masked auction assignment with lapjv cost_limit semantics, batched over S.
//
// Replaces the JAX function boxmot_tpu/ops/lap.py::masked_assignment.  It
// has no Pallas kernel: on the TPU the auction is a lax.while_loop inside
// the XLA program of the tracker step.  In eager PyTorch that loop would
// copy `any(r2c == -1)` to the host on every iteration, three times per
// frame, so the whole loop runs inside this kernel instead.
//
// Formulation, kept exactly as the reference (lap.py:79-133) so that r2c
// is identical to the JAX solver and to the plain PyTorch twin:
//   w = thresh[s] - cost, -inf where the row or column is masked out or w <= 0;
//   eps = max(w_max, 1e-2) * 1e-4 with w_max the largest finite w (or 0);
//   one eps round from zero prices;
//   an implicit dummy per row: second = max(finite b2, 0), and a row whose
//   best net value b1 < 0 retires permanently (r2c = -3);
//   bid = prices[j*] + (b1 - second) + eps, in that order;
//   row argmax ties go to the lowest column, column ties to the lowest row;
//   dethroned owners are reset before winners are installed;
//   at most max_iters iterations.  A problem that stops at the cap with
//   rows still unassigned adds 1 to capped[s], so the caller can see it.
//
// Bound on this card: the input is small (R <= 256, C <= 512, one float a
// pair: 128 KB at the bench's 256 x 128, 0.3 us at 3.35 TB/s) and the work is
// zero to a few hundred dependent iterations, each a scan of the pending rows
// and a column update with block barriers between them.  So it is bound by
// the latency of setting up w and of each iteration, not by bytes or
// operations, and the design shortens both:
//   * One block of 32 warps per problem.  w is formed a warp a row, its lanes
//     on neighbouring columns, so every warp has several rows' loads in flight.
//   * w lives in shared memory for the whole loop when R * C * 4 bytes fit
//     (the bench's 256 x 128 takes 128 KB of the 227 KB a block may have).
//     Wider problems (live frames of up to 512 detections) read the cost
//     from global memory, L2-resident after the first pass, and recompute w
//     with the same rounded operations; no scratch buffer, no allocation per
//     launch.  The caller picks the path from the static shape and passes it
//     (ops/lap.py uses_shared_weights holds the limit).
//   * Pending rows are compacted into a list each iteration (a ballot and
//     one shared atomic per warp), and each pending row is scanned by a whole
//     warp: a lane keeps (b1, arg, b2) of its strided columns, scanned in
//     increasing order with strict compares, and a shuffle butterfly merges
//     the lanes with index ties, which gives exactly the serial scan's b1,
//     lowest argmax and b2 (the max over j != arg).
//   * Column winners come from one shared-memory 64-bit atomicMax per
//     bidding row: the bid mapped to an order-preserving unsigned int in the
//     high half, ~row in the low half, so the largest key is the highest bid
//     and, among equal bids, the lowest row: the twin's amax and argmax.
//     The column step is then O(1) a column instead of a walk over all rows.
//     A winner was pending and an owner is assigned, so no row is both, and
//     dethroning and installing run in one pass.
//   * A scalar threshold is a kernel argument, not a tensor made per call.
// One block per problem stays: the passes of an iteration depend on each
// other.  An optional work output gives each problem's iterations and rows
// scanned, from which a caller can count the operations these inputs
// needed.  The library is built with -fmad=false; every operation that the
// twin rounds is an explicitly rounded intrinsic here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxRows = 256;
constexpr int kMaxCols = 512;
constexpr int kThreads = 1024;  // 32 warps: a pending row each, R <= 256 rows
constexpr int kWarps = kThreads / 32;
constexpr int kNoArg = 0x7fffffff;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the largest key is the highest bid, then the lowest row; 0 is "no bid"
__device__ __forceinline__ unsigned long long bid_key(float bid, int row) {
  unsigned u = __float_as_uint(bid);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(~row);
}

__device__ __forceinline__ float weight(float th, float cost, bool col_ok) {
  const float w = __fsub_rn(th, cost);
  return (col_ok && w > 0.0f) ? w : -INFINITY;
}

template <bool kSharedW>
__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ row_mask,
               const unsigned char* __restrict__ col_mask, int* __restrict__ r2c_out,
               int* __restrict__ capped, const float* __restrict__ thresh, float thresh_all,
               int* __restrict__ work, int R, int C, int max_iters) {
  extern __shared__ float w_sh[];  // (R, C), row-major; only when kSharedW
  __shared__ float prices[kMaxCols];
  __shared__ int owner[kMaxCols];
  __shared__ unsigned long long keys[kMaxCols];
  __shared__ unsigned char col_ok[kMaxCols];
  __shared__ int r2c[kMaxRows];
  __shared__ float bid[kMaxRows];
  __shared__ int pending[kMaxRows];
  __shared__ int n_pending;
  __shared__ float warp_best[kWarps];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cs = cost + (size_t)s * R * C;
  const unsigned char* rm = row_mask + (size_t)s * R;
  const unsigned char* cm = col_mask + (size_t)s * C;
  const float th = thresh ? thresh[s] : thresh_all;

  if (tid < R) r2c[tid] = rm[tid] ? -1 : -2;
  for (int j = tid; j < C; j += kThreads) {
    prices[j] = 0.0f;
    owner[j] = -1;
    keys[j] = 0ull;
    col_ok[j] = cm[j];
  }
  if (tid == 0) n_pending = 0;
  // no row to assign (a pass whose rows are all masked out): nothing to solve
  if (!__syncthreads_or(tid < R && rm[tid])) {
    if (tid < R) r2c_out[(size_t)s * R + tid] = -1;
    if (work && tid == 0) work[2 * s] = work[2 * s + 1] = 0;
    return;
  }

  // w, and the largest finite w (0 when there is none): a warp a row, its
  // lanes on neighbouring columns, so every warp has loads of many rows in flight
  float local_max = 0.0f;
#pragma unroll 4
  for (int r = warp; r < R; r += kWarps) {
    const bool row_ok = r2c[r] != -2;
    for (int j = lane; j < C; j += 32) {
      const float w = row_ok ? weight(th, cs[r * C + j], col_ok[j] != 0) : -INFINITY;
      if (kSharedW) w_sh[r * C + j] = w;
      if (isfinite(w)) local_max = fmaxf(local_max, w);
    }
  }
  local_max = warp_max(local_max);
  if (lane == 0) warp_best[warp] = local_max;
  __syncthreads();
  float w_max = warp_best[0];
  for (int i = 1; i < kWarps; ++i) w_max = fmaxf(w_max, warp_best[i]);
  const float eps = __fmul_rn(fmaxf(w_max, 1e-2f), 1e-4f);

  int it = 0, scanned = 0, n = 0;
  while (true) {
    // compact the pending rows (in any order: the column keys do not depend on it)
    if (warp * 32 < R) {  // whole warps, for the ballot
      const bool p = tid < R && r2c[tid] == -1;
      const unsigned ballot = __ballot_sync(0xffffffffu, p);
      int base = 0;
      if (lane == 0 && ballot) base = atomicAdd(&n_pending, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (p) pending[base + __popc(ballot & ((1u << lane) - 1u))] = tid;
    }
    __syncthreads();
    n = n_pending;  // uniform across the block, so every thread leaves together
    if (n == 0 || it >= max_iters) break;
    scanned += n;

    // rows: a warp per pending row; best and second-best net value, then bid
    for (int k = warp; k < n; k += kWarps) {
      const int r = pending[k];
      float b1 = -INFINITY, b2 = -INFINITY;
      int arg = lane < C ? lane : kNoArg;
      for (int j = lane; j < C; j += 32) {
        const float w = kSharedW ? w_sh[r * C + j] : weight(th, cs[r * C + j], col_ok[j] != 0);
        const float v = __fsub_rn(w, prices[j]);
        if (v > b1) {
          b2 = b1;
          b1 = v;
          arg = j;
        } else if (v > b2) {
          b2 = v;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float o1 = __shfl_xor_sync(0xffffffffu, b1, off);
        const float o2 = __shfl_xor_sync(0xffffffffu, b2, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (o1 > b1) {
          b2 = fmaxf(o2, b1);
          b1 = o1;
          arg = oa;
        } else if (o1 < b1) {
          b2 = fmaxf(b2, o1);
        } else {
          b2 = b1;  // two lanes share the best value: it is also the second best
          arg = min(arg, oa);
        }
      }
      if (lane == 0) {
        const float second = fmaxf(isfinite(b2) ? b2 : 0.0f, 0.0f);
        if (b1 < 0.0f) {
          r2c[r] = -3;  // the dummy beats every real option: retire
        } else {
          const float b = __fadd_rn(__fadd_rn(prices[arg], __fsub_rn(b1, second)), eps);
          bid[r] = b;
          atomicMax(&keys[arg], bid_key(b, r));
        }
      }
    }
    __syncthreads();
    if (tid == 0) n_pending = 0;

    // columns: the highest bid wins; dethrone the owner, install the winner
    for (int j = tid; j < C; j += kThreads) {
      const unsigned long long key = keys[j];
      if (key) {
        const int win = ~static_cast<int>(static_cast<unsigned>(key));
        if (owner[j] >= 0) r2c[owner[j]] = -1;
        r2c[win] = j;
        owner[j] = win;
        prices[j] = bid[win];
        keys[j] = 0ull;
      }
    }
    __syncthreads();
    ++it;
  }

  if (tid < R) {
    const int v = r2c[tid];
    r2c_out[(size_t)s * R + tid] = v >= 0 ? v : -1;
  }
  if (tid == 0) {
    if (n > 0) capped[s] += 1;
    if (work) {
      work[2 * s] = it;
      work[2 * s + 1] = scanned;
    }
  }
}

}  // namespace

// thresh: (S,) per-problem thresholds, or null for thresh_all everywhere;
// work: null, or (S, 2) int32 for each problem's iterations and rows scanned;
// shared_w: nonzero to keep w (R * C floats) in dynamic shared memory
extern "C" int bmt_auction(const void* cost, const void* row_mask, const void* col_mask,
                           void* r2c, void* capped, const void* thresh, float thresh_all,
                           void* work, int S, int R, int C, int max_iters, int shared_w,
                           void* stream) {
  if (R > kMaxRows || C > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const size_t w_bytes = static_cast<size_t>(R) * C * sizeof(float);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cost);
  const auto* rm = static_cast<const unsigned char*>(row_mask);
  const auto* cm = static_cast<const unsigned char*>(col_mask);
  const auto* th = static_cast<const float*>(thresh);
  if (shared_w) {
    static size_t attr_bytes = 0;  // the most dynamic shared memory allowed so far
    if (w_bytes > attr_bytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          auction_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(w_bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_bytes = w_bytes;
    }
    auction_kernel<true><<<S, kThreads, w_bytes, st>>>(
        c, rm, cm, static_cast<int*>(r2c), static_cast<int*>(capped), th, thresh_all,
        static_cast<int*>(work), R, C, max_iters);
  } else {
    auction_kernel<false><<<S, kThreads, 0, st>>>(
        c, rm, cm, static_cast<int*>(r2c), static_cast<int*>(capped), th, thresh_all,
        static_cast<int*>(work), R, C, max_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
