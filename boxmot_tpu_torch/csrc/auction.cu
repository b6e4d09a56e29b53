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
// Bound on this card: R <= 256, C <= 512 and S is the number of sequences, so the
// work is a few hundred serial iterations of tiny row and column scans; it
// is bound by latency (barriers and L2 reads), not by bandwidth or FLOPs.
// Design: one block of 256 threads per problem runs the whole loop, with
// __syncthreads_or as the loop condition, so nothing returns to the host.
// Thread r holds row r; in the column step each thread walks two columns
// (j and j + 256), so a live frame of up to 512 detections fits one block.
// Prices, owners and r2c live in shared memory (6 KB at 512 columns).  The
// (R, C) weights do not fit (up to 512 KB against the 227 KB a block may
// have), so the block writes w once, transposed, into a global scratch
// buffer: thread r then scans row r with its neighbours reading
// neighbouring addresses, served by L2.
// The library is built with -fmad=false; there is no product to contract
// except eps, which is a single multiply.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxRows = 256;
constexpr int kMaxCols = 512;
constexpr int kThreads = 256;
constexpr int kColsPerThread = kMaxCols / kThreads;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ row_mask,
               const unsigned char* __restrict__ col_mask, float* __restrict__ w_t,
               int* __restrict__ r2c_out, int* __restrict__ capped,
               const float* __restrict__ thresh, int R, int C, int max_iters) {
  __shared__ float prices[kMaxCols];
  __shared__ int owner[kMaxCols];
  __shared__ int r2c[kMaxRows];
  __shared__ int jstar[kMaxRows];  // column row r bids on, or -1
  __shared__ float bid[kMaxRows];
  __shared__ float warp_best[kThreads / 32];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const float* cs = cost + (size_t)s * R * C;
  const unsigned char* rm = row_mask + (size_t)s * R;
  const unsigned char* cm = col_mask + (size_t)s * C;
  float* ws = w_t + (size_t)s * C * R;  // ws[j * R + r] = w[r, j]
  const float th = thresh[s];

  // w, and the largest finite w (0 when there is none)
  float local_max = 0.0f;
  for (int i = tid; i < R * C; i += kThreads) {
    const int r = i / C;
    const int j = i - r * C;
    float w = __fsub_rn(th, cs[i]);
    w = (rm[r] && cm[j] && w > 0.0f) ? w : -INFINITY;
    ws[j * R + r] = w;
    if (isfinite(w)) local_max = fmaxf(local_max, w);
  }
  local_max = warp_max(local_max);
  if ((tid & 31) == 0) warp_best[tid >> 5] = local_max;
  for (int r = tid; r < R; r += kThreads) r2c[r] = rm[r] ? -1 : -2;
  for (int j = tid; j < C; j += kThreads) {
    prices[j] = 0.0f;
    owner[j] = -1;
  }
  __syncthreads();
  float w_max = warp_best[0];
  for (int i = 1; i < kThreads / 32; ++i) w_max = fmaxf(w_max, warp_best[i]);
  const float eps = __fmul_rn(fmaxf(w_max, 1e-2f), 1e-4f);

  int it = 0;
  while (true) {
    int pending = 0;
    for (int r = tid; r < R; r += kThreads) pending |= (r2c[r] == -1);
    // uniform across the block, so every thread leaves together
    if (!__syncthreads_or(pending) || it >= max_iters) break;

    // rows: best and second-best net value, bid
    for (int r = tid; r < R; r += kThreads) {
      int js = -1;
      if (r2c[r] == -1) {
        float b1 = -INFINITY, b2 = -INFINITY;
        int arg = 0;
        for (int j = 0; j < C; ++j) {
          const float v = __fsub_rn(ws[j * R + r], prices[j]);
          if (v > b1) {
            b2 = b1;
            b1 = v;
            arg = j;
          } else if (v > b2) {
            b2 = v;
          }
        }
        const float second = fmaxf(isfinite(b2) ? b2 : 0.0f, 0.0f);
        if (b1 < 0.0f) {
          r2c[r] = -3;  // the dummy beats every real option: retire
        } else {
          js = arg;
          bid[r] = __fadd_rn(__fadd_rn(prices[arg], __fsub_rn(b1, second)), eps);
        }
      }
      jstar[r] = js;
    }
    __syncthreads();

    // columns: highest bid wins, ties to the lowest row; dethrone the owner
    int win[kColsPerThread];
    float best[kColsPerThread];
    for (int c = 0; c < kColsPerThread; ++c) {
      const int j = tid + c * kThreads;
      win[c] = -1;
      best[c] = -INFINITY;
      if (j < C) {
        for (int r = 0; r < R; ++r) {
          if (jstar[r] == j && bid[r] > best[c]) {
            best[c] = bid[r];
            win[c] = r;
          }
        }
        if (win[c] >= 0 && owner[j] >= 0) r2c[owner[j]] = -1;
      }
    }
    __syncthreads();
    // install winners (a row bids on one column, so no two columns share one)
    for (int c = 0; c < kColsPerThread; ++c) {
      const int j = tid + c * kThreads;
      if (win[c] >= 0) {
        r2c[win[c]] = j;
        owner[j] = win[c];
        prices[j] = best[c];
      }
    }
    __syncthreads();
    ++it;
  }

  int unfinished = 0;
  for (int r = tid; r < R; r += kThreads) {
    const int v = r2c[r];
    unfinished |= (v == -1);
    r2c_out[(size_t)s * R + r] = v >= 0 ? v : -1;
  }
  if (__syncthreads_or(unfinished) && tid == 0) capped[s] += 1;
}

}  // namespace

extern "C" int bmt_auction(const void* cost, const void* row_mask, const void* col_mask,
                           void* w_scratch, void* r2c, void* capped, const void* thresh,
                           int S, int R, int C, int max_iters, void* stream) {
  if (R > kMaxRows || C > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    auction_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cost), static_cast<const unsigned char*>(row_mask),
        static_cast<const unsigned char*>(col_mask), static_cast<float*>(w_scratch),
        static_cast<int*>(r2c), static_cast<int*>(capped), static_cast<const float*>(thresh),
        R, C, max_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
