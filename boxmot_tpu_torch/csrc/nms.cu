// Greedy non-maximum suppression (kernel K6): the detector's NMS in one
// launch, with no host read of the loop's condition.
//
// Replaces boxmot_tpu/ops/nms.py::nms (no Pallas kernel: a lax.while_loop
// over a dense N x N IoU matrix, 2.2 GB at YOLOX's N = 23,625 anchors of an
// 800 x 1440 input).  Semantics, equal bit for bit to the plain twin
// (ops/nms.py::nms_plain) and to the JAX loop:
//   * alive = score >= FLT_MIN: a NaN, -inf, zero, negative or subnormal
//     score is never kept (XLA flushes subnormals to zero on the TPU and the
//     CPU, so the JAX loop reads a subnormal score as 0);
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
// The greedy loop is a scan in sorted order: order the alive candidates by
// (score descending, index ascending); a candidate is kept when fewer than
// max_out are kept and no kept box suppresses it.  Design (one block of 1024
// threads, nms_sorted_scan):
//   1. Keys.  Candidate i's key is (score bits << 32) | ~i: for positive
//      floats the bits order as the values, and the low word sends a tie to
//      the lower index.  Keys are unique, so "the largest key first" is the
//      scan's order.
//   2. Tiers.  The scan rarely reaches far down the order (on a YOLOX frame
//      a few hundred of 23,625 candidates), so the block never sorts all N.
//      A tier is the alive keys in [lo, hi): a radix select finds lo so that
//      the tier holds at least `target` keys (all if fewer remain) and at
//      most 2 x target.  One pass gives the count, min and max of the keys
//      below hi; while more than 2 x target remain, a pass histograms the 11
//      bits below the range's highest differing bit and keeps the bin where
//      the target is crossed.  The tier is compacted into shared memory and
//      sorted there, descending: runs of 32 in a warp's registers, then
//      merge rounds.  The next tier takes the keys below lo, with a doubled
//      target (at most 2048).
//   3. Chunks.  A tier is scanned in chunks of c candidates (c = max_out
//      still to keep, rounded up to a power of two, 32..1024; doubled after
//      a chunk that kept nothing), 1024 / c threads a candidate.  Each
//      candidate is tested against every box kept so far (shared memory for
//      the first 1024, then through keep_idx) until one suppresses it; the
//      survivors are compacted in order.
//   4. Survivors, at most 256 at a time: they are tested against the boxes
//      kept by earlier groups of the chunk, then the IoU mask of every pair
//      (i < j) of those still available is computed by the whole block (a
//      bit: i suppresses j), and one warp walks it a 32-candidate word at a
//      time: the candidates of a word that suppress none of the word's later
//      candidates are kept together; only the others are resolved one by
//      one; the kept candidates' rows are ORed out of the later words.
// The work is the candidates examined times the boxes kept before them, not
// the steps times the anchors; no N x N matrix is formed, the kernel
// allocates nothing, and every call is one launch.
//
// Bound on this card.  A call must read the boxes and scores (N x 20 bytes,
// 0.47 MB at N = 23,625, 0.14 us at 3.35 TB/s) and write max_out x 5 bytes;
// the sorted definition's IoUs (each candidate examined against the boxes
// kept before it) are far below the card's rate.  The decisions form a
// chain of up to max_out dependent steps on one SM, so the kernel stays far
// from that bound.

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kUnionEps = 1e-12f;           // iou_batch's clamp
constexpr float kMinNormal = 1.17549435e-38f;  // FLT_MIN: smaller scores are flushed
constexpr int kDigitBits = 11;                 // a radix pass's digit
constexpr int kBins = 1 << kDigitBits;
constexpr int kTierMin = 64;  // the first tier's target, at least
constexpr int kTierMax = 2048;  // a tier's target, at most
constexpr int kTierCap = 2 * kTierMax;  // keys a tier may hold
constexpr int kChunkMin = 32;
constexpr int kChunkMax = kThreads;
constexpr int kSub = 256;  // survivors resolved by one mask
constexpr int kSubWords = kSub / 32;
constexpr int kKeptCache = 1024;  // kept boxes held in shared memory

struct Smem {
  u64 keys[kTierCap];           // the tier
  u64 merged[kTierCap];         // the tier's merge rounds: one of the two holds it sorted
  unsigned hist[kBins];
  float4 sbox[kChunkMax];       // a chunk's survivors, in order
  float sarea[kChunkMax];
  int sidx[kChunkMax];
  unsigned mask[kSub][kSubWords];  // bit j of row i: survivor i suppresses j
  float4 kbox[kKeptCache];      // the first kept boxes
  unsigned char flag[kChunkMax];
  unsigned avail[kSubWords];    // survivors not suppressed by a kept box
  unsigned intra[kSubWords];    // survivors that suppress one of their word
  unsigned wsum[kWarps + 1];
  u64 red_min[kWarps], red_max[kWarps];
  unsigned red_cnt[kWarps];
  unsigned sel_bin, sel_above, sel_cnt, n_tier;
  int n_kept;
};

// PyTorch's NaN-propagating maximum, minimum and clamp_min (max.NaN: a NaN
// operand gives NaN, where fmaxf and fminf would return the other one).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float area(const float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// iou_batch(a, b) > thresh for one pair, given the boxes' areas: a is the
// kept box (boxes1), b the candidate.  A zero intersection skips the
// division: 0 / u is a zero for every union but NaN, whose quotient is NaN
// (a zero's sign cannot change the comparison).
__device__ __forceinline__ bool suppresses(const float4 a, float area_a, const float4 b,
                                           float area_b, float thresh) {
  const float xx1 = max_nan(a.x, b.x);
  const float yy1 = max_nan(a.y, b.y);
  const float xx2 = min_nan(a.z, b.z);
  const float yy2 = min_nan(a.w, b.w);
  const float wh =
      __fmul_rn(max_nan(__fsub_rn(xx2, xx1), 0.0f), max_nan(__fsub_rn(yy2, yy1), 0.0f));
  const float uni = max_nan(__fsub_rn(__fadd_rn(area_a, area_b), wh), kUnionEps);
  if (wh == 0.0f) return !isnan(uni) && 0.0f > thresh;
  return __fdiv_rn(wh, uni) > thresh;
}
__device__ __forceinline__ bool suppresses(const float4 a, const float4 b, float thresh) {
  return suppresses(a, area(a), b, area(b), thresh);
}

constexpr int kUnroll = 8;  // scores a thread takes a round of a pass over N

// Round i0 of a pass over the scores: thread t's 8 scores, two 16-byte
// loads (i0 + 4 t and i0 + 4096 + 4 t, four each) issued before any is
// used, and their indices; past N a score is 0 (not alive).  The scores
// are 16-byte aligned (the wrapper sees to it).
__device__ __forceinline__ void load_round(const float* __restrict__ scores, int N, int i0,
                                           float (&s)[kUnroll], int (&idx)[kUnroll]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + h * 4 * kThreads + 4 * static_cast<int>(threadIdx.x);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i + 3 < N) {
      v = __ldg(reinterpret_cast<const float4*>(scores + i));
    } else if (i < N) {
      v.x = __ldg(scores + i);
      if (i + 1 < N) v.y = __ldg(scores + i + 1);
      if (i + 2 < N) v.z = __ldg(scores + i + 2);
    }
    s[4 * h] = v.x;
    s[4 * h + 1] = v.y;
    s[4 * h + 2] = v.z;
    s[4 * h + 3] = v.w;
#pragma unroll
    for (int u = 0; u < 4; ++u) idx[4 * h + u] = i + u;
  }
}

// Candidate i's key: (score bits << 32) | ~i; alive: the score is at least
// FLT_MIN (NaN is not).
__device__ __forceinline__ u64 key_of(float score, int i) {
  return (static_cast<u64>(__float_as_uint(score)) << 32) | static_cast<unsigned>(~i);
}
__device__ __forceinline__ bool alive_at(float score, int i, int N) {
  return i < N && score >= kMinNormal;
}

// f(key, alive) for every candidate, a round of 8 a thread at a time.  The
// trip count is the same in every warp, so f may use warp-wide votes; a lane
// past N calls f with alive false.
template <typename F>
__device__ __forceinline__ void for_each_key(const float* __restrict__ scores, int N, F f) {
  for (int i0 = 0; i0 < N; i0 += kUnroll * kThreads) {
    float s[kUnroll];
    int idx[kUnroll];
    load_round(scores, N, i0, s, idx);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f(key_of(s[u], idx[u]), alive_at(s[u], idx[u], N));
  }
}

__device__ __forceinline__ int pow2_at_least(int v) {
  return v <= 1 ? 1 : 1 << (32 - __clz(v - 1));
}

// The threads of one candidate's group (g consecutive lanes, g a power of
// two up to 32) within the warp's ballot.
__device__ __forceinline__ unsigned group_bits(int lane, int g) {
  return g == 32 ? kFull : ((1u << g) - 1) << (lane & ~(g - 1));
}

// Exclusive prefix sum of v over the block; total gets the sum.
__device__ unsigned block_scan(Smem& sm, unsigned v, unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sm.wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned s = sm.wsum[lane];
    unsigned si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, si, o);
      if (lane >= o) si += y;
    }
    sm.wsum[lane] = si - s;
    if (lane == 31) sm.wsum[kWarps] = si;
  }
  __syncthreads();
  const unsigned off = sm.wsum[warp] + inc - v;
  total = sm.wsum[kWarps];
  __syncthreads();
  return off;
}

// Count, min and max of the alive keys below hi, over the block.
__device__ void count_below(Smem& sm, const float* __restrict__ scores, int N, u64 hi,
                            unsigned& count, u64& mn, u64& mx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned c = 0;
  u64 lo_k = ~0ull, hi_k = 0;
  for_each_key(scores, N, [&](u64 k, bool alive) {
    if (alive && k < hi) {
      ++c;
      lo_k = min(lo_k, k);
      hi_k = max(hi_k, k);
    }
  });
  c = __reduce_add_sync(kFull, c);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo_k = min(lo_k, __shfl_xor_sync(kFull, lo_k, o));
    hi_k = max(hi_k, __shfl_xor_sync(kFull, hi_k, o));
  }
  if (lane == 0) {
    sm.red_cnt[warp] = c;
    sm.red_min[warp] = lo_k;
    sm.red_max[warp] = hi_k;
  }
  __syncthreads();
  if (warp == 0) {
    c = __reduce_add_sync(kFull, sm.red_cnt[lane]);
    lo_k = sm.red_min[lane];
    hi_k = sm.red_max[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo_k = min(lo_k, __shfl_xor_sync(kFull, lo_k, o));
      hi_k = max(hi_k, __shfl_xor_sync(kFull, hi_k, o));
    }
    if (lane == 0) {
      sm.red_cnt[0] = c;
      sm.red_min[0] = lo_k;
      sm.red_max[0] = hi_k;
    }
  }
  __syncthreads();
  count = sm.red_cnt[0];
  mn = sm.red_min[0];
  mx = sm.red_max[0];
  __syncthreads();
}

// The tier below hi: lo such that the alive keys in [lo, hi) number at
// least `target` (all of them if fewer) and at most 2 x target.  Returns the
// count below hi (0: nothing is alive below hi).
__device__ unsigned select_tier(Smem& sm, const float* __restrict__ scores, int N, u64 hi,
                                unsigned target, u64& lo) {
  const int t = threadIdx.x, lane = t & 31;
  unsigned total;
  u64 rlo, rhi;
  count_below(sm, scores, N, hi, total, rlo, rhi);
  if (total <= 2 * target) {
    lo = 0;
    return total;
  }
  unsigned above = 0;  // keys in [rhi + 1, hi): ahead of the range, in the tier
  while (true) {
    // rlo != rhi: more than 2 x target keys lie in [rlo, rhi]
    const int top = 63 - __clzll(rlo ^ rhi);
    const int shift = top >= kDigitBits - 1 ? top - (kDigitBits - 1) : 0;
    const u64 base = rlo >> shift;
    for (int b = t; b < kBins; b += kThreads) sm.hist[b] = 0;
    __syncthreads();
    for_each_key(scores, N, [&](u64 k, bool alive) {
      const unsigned bin =
          alive && k < hi && k >= rlo && k <= rhi ? static_cast<unsigned>((k >> shift) - base)
                                                  : kFull;
      const unsigned b0 = __shfl_sync(kFull, bin, 0);
      if (__all_sync(kFull, bin == b0)) {  // one bin (equal scores): one add
        if (lane == 0 && b0 != kFull) atomicAdd(&sm.hist[b0], 32u);
      } else if (bin != kFull) {
        atomicAdd(&sm.hist[bin], 1u);
      }
    });
    __syncthreads();
    // bins from the largest keys down: thread t owns bins kBins-1-2t, kBins-2-2t
    const unsigned h0 = sm.hist[kBins - 1 - 2 * t], h1 = sm.hist[kBins - 2 - 2 * t];
    unsigned sum;
    const unsigned before = block_scan(sm, h0 + h1, sum);
    const unsigned want = target - above;  // >= 1
    if (before < want && before + h0 >= want) {
      sm.sel_bin = kBins - 1 - 2 * t;
      sm.sel_above = above + before;
      sm.sel_cnt = h0;
    } else if (before + h0 < want && before + h0 + h1 >= want) {
      sm.sel_bin = kBins - 2 - 2 * t;
      sm.sel_above = above + before + h0;
      sm.sel_cnt = h1;
    }
    __syncthreads();
    const unsigned bin = sm.sel_bin, at = sm.sel_above, cnt = sm.sel_cnt;
    __syncthreads();
    const u64 blo = max((base + bin) << shift, rlo);
    const u64 bhi = min(((base + bin) << shift) + ((1ull << shift) - 1), rhi);
    if (at + cnt <= 2 * target) {
      lo = blo;
      return total;
    }
    above = at;
    rlo = blo;
    rhi = bhi;
  }
}

__device__ __forceinline__ u64 pick(u64 mine, u64 other, bool keep_max) {
  return keep_max ? max(mine, other) : min(mine, other);
}

// Sort the tier's n keys (sm.keys[0, n)) descending, into sm.keys or
// sm.merged (the pointer returned), P = max(32, 2^ceil(log2 n)) of them,
// padded with the distinct keys P - 1 - q (a real key is at least 2^55), so
// that no two keys tie in a merge.  Position e * 1024 + t is thread t's: each
// warp sorts its runs of 32 in registers (a bitonic network of shuffles),
// then rounds merge runs pairwise through shared memory, each key finding
// its place by a binary search in the other run (keys are unique): log2(P /
// 32) rounds of one barrier.
__device__ const u64* sort_tier(Smem& sm, int n) {
  const int t = threadIdx.x;
  const int P = max(pow2_at_least(n), 32);
  const int E = (P + kThreads - 1) / kThreads;  // keys a thread: 1, 2 or 4
  u64 v[kTierCap / kThreads];
#pragma unroll
  for (int e = 0; e < kTierCap / kThreads; ++e) {
    const int q = e * kThreads + t;
    v[e] = q < n ? sm.keys[q] : static_cast<u64>(max(P - 1 - q, 0));
  }
  for (int k = 2; k <= 32; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < kTierCap / kThreads; ++e) {
        if (e < E) {
          const int q = e * kThreads + t;
          const bool desc = k == 32 || !(q & k);  // every run of 32 ends descending
          v[e] = pick(v[e], __shfl_xor_sync(kFull, v[e], j), !(q & j) == desc);
        }
      }
    }
  }
  u64* a = sm.keys;
  u64* b = sm.merged;
#pragma unroll
  for (int e = 0; e < kTierCap / kThreads; ++e) {
    const int q = e * kThreads + t;
    if (e < E && q < P) a[q] = v[e];
  }
  __syncthreads();
  for (int L = 32; L < P; L <<= 1) {
#pragma unroll
    for (int e = 0; e < kTierCap / kThreads; ++e) {
      const int q = e * kThreads + t;
      if (e < E && q < P) {
        const u64 x = a[q];
        const int r = q / L, i = q - r * L;
        const u64* other = a + (r ^ 1) * L;
        int lo = 0, len = L;  // the keys of the other run above x
        while (len > 0) {
          const int half = len >> 1;
          if (other[lo + half] > x) {
            lo += half + 1;
            len -= half + 1;
          } else {
            len = half;
          }
        }
        b[(r & ~1) * L + i + lo] = x;
      }
    }
    __syncthreads();
    u64* c = a;
    a = b;
    b = c;
  }
  return a;
}

__global__ void __launch_bounds__(kThreads, 1)
    nms_sorted_scan(const float4* __restrict__ boxes, const float* __restrict__ scores, int N,
                    float iou_thresh, int max_out, int* keep_idx, unsigned char* keep_mask,
                    unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (int j = t; j < max_out; j += kThreads) {
    keep_idx[j] = -1;
    keep_mask[j] = 0;
  }
  __syncthreads();

  // kept box k: shared memory for the first kKeptCache, then through keep_idx
  auto kept_box = [&](int k) {
    return k < kKeptCache ? sm.kbox[k] : __ldg(&boxes[keep_idx[k]]);
  };

  unsigned long long n_iou = 0;
  int n_kept = 0;
  u64 hi = ~0ull;
  unsigned target = min(max(pow2_at_least(2 * min(max_out, kTierMax)), kTierMin), kTierMax);
  while (n_kept < max_out) {
    u64 lo;
    const unsigned below = select_tier(sm, scores, N, hi, target, lo);
    if (below == 0) break;
    // compact the tier's keys (any order), then sort them descending
    if (t == 0) sm.n_tier = 0;
    __syncthreads();
    for (int i0 = 0; i0 < N; i0 += kUnroll * kThreads) {  // a warp reserves once a round
      float sc[kUnroll];
      int idx[kUnroll];
      load_round(scores, N, i0, sc, idx);
      u64 k[kUnroll];
      unsigned bal[kUnroll], n_in = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        k[u] = key_of(sc[u], idx[u]);
        bal[u] = __ballot_sync(kFull, alive_at(sc[u], idx[u], N) && k[u] >= lo && k[u] < hi);
        n_in += __popc(bal[u]);
      }
      if (n_in == 0) continue;
      unsigned off = 0;
      if (lane == 0) off = atomicAdd(&sm.n_tier, n_in);
      off = __shfl_sync(kFull, off, 0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if ((bal[u] >> lane) & 1u) sm.keys[off + __popc(bal[u] & ((1u << lane) - 1))] = k[u];
        off += __popc(bal[u]);
      }
    }
    __syncthreads();
    const int n_tier = static_cast<int>(sm.n_tier);
    const u64* tier = sort_tier(sm, n_tier);

    int boost = 0;
    for (int pos = 0; pos < n_tier && n_kept < max_out;) {
      // 3. a chunk: each candidate against every box kept so far
      const int c = max(max(pow2_at_least(min(max_out - n_kept, kChunkMax)), kChunkMin), boost);
      const int g = kThreads / c;
      const int j = t / g, r = t & (g - 1);
      const bool valid = pos + j < n_tier;
      bool sup = false;
      if (valid) {
        const float4 box = __ldg(&boxes[static_cast<int>(~static_cast<unsigned>(tier[pos + j]))]);
        for (int k = r; k < n_kept; k += g) {
          ++n_iou;
          if (suppresses(kept_box(k), box, iou_thresh)) {
            sup = true;
            break;
          }
        }
      }
      const unsigned bal = __ballot_sync(kFull, sup);
      if (r == 0) sm.flag[j] = valid && !(bal & group_bits(lane, g));
      __syncthreads();
      const bool f = t < c && sm.flag[t];
      unsigned S;
      const unsigned off = block_scan(sm, f ? 1u : 0u, S);
      if (f) {
        const int idx = static_cast<int>(~static_cast<unsigned>(tier[pos + t]));
        const float4 box = __ldg(&boxes[idx]);
        sm.sidx[off] = idx;
        sm.sbox[off] = box;
        sm.sarea[off] = area(box);
      }
      __syncthreads();

      // 4. the survivors, kSub at a time
      const int n0 = n_kept;
      for (int s0 = 0; s0 < static_cast<int>(S) && n_kept < max_out;) {
        const int w = min(static_cast<int>(S) - s0,
                          max(kChunkMin, pow2_at_least(min(max_out - n_kept, kSub))));
        const int nw = (w + 31) >> 5;
        for (int q = t; q < w * kSubWords; q += kThreads) (&sm.mask[0][0])[q] = 0;
        if (t < kSubWords) {
          sm.avail[t] = 0;
          sm.intra[t] = 0;
        }
        __syncthreads();
        {  // against the boxes kept by this chunk's earlier groups
          const int gg = kThreads / max(kChunkMin, pow2_at_least(w));
          const int jj = t / gg, rr = t & (gg - 1);
          bool s = false;
          if (jj < w) {
            const float4 box = sm.sbox[s0 + jj];
            for (int k = n0 + rr; k < n_kept; k += gg) {
              ++n_iou;
              if (suppresses(kept_box(k), box, iou_thresh)) {
                s = true;
                break;
              }
            }
          }
          const unsigned b = __ballot_sync(kFull, s);
          if (jj < w && rr == 0 && !(b & group_bits(lane, gg)))
            atomicOr(&sm.avail[jj >> 5], 1u << (jj & 31));
        }
        __syncthreads();
        // the mask, pairs (i < j) of available survivors: thread t takes
        // columns c = t % 128 and w - 1 - c (about the same number of rows
        // i between them) and rows i = t / 128 + 8 m
        {
          const int c = t & 127, r = t >> 7;
          const unsigned* av = sm.avail;
          for (int h = 0; h < 2; ++h) {
            const int j = h == 0 ? c : w - 1 - c;
            if (j >= w || (h == 0 ? c >= (w + 1) / 2 : j <= c)) continue;
            if (!((av[j >> 5] >> (j & 31)) & 1u)) continue;
            const float4 bj = sm.sbox[s0 + j];
            const float aj = sm.sarea[s0 + j];
            for (int i = r; i < j; i += 8) {
              if (!((av[i >> 5] >> (i & 31)) & 1u)) continue;
              ++n_iou;
              if (suppresses(sm.sbox[s0 + i], sm.sarea[s0 + i], bj, aj, iou_thresh)) {
                atomicOr(&sm.mask[i][j >> 5], 1u << (j & 31));
                if ((i >> 5) == (j >> 5)) atomicOr(&sm.intra[i >> 5], 1u << (i & 31));
              }
            }
          }
        }
        __syncthreads();
        if (warp == 0) {  // the walk, a word at a time
          unsigned av = lane < nw ? sm.avail[lane] : 0u;
          int n = n_kept;
          for (int W = 0; W < nw && n < max_out; ++W) {
            const unsigned aw = __shfl_sync(kFull, av, W);
            if (!aw) continue;
            const unsigned nz = sm.intra[W];
            unsigned kept = 0, rem = aw;
            while (true) {
              const unsigned cand = rem & nz;
              if (!cand) {
                kept |= rem;
                break;
              }
              const int p = __ffs(cand) - 1;
              const unsigned upto = (2u << p) - 1;  // bits 0..p
              kept |= rem & upto;
              rem &= ~upto & ~sm.mask[W * 32 + p][W];
            }
            int take = __popc(kept);
            if (take > max_out - n) {
              take = max_out - n;
              while (__popc(kept) > take) kept &= ~(0x80000000u >> __clz(kept));
            }
            const bool mine = (kept >> lane) & 1u;
            if (mine) {
              const int q = s0 + W * 32 + lane;
              const int at = n + __popc(kept & ((1u << lane) - 1));
              keep_idx[at] = sm.sidx[q];
              keep_mask[at] = 1;
              if (at < kKeptCache) sm.kbox[at] = sm.sbox[q];
            }
            // the later words lose what the kept candidates suppress: lane b
            // reads kept candidate b's row, the warp ORs the rows a word
            for (int l = W + 1; l < nw; ++l) {
              const unsigned m = __reduce_or_sync(kFull, mine ? sm.mask[W * 32 + lane][l] : 0u);
              if (lane == l) av &= ~m;
            }
            n += take;
          }
          if (lane == 0) sm.n_kept = n;
        }
        __syncthreads();
        n_kept = sm.n_kept;
        s0 += w;
      }
      boost = n_kept == n0 ? min(2 * c, kChunkMax) : 0;
      pos += c;
    }
    if (below <= 2 * target) break;  // the tier held every alive key below hi
    hi = lo;
    target = min(2 * target, static_cast<unsigned>(kTierMax));
  }
  if (counts != nullptr) {
    n_iou += __shfl_xor_sync(kFull, n_iou, 16);
    n_iou += __shfl_xor_sync(kFull, n_iou, 8);
    n_iou += __shfl_xor_sync(kFull, n_iou, 4);
    n_iou += __shfl_xor_sync(kFull, n_iou, 2);
    n_iou += __shfl_xor_sync(kFull, n_iou, 1);
    if (lane == 0) atomicAdd(counts, n_iou);
  }
}

}  // namespace

// boxes: (N, 4) float32 xyxy; scores: (N,) float32; both 16-byte aligned;
// keep_idx: (max_out,) int32; keep_mask: (max_out,) bool (one byte each);
// counts: null, or one uint64 to which the IoUs evaluated are added.  All
// contiguous, on the stream's card.
extern "C" int bmt_nms(const void* boxes, const void* scores, int N, float iou_thresh,
                       int max_out, void* keep_idx, void* keep_mask, void* counts, void* stream) {
  if (N < 0 || max_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (max_out == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(Smem);
  const cudaError_t err = cudaFuncSetAttribute(
      nms_sorted_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sorted_scan<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), N, iou_thresh,
      max_out, static_cast<int*>(keep_idx), static_cast<unsigned char*>(keep_mask),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
