// Batched Viterbi relaxation over an incoming-arc table, for Hopper.
//
// Replaces the Pallas TPU kernel of kaldi_tpu/ops/pallas_viterbi.py,
// pallas_relax (body :82-91, pallas_call :93-106), and serves the two
// relaxations of kaldi_tpu/decoder/batched_viterbi.py, _viterbi_device:
//
//   emitting (:141-149), for every lane b and state s < S:
//     out[b, s] = min_k (cost[b, in_src[s, k]] + in_w[s, k])
//                       - scale * ll[b, in_pdf[s, k]]
//   closure (:130-137), over the epsilon table, no acoustic term:
//     out[b, s] = min(cost[b, s], min_k cost[b, in_src[s, k]] + in_w[s, k])
//
// cost is (B, S+1) with a dead column S that the caller keeps at INF =
// 1e30; the tables are padded to K slots a state, live slots first, and a
// dead slot carries src = S, w = INF, pdf = 0, so its candidate is finite
// and needs no branch.  When the output has S+1 columns the kernel also
// writes the dead column: INF after an emitting step, the old value after
// a closure step.  Tables are (S, K) shared by all lanes (lane_stride 0)
// or (B, S, K), one a lane (lane_stride S*K).  cost, ll and out are
// addressed through element strides; the decoder keeps them lanes-fastest.
//
// What bounds it.  The padding exists because the TPU wants a rectangular
// gather and min: K is the largest in-degree rounded up to a power of two,
// and on a lexicon graph under 2% of the slots are live.  Walking every
// slot (the first version, `relax`, kept below and taken when in_deg is
// null) buys S*K*B candidates with two gathers each and sits at a few
// percent of its traffic bound.  The compulsory work is the live slots
// (12 bytes each, read once), the cost row in and out and the loglikes:
// bytes, not operations, and all of them fit the 50 MB L2.  A launch is
// then some ten microseconds long, and what decides it is latency: the
// chain count -> table entry -> gather that every state walks, and the
// few states with many in-arcs (the word roots of a lexicon graph), whose
// walk one warp would take longer over than the rest of the grid takes.
//
// What the design (`relax_live`) does about it:
//   * in_deg[s] (or in_deg[b, s]) counts the state's live slots.  A state
//     with deg < K evaluates its live prefix and ONE dead candidate: all
//     dead slots of a state hold the triple (S, INF, 0) and give the same
//     candidate, and min is exact in any order, so the result equals the
//     walk over all K slots bit for bit, for every finite input and with
//     no condition on ll[b, 0].
//   * lanes fastest: a warp is 32 lane groups of one state, so a table
//     entry is a broadcast, the loop does not diverge for shared tables,
//     and each gather reads neighbouring lanes.  When the lane strides are
//     1, B is a multiple of 4 and the rows are 16-byte aligned, a thread
//     takes 4 lanes with one 16-byte load a gather.
//   * slots go in batches of kBatch: all table entries of a batch are
//     loaded, then all gathers, then the min chain, so kBatch independent
//     gathers are in flight.  The first batch's entries are loaded before
//     the count is looked at, which takes one round trip out of the chain.
//     A batch that reaches past the walk repeats a candidate (min is
//     idempotent), so there is no remainder loop.
//   * the tail: a state whose walk is longer than long_walk positions gets
//     a block to itself, its kTile warps each taking every kTile-th batch
//     and folding through shared memory, and these blocks come first in
//     the grid, so the long walks run beside everything else.  The caller
//     lists those states once (shared tables only; with one table a lane
//     each lane walks to its own count).  Sharing a long state among the
//     warps of its own tile instead was slower than not sharing: the long
//     states of a lexicon graph are neighbours, and a tile then takes
//     them one after the other.
//
// Arithmetic: the plain version computes (prev + w) - (scale * ac) with
// three roundings.  nvcc would contract the multiply into the subtraction
// (an FMA, one rounding fewer), so the candidate is spelled with
// __fadd_rn / __fmul_rn / __fsub_rn, which are never contracted: the
// result equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr float kInf = 1e30f;

// The first version: one thread per (state, lane) walks all K slots.
template <bool kClosure>
__global__ void relax(const float* __restrict__ cost, long long cs_b,
                      long long cs_s, const int* __restrict__ in_src,
                      const float* __restrict__ in_w,
                      const int* __restrict__ in_pdf, long long lane_stride,
                      const float* __restrict__ ll, long long ls_b,
                      long long ls_p, float scale, float* __restrict__ out,
                      long long os_b, long long os_s, int B, int S, int K,
                      int out_cols) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)out_cols * B) return;
  const int b = (int)(idx % B);
  const int s = (int)(idx / B);
  const float* crow = cost + (long long)b * cs_b;
  float* orow = out + (long long)b * os_b;
  if (s == S) {                       // the dead column
    orow[(long long)S * os_s] = kClosure ? crow[(long long)S * cs_s] : kInf;
    return;
  }
  const long long tab = (long long)b * lane_stride + (long long)s * K;
  const int* src = in_src + tab;
  const float* w = in_w + tab;
  float best = CUDART_INF_F;
  if (kClosure) {
    best = crow[(long long)s * cs_s];
#pragma unroll 4
    for (int k = 0; k < K; ++k)
      best = fminf(best, __fadd_rn(crow[(long long)src[k] * cs_s], w[k]));
  } else {
    const int* pdf = in_pdf + tab;
    const float* lrow = ll + (long long)b * ls_b;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float prev = crow[(long long)src[k] * cs_s];
      const float ac = lrow[(long long)pdf[k] * ls_p];
      best = fminf(best, __fsub_rn(__fadd_rn(prev, w[k]),
                                   __fmul_rn(scale, ac)));
    }
  }
  orow[(long long)s * os_s] = best;
}

// The live walk.
constexpr int kTile = 8;              // states a block, one warp each
constexpr int kBatch = 4;             // gathers in flight a thread

template <int V>
struct Lanes {                        // V neighbouring lanes of one state
  float v[V];
};

template <int V>
__device__ __forceinline__ Lanes<V> load_lanes(const float* p) {
  Lanes<V> r;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_lanes(float* p, const Lanes<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else {
    *p = r.v[0];
  }
}

template <int V>
__device__ __forceinline__ Lanes<V> all_lanes(float x) {
  Lanes<V> r;
#pragma unroll
  for (int v = 0; v < V; ++v) r.v[v] = x;
  return r;
}

struct Rows {                         // a thread's lanes of cost and ll
  const float* crow;
  long long cs_s;
  const float* lrow;
  long long ls_p;
  float scale;
};

struct Entries {                      // kBatch table entries of one state
  int src[kBatch], pdf[kBatch];
  float w[kBatch];
};

// The entries of walk positions j0 .. j0 + kBatch - 1, read before deg is
// looked at (slot min(j, K-1) always exists), so that the load of deg and
// the loads of the entries are in flight together.
template <bool kClosure>
__device__ __forceinline__ Entries load_entries(
    const int* __restrict__ src, const float* __restrict__ w,
    const int* __restrict__ pdf, int j0, int K) {
  Entries e;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int k = min(j0 + i, K - 1);
    e.src[i] = src[k];
    e.w[i] = w[k];
    e.pdf[i] = kClosure ? 0 : pdf[k];
  }
  return e;
}

// best = min(best, candidates of walk positions j0 .. j0 + kBatch - 1).
// The walk of a state has deg + (deg < K) positions: the live slots, then
// one dead slot for all the dead ones.  A position past the live prefix
// takes the dead triple (S, INF, 0), which is what every slot from deg on
// holds, or, when the state has no dead slot, the live slot K-1 again (min
// is idempotent): so there is no remainder loop.
template <bool kClosure, int V>
__device__ __forceinline__ void relax_batch(const Rows& r, Entries e, int j0,
                                            int deg, int S, int K,
                                            Lanes<V>& best) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (j0 + i >= deg && deg < K) {
      e.src[i] = S;
      e.w[i] = kInf;
      e.pdf[i] = 0;
    }
  }
  Lanes<V> prev[kBatch], ac[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    prev[i] = load_lanes<V>(r.crow + (long long)e.src[i] * r.cs_s);
    if constexpr (!kClosure)
      ac[i] = load_lanes<V>(r.lrow + (long long)e.pdf[i] * r.ls_p);
  }
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float c = __fadd_rn(prev[i].v[v], e.w[i]);
      if constexpr (!kClosure)
        c = __fsub_rn(c, __fmul_rn(r.scale, ac[i].v[v]));
      best.v[v] = fminf(best.v[v], c);
    }
  }
}

// Block (32, kTile): threadIdx.x a group of V lanes.  Grid (n_long + state
// tiles, groups of 32 * V lanes).  The first n_long blocks take one long
// state each (long_states[blockIdx.x], a walk of more than long_walk
// positions), threadIdx.y a share of its walk; the other blocks take a
// tile of kTile states, threadIdx.y the state, and leave the long ones
// out.
template <bool kClosure, int V>
__global__ void __launch_bounds__(32 * kTile) relax_live(
    const float* __restrict__ cost, long long cs_b, long long cs_s,
    const int* __restrict__ in_src, const float* __restrict__ in_w,
    const int* __restrict__ in_pdf, const int* __restrict__ in_deg,
    const int* __restrict__ long_states, int n_long, int long_walk,
    long long lane_stride, const float* __restrict__ ll, long long ls_b,
    long long ls_p, float scale, float* __restrict__ out, long long os_b,
    long long os_s, int B, int S, int K, int out_cols) {
  const int x = threadIdx.x, y = threadIdx.y;
  const int b = (blockIdx.y * 32 + x) * V;
  const bool lane_ok = b < B;         // B % V == 0: all V lanes or none
  Rows r;
  r.crow = cost + (long long)b * cs_b;
  r.cs_s = cs_s;
  r.lrow = ll + (long long)b * ls_b;
  r.ls_p = ls_p;
  r.scale = scale;
  float* orow = out + (long long)b * os_b;

  if (blockIdx.x < n_long) {          // shared tables only
    __shared__ float part[kTile][32 * V];
    const int s = long_states[blockIdx.x];
    const int deg = max(0, min(in_deg[s], K));
    const int n = deg + (deg < K);
    const long long tab = (long long)s * K;
    Lanes<V> acc = all_lanes<V>(CUDART_INF_F);
    if (lane_ok)
      for (int j0 = y * kBatch; j0 < n; j0 += kTile * kBatch)
        relax_batch<kClosure, V>(
            r, load_entries<kClosure>(in_src + tab, in_w + tab, in_pdf + tab,
                                      j0, K),
            j0, deg, S, K, acc);
#pragma unroll
    for (int v = 0; v < V; ++v) part[y][x * V + v] = acc.v[v];
    __syncthreads();
    if (y != 0 || !lane_ok) return;
    if constexpr (kClosure) acc = load_lanes<V>(r.crow + (long long)s * cs_s);
#pragma unroll
    for (int yy = 0; yy < kTile; ++yy)
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc.v[v] = fminf(acc.v[v], part[yy][x * V + v]);
    store_lanes<V>(orow + (long long)s * os_s, acc);
    return;
  }

  const int s = (blockIdx.x - n_long) * kTile + y;
  if (!lane_ok || s >= out_cols) return;
  if (s == S) {                       // the dead column
    store_lanes<V>(orow + (long long)S * os_s,
                   kClosure ? load_lanes<V>(r.crow + (long long)S * cs_s)
                            : all_lanes<V>(kInf));
    return;
  }
  const bool shared_tab = lane_stride == 0;
  int deg = in_deg[shared_tab ? (long long)s : (long long)b * S + s];
  const long long tab = (long long)b * lane_stride + (long long)s * K;
  Entries e = load_entries<kClosure>(in_src + tab, in_w + tab, in_pdf + tab,
                                     0, K);
  Lanes<V> best = all_lanes<V>(CUDART_INF_F);
  if constexpr (kClosure) best = load_lanes<V>(r.crow + (long long)s * cs_s);
  deg = max(0, min(deg, K));
  const int n = deg + (deg < K);
  if (n > long_walk) return;          // a long block writes this state
  relax_batch<kClosure, V>(r, e, 0, deg, S, K, best);
  for (int j0 = kBatch; j0 < n; j0 += kBatch)
    relax_batch<kClosure, V>(
        r, load_entries<kClosure>(in_src + tab, in_w + tab, in_pdf + tab, j0,
                                  K),
        j0, deg, S, K, best);
  store_lanes<V>(orow + (long long)s * os_s, best);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Whether the live walk takes 4 lanes a thread: shared tables, unit lane
// strides, rows aligned to 16 bytes.
bool four_lanes(bool closure, const float* cost, long long cs_b,
                long long cs_s, long long lane_stride, const float* ll,
                long long ls_b, long long ls_p, const float* out,
                long long os_b, long long os_s, int B) {
  return lane_stride == 0 && B % 4 == 0 && cs_b == 1 && os_b == 1 &&
         cs_s % 4 == 0 && os_s % 4 == 0 && aligned16(cost) &&
         aligned16(out) &&
         (closure || (ls_b == 1 && ls_p % 4 == 0 && aligned16(ll)));
}

template <bool kClosure>
void launch(const float* cost, long long cs_b, long long cs_s,
            const int* in_src, const float* in_w, const int* in_pdf,
            const int* in_deg, const int* long_states, int n_long,
            int long_walk, long long lane_stride, const float* ll,
            long long ls_b, long long ls_p, float scale, float* out,
            long long os_b, long long os_s, int B, int S, int K, int out_cols,
            cudaStream_t st) {
  if (in_deg == nullptr) {
    const int threads = 256;
    const long long n = (long long)out_cols * B;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    relax<kClosure><<<blocks, threads, 0, st>>>(
        cost, cs_b, cs_s, in_src, in_w, in_pdf, lane_stride, ll, ls_b, ls_p,
        scale, out, os_b, os_s, B, S, K, out_cols);
    return;
  }
  const bool vec = four_lanes(kClosure, cost, cs_b, cs_s, lane_stride, ll,
                              ls_b, ls_p, out, os_b, os_s, B);
  if (lane_stride != 0) n_long = 0;   // one table a lane: no long blocks
  const int lanes_a_block = 32 * (vec ? 4 : 1);
  const dim3 block(32, kTile);
  const dim3 grid((unsigned)(n_long + (out_cols + kTile - 1) / kTile),
                  (unsigned)((B + lanes_a_block - 1) / lanes_a_block));
  if (n_long == 0) long_walk = K + 1; // no walk is longer: none is left out
  if (vec)
    relax_live<kClosure, 4><<<grid, block, 0, st>>>(
        cost, cs_b, cs_s, in_src, in_w, in_pdf, in_deg, long_states, n_long,
        long_walk, lane_stride, ll, ls_b, ls_p, scale, out, os_b, os_s, B, S,
        K, out_cols);
  else
    relax_live<kClosure, 1><<<grid, block, 0, st>>>(
        cost, cs_b, cs_s, in_src, in_w, in_pdf, in_deg, long_states, n_long,
        long_walk, lane_stride, ll, ls_b, ls_p, scale, out, os_b, os_s, B, S,
        K, out_cols);
}

}  // namespace

// closure != 0: in_pdf and ll are not read.  in_deg: (S,) live slots a
// state for shared tables, (B, S) for one table a lane; null walks all K
// slots (the first version).  long_states: the n_long states of a shared
// table whose walk, deg + (deg < K), is longer than long_walk, all of them
// or none (n_long = 0).  Strides count elements.
extern "C" int viterbi_relax(const float* cost, long long cs_b,
                             long long cs_s, const int* in_src,
                             const float* in_w, const int* in_pdf,
                             const int* in_deg, const int* long_states,
                             int n_long, int long_walk, long long lane_stride,
                             const float* ll, long long ls_b, long long ls_p,
                             float scale, float* out, long long os_b,
                             long long os_s, int B, int S, int K,
                             int out_cols, int closure, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (closure)
    launch<true>(cost, cs_b, cs_s, in_src, in_w, in_pdf, in_deg, long_states,
                 n_long, long_walk, lane_stride, ll, ls_b, ls_p, scale, out,
                 os_b, os_s, B, S, K, out_cols, st);
  else
    launch<false>(cost, cs_b, cs_s, in_src, in_w, in_pdf, in_deg, long_states,
                  n_long, long_walk, lane_stride, ll, ls_b, ls_p, scale, out,
                  os_b, os_s, B, S, K, out_cols, st);
  return (int)cudaGetLastError();
}

// The instantiation that viterbi_relax launches for these arguments, as
// lanes a thread: 0 the first version (in_deg null), 1 or 4 the live walk.
// Launches nothing.
extern "C" int viterbi_relax_lanes_a_thread(
    const float* cost, long long cs_b, long long cs_s, const int* in_src,
    const float* in_w, const int* in_pdf, const int* in_deg,
    const int* long_states, int n_long, int long_walk, long long lane_stride,
    const float* ll, long long ls_b, long long ls_p, float scale, float* out,
    long long os_b, long long os_s, int B, int S, int K, int out_cols,
    int closure, void* stream) {
  if (in_deg == nullptr) return 0;
  return four_lanes(closure != 0, cost, cs_b, cs_s, lane_stride, ll, ls_b,
                    ls_p, out, os_b, os_s, B)
             ? 4
             : 1;
}
