// Lattice-mode Viterbi frame step over the block-chain graph layout, for
// Hopper.
//
// Replaces the Pallas TPU kernel of kaldi_tpu/decoder/block_chain.py,
// BlockChainDecoder._make_lattice_step (body :480-545, pallas_call
// :547-579).
//
// Layout: the cost plane and the word-entry-frame plane are (Up, N, B)
// float32 (context block u, chain row n, lane b), lanes fastest.  Per
// frame t, for every block u:
//   fwd     = first[n] ? ovr[u] : cost[u, (n-1) mod N]     (roll by 1)
//   fwd_ent = first[n] ? t      : ent[u, (n-1) mod N]
//   take    = fwd + (LN2 + amf[n]) < cost + (LN2 + ams[n])  (strict, so
//             ties keep the self-loop)
//   new     = take ? fwd + (LN2 + amf[n]) : cost + (LN2 + ams[n])
//   ent_new = take ? fwd_ent : ent
// and per word-end slot e a candidate out of every block of the OLD planes:
//   cand(u) = end_src(e) + bigram_ends[u, e],  entry frame ent[u, end row]
//             (t for a one-phone word, whose source is the root ovr[u];
//             INF and 0 for a pad slot),
// inserted for u = 0, 1, ... into J planes (rc, ru, re) kept sorted by
// cost, starting from (INF, 0, 0): a candidate moves in at the first slot
// it beats with strict <, and the entry it displaces goes on down the
// list under the same rule.  A displaced entry therefore passes entries
// of equal cost, so among equal costs the list is not simply in block
// order; the result depends on the order of insertion.
// Lanes with active[b] == 0 keep their old columns in both planes (the
// reference's lane freeze, fused here so that 2.3 GB are not streamed a
// second time).
//
// Bound: memory traffic.  One step must read two planes and write two
// (Up*N*B*4 bytes each, 1.14 GB each at 704 x 3160 x 128); the arithmetic
// is a few adds, compares and selects per element.
//
// Design: the TPU kernel walks the blocks on a sequential grid and keeps
// the J sorted planes in VMEM.  Hopper's blocks run in parallel in no
// order, so the step is two grids on one stream:
//   relax_entry:   one thread per (u, group of 8 rows, lane b), b fastest
//                  so every warp load and store is coalesced; a thread
//                  walks its 8 rows with the previous row of both planes
//                  in registers, so each plane is read once (plus one row
//                  in 8).
//   word_end_topj: one thread per (e, b) walks ALL blocks in ascending
//                  order with the J entries in registers (J is a template
//                  parameter).  Splitting the blocks into chunks and
//                  merging the chunks' lists, as the best-path step does
//                  for its min, would give another list than the
//                  sequential insertion whenever equal costs meet, so the
//                  walk stays sequential; it loads 8 blocks' candidates
//                  ahead to keep loads in flight, and reads an entry frame
//                  only for a candidate that moves in.
// Only adds, compares and selects, in the reference's order
// x + (LN2 + am): the results equal the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLn2 = 0.693147180559945309f;
constexpr float kInf = 1e30f;
constexpr int kAhead = 8;     // blocks whose candidates are loaded ahead

__global__ void relax_entry(const float* __restrict__ cost,
                            const float* __restrict__ ent,
                            const float* __restrict__ ovr,
                            const float* __restrict__ amf,
                            const float* __restrict__ ams,
                            const uint8_t* __restrict__ first,
                            const uint8_t* __restrict__ active,
                            float* __restrict__ out,
                            float* __restrict__ eout,
                            float tf, int Up, int N, int B) {
  const int Nb = N >> 3;
  const long long total = (long long)Up * Nb * B;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int b = (int)(idx % B);
  const long long ui = idx / B;           // u * Nb + i
  const int i = (int)(ui % Nb);
  const int u = (int)(ui / Nb);
  const size_t base = (size_t)u * N * B + b;
  const float* cblk = cost + base;
  const float* eblk = ent + base;
  float* oblk = out + base;
  float* eoblk = eout + base;
  const float root = ovr[(size_t)u * B + b];
  const bool act = active[b] != 0;
  const int n0 = 8 * i;
  const size_t wrap = (size_t)((n0 == 0 ? N : n0) - 1) * B;
  float prev = cblk[wrap];
  float prev_e = eblk[wrap];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + r;
    const size_t off = (size_t)n * B;
    const float cur = cblk[off];
    const float cur_e = eblk[off];
    const bool is_first = first[n] != 0;
    const float src = is_first ? root : prev;
    const float src_e = is_first ? tf : prev_e;
    const float fc = src + (kLn2 + amf[off + b]);
    const float sc = cur + (kLn2 + ams[off + b]);
    const bool take_fwd = fc < sc;
    oblk[off] = act ? (take_fwd ? fc : sc) : cur;
    eoblk[off] = act ? (take_fwd ? src_e : cur_e) : cur_e;
    prev = cur;
    prev_e = cur_e;
  }
}

// end_src[e]: chain-end row of word e (>= 0), -1 for a one-phone word
// (its source is the block's root ovr[u], its entry frame t), -2 for a
// pad slot (INF, entry frame 0).
template <int J>
__global__ void word_end_topj(const float* __restrict__ cost,
                              const float* __restrict__ ent,
                              const float* __restrict__ ovr,
                              const float* __restrict__ bigram_ends,
                              const int* __restrict__ end_src,
                              float* __restrict__ rc,
                              float* __restrict__ ru,
                              float* __restrict__ re,
                              float tf, int Up, int N, int Vp, int B) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)Vp * B;
  if (idx >= n) return;
  const int b = (int)(idx % B);
  const int e = (int)(idx / B);
  const int s = end_src[e];
  float c[J], cu[J], ce[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    c[j] = kInf;
    cu[j] = 0.0f;
    ce[j] = 0.0f;
  }
  for (int u0 = 0; u0 < Up; u0 += kAhead) {
    float cand[kAhead];
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int u = u0 + r;
      if (u < Up) {
        const float src = s >= 0 ? cost[((size_t)u * N + s) * B + b]
                        : (s == -1 ? ovr[(size_t)u * B + b] : kInf);
        cand[r] = src + bigram_ends[(size_t)u * Vp + e];
      } else {
        cand[r] = kInf;                   // never beats a list entry
      }
    }
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      // the list is sorted, so a candidate that does not beat the last
      // entry beats none
      if (cand[r] < c[J - 1]) {
        const int u = u0 + r;
        float xc = cand[r];
        float xu = (float)u;
        float xe = s >= 0 ? ent[((size_t)u * N + s) * B + b]
                          : (s == -1 ? tf : 0.0f);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (xc < c[j]) {
            const float tc = c[j], tu = cu[j], te = ce[j];
            c[j] = xc;
            cu[j] = xu;
            ce[j] = xe;
            xc = tc;
            xu = tu;
            xe = te;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    rc[j * n + idx] = c[j];
    ru[j * n + idx] = cu[j];
    re[j * n + idx] = ce[j];
  }
}

template <int J>
cudaError_t launch_topj(const float* cost, const float* ent,
                        const float* ovr, const float* bigram_ends,
                        const int* end_src, float* rc, float* ru, float* re,
                        float tf, int Up, int N, int Vp, int B,
                        cudaStream_t st) {
  const int threads = 128;
  const long long n = (long long)Vp * B;
  word_end_topj<J><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     st>>>(cost, ent, ovr, bigram_ends, end_src, rc, ru, re,
                           tf, Up, N, Vp, B);
  return cudaGetLastError();
}

}  // namespace

// Returns 0, a CUDA error code, or -1 for a J the build does not hold
// (1..8: the lists live in registers).
extern "C" int block_chain_lattice_step(
    int t, const float* cost, const float* ent, const float* ovr,
    const float* amf, const float* ams, const uint8_t* first,
    const float* bigram_ends, const int* end_src, const uint8_t* active,
    float* out, float* eout, float* rc, float* ru, float* re, int Up, int N,
    int B, int Vp, int J, void* stream) {
  if (J < 1 || J > 8) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const float tf = (float)t;
  const int threads = 256;
  const long long n1 = (long long)Up * (N >> 3) * B;
  relax_entry<<<(unsigned)((n1 + threads - 1) / threads), threads, 0, st>>>(
      cost, ent, ovr, amf, ams, first, active, out, eout, tf, Up, N, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define TOPJ(j)                                                            \
  case j:                                                                  \
    err = launch_topj<j>(cost, ent, ovr, bigram_ends, end_src, rc, ru, re, \
                         tf, Up, N, Vp, B, st);                            \
    break;
  switch (J) {
    TOPJ(1) TOPJ(2) TOPJ(3) TOPJ(4) TOPJ(5) TOPJ(6) TOPJ(7) TOPJ(8)
  }
#undef TOPJ
  return (int)err;
}
