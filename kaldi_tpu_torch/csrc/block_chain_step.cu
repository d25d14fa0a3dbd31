// Exact Viterbi frame step over the block-chain graph layout, for Hopper.
//
// Replaces the Pallas TPU kernel of kaldi_tpu/decoder/block_chain.py,
// BlockChainDecoder._make_step (body :296-343, pallas_call :345-377).
//
// Layout: cost planes are (Up, N, B) float32 (context block u, chain row
// n, lane b), lanes fastest.  Per frame, for every block u:
//   fwd  = first[n] ? ovr[u] : cost[u, (n-1) mod N]     (roll by 1)
//   new  = min(fwd + (LN2 + amf[n]), cost + (LN2 + ams[n])), strict <,
//          so ties take the self-loop; bit r of bits[u, i] = row 8i+r
//          took the forward arc
//   cand = end_src(e) + bigram_ends[u, e] read from the OLD plane,
//          reduced over u into (rootexp, rootarg) with strict < in
//          ascending u, so the lowest u wins ties.
// Lanes with active[b] == 0 keep their old column (the reference's lane
// freeze, fused here so the plane is not streamed a second time).
//
// Bound: memory traffic.  One step must read the old plane and write the
// new one (Up*N*B*4 bytes each way, 1.14 GB each at 704 x 3160 x 128)
// plus the bit plane (Up*N*B/8 bytes); the arithmetic is a few adds and
// compares per element.
//
// Design: the TPU kernel walks the blocks on a sequential grid and keeps
// the running min in VMEM.  Hopper's blocks run in parallel in no order,
// so the step is three grids on one stream:
//   relax_pack:       one thread per (u, byte i, lane b), b fastest so
//                     every warp load and store is coalesced; each thread
//                     walks its 8 rows with the previous row in a
//                     register, so the plane is read once (plus one row
//                     in 8).
//   word_end_partial: one thread per (chunk of blocks, e, b) takes the
//                     strict-< min over its chunk of the OLD plane;
//   word_end_combine: one thread per (e, b) folds the chunks in ascending
//                     order.  The fixed order gives the TPU kernel's tie
//                     rule (lowest u) without atomics; the chunks give
//                     the reduction enough threads to hide load latency
//                     (one thread per (e, b) over all 704 blocks left
//                     the card latency-bound).
// Only adds, mins and compares, in the reference's order x + (LN2 + am):
// the results equal the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLn2 = 0.693147180559945309f;
constexpr float kInf = 1e30f;

__global__ void relax_pack(const float* __restrict__ cost,
                           const float* __restrict__ ovr,
                           const float* __restrict__ amf,
                           const float* __restrict__ ams,
                           const uint8_t* __restrict__ first,
                           const uint8_t* __restrict__ active,
                           float* __restrict__ out,
                           uint8_t* __restrict__ bits,
                           int Up, int N, int B) {
  const int Nb = N >> 3;
  const long long total = (long long)Up * Nb * B;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int b = (int)(idx % B);
  const long long ui = idx / B;           // u * Nb + i
  const int i = (int)(ui % Nb);
  const int u = (int)(ui / Nb);
  const size_t base = (size_t)u * N * B + b;
  const float* blk = cost + base;
  float* oblk = out + base;
  const float root = ovr[(size_t)u * B + b];
  const bool act = active[b] != 0;
  const int n0 = 8 * i;
  float prev = blk[(size_t)((n0 == 0 ? N : n0) - 1) * B];
  unsigned byte = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + r;
    const float cur = blk[(size_t)n * B];
    const float src = first[n] ? root : prev;
    const float fc = src + (kLn2 + amf[(size_t)n * B + b]);
    const float sc = cur + (kLn2 + ams[(size_t)n * B + b]);
    const bool take_fwd = fc < sc;
    byte |= (unsigned)take_fwd << r;
    oblk[(size_t)n * B] = act ? (take_fwd ? fc : sc) : cur;
    prev = cur;
  }
  bits[idx] = (uint8_t)byte;              // (Up, Nb, B) row-major
}

// end_src[e]: chain-end row of word e (>= 0), -1 for a one-phone word
// (its source is the block's root ovr[u]), -2 for a pad slot.
// Pass 1: one thread per (chunk c, e, b) takes the strict-< running min
// over its `chunk` blocks, lowest u first.
__global__ void word_end_partial(const float* __restrict__ cost,
                                 const float* __restrict__ ovr,
                                 const float* __restrict__ bigram_ends,
                                 const int* __restrict__ end_src,
                                 float* __restrict__ pbest,
                                 int* __restrict__ parg,
                                 int Up, int N, int Vp, int B, int chunk) {
  const int nC = (Up + chunk - 1) / chunk;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nC * Vp * B) return;
  const int b = (int)(idx % B);
  const long long ce = idx / B;           // c * Vp + e
  const int e = (int)(ce % Vp);
  const int c = (int)(ce / Vp);
  const int s = end_src[e];
  const int u_end = min(Up, (c + 1) * chunk);
  float best = kInf;
  int arg = 0;
  for (int u = c * chunk; u < u_end; ++u) {
    const float src = s >= 0 ? cost[((size_t)u * N + s) * B + b]
                    : (s == -1 ? ovr[(size_t)u * B + b] : kInf);
    const float cand = src + bigram_ends[(size_t)u * Vp + e];
    if (cand < best) {
      best = cand;
      arg = u;
    }
  }
  pbest[idx] = best;
  parg[idx] = arg;
}

// Pass 2: one thread per (e, b) folds the chunks in ascending order with
// strict <, so the result is the first (lowest) u at the global minimum,
// or (INF, 0) when nothing beats INF: the sequential running min exactly.
__global__ void word_end_combine(const float* __restrict__ pbest,
                                 const int* __restrict__ parg,
                                 float* __restrict__ rootexp,
                                 int* __restrict__ rootarg,
                                 int nC, int Vp, int B) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)Vp * B;
  if (idx >= n) return;
  float best = kInf;
  int arg = 0;
  for (int c = 0; c < nC; ++c) {
    const float v = pbest[c * n + idx];
    if (v < best) {
      best = v;
      arg = parg[c * n + idx];
    }
  }
  rootexp[idx] = best;
  rootarg[idx] = arg;
}

}  // namespace

// pbest / parg: scratch of ceil(Up / chunk) * Vp * B entries each.
extern "C" int block_chain_step(const float* cost, const float* ovr,
                                const float* amf, const float* ams,
                                const uint8_t* first,
                                const float* bigram_ends,
                                const int* end_src, const uint8_t* active,
                                float* out, uint8_t* bits, float* rootexp,
                                int* rootarg, float* pbest, int* parg,
                                int Up, int N, int B, int Vp, int chunk,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const long long n1 = (long long)Up * (N >> 3) * B;
  relax_pack<<<(unsigned)((n1 + threads - 1) / threads), threads, 0, st>>>(
      cost, ovr, amf, ams, first, active, out, bits, Up, N, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nC = (Up + chunk - 1) / chunk;
  const long long n2 = (long long)nC * Vp * B;
  word_end_partial<<<(unsigned)((n2 + threads - 1) / threads), threads, 0,
                     st>>>(cost, ovr, bigram_ends, end_src, pbest, parg, Up,
                           N, Vp, B, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n3 = (long long)Vp * B;
  word_end_combine<<<(unsigned)((n3 + threads - 1) / threads), threads, 0,
                     st>>>(pbest, parg, rootexp, rootarg, nC, Vp, B);
  return (int)cudaGetLastError();
}
