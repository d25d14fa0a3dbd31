// Batched Viterbi relaxation over a padded incoming-arc table, for Hopper.
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
// 1e30; dead table slots carry src = S, w = INF, pdf = 0, so their
// candidate is the finite 2e30 and needs no branch.  When the output has
// S+1 columns the kernel also writes the dead column: INF after an
// emitting step, the old value after a closure step.
//
// Tables are (S, K) shared by all lanes (lane_stride 0) or (B, S, K), one
// a lane (lane_stride S*K).  cost, ll and out are addressed through
// element strides, so the caller chooses the layout: the decoder keeps
// them lanes-fastest, and then a warp reads ONE table entry (a broadcast)
// and 32 neighbouring lanes of the source state's cost and of the pdf's
// loglike, both coalesced.  In the reference's (B, S+1) layout the same
// kernel is right but its gathers stride over lanes.
//
// Bound: the TPU kernel keeps the whole (B, S+1) cost table of a 512-state
// program resident in VMEM; here that table (10.7 MB at 20,866 states x
// 128 lanes) and the loglikes (1 MB) live in the 50 MB L2, and each of the
// S*K*B candidates costs two L2/L1 gathers, two adds and a multiply.  The
// compulsory traffic is the table (3 * S*K*4 bytes) and the cost rows in
// and out; the work is the PADDED table, as on the TPU: K is the largest
// in-degree rounded up to a power of two, so most slots of a lexicon
// graph are dead.  This first version takes one thread per (s, b) and
// walks the K slots in a loop; it skips nothing.
//
// Arithmetic: the plain version computes (prev + w) - (scale * ac) with
// three roundings.  nvcc would contract the multiply into the subtraction
// (an FMA, one rounding fewer), so the candidate is spelled with
// __fadd_rn / __fmul_rn / __fsub_rn, which are never contracted: the
// result equals the plain PyTorch version bit for bit.  min is exact in
// any order, so no tie rule has to be kept.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kInf = 1e30f;

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

}  // namespace

// closure != 0: in_pdf and ll are not read.  Strides count elements.
extern "C" int viterbi_relax(const float* cost, long long cs_b,
                             long long cs_s, const int* in_src,
                             const float* in_w, const int* in_pdf,
                             long long lane_stride, const float* ll,
                             long long ls_b, long long ls_p, float scale,
                             float* out, long long os_b, long long os_s,
                             int B, int S, int K, int out_cols, int closure,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const long long n = (long long)out_cols * B;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (closure)
    relax<true><<<blocks, threads, 0, st>>>(
        cost, cs_b, cs_s, in_src, in_w, in_pdf, lane_stride, ll, ls_b, ls_p,
        scale, out, os_b, os_s, B, S, K, out_cols);
  else
    relax<false><<<blocks, threads, 0, st>>>(
        cost, cs_b, cs_s, in_src, in_w, in_pdf, lane_stride, ll, ls_b, ls_p,
        scale, out, os_b, os_s, B, S, K, out_cols);
  return (int)cudaGetLastError();
}
