// Beam Viterbi over a packed alignment graph, on the host: the aligner of
// monophone training (gmm-align-compiled).  A copy of `beam_viterbi` of
// the JAX package's native/kt_native.cpp: the acoustic scores arrive as a
// precomputed (frames x pdfs) matrix and this loop does the search.
// Plain C ABI, loaded with ctypes by kaldi_tpu_torch/decoder/native_viterbi.py.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 beam_viterbi.cpp -o libbeam_viterbi.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr float kInf = 1e30f;
}

extern "C" {

// Exact/beam Viterbi over a packed graph.
//   emitting arcs: e_src/e_dst/e_pdf/e_olabel/e_w  [num_e]
//   eps arcs:      ne_src/ne_dst/ne_olabel/ne_w    [num_ne]
//   loglikes: row-major [T x P]
// Outputs: out_ali (capacity ali_cap), out_words (capacity words_cap),
// lengths, cost. Returns 0 on success, -1 if no path survived, -2 on
// inconsistent backpointers, -3 if an output buffer is too small (word
// chains through word-labeled epsilon arcs are not bounded by T, so the
// caller's capacity is a guess — on -3 it must fall back to the Python
// decoder or retry with bigger buffers).
int beam_viterbi(const int32_t* e_src, const int32_t* e_dst,
                 const int32_t* e_pdf, const int32_t* e_ilabel,
                 const int32_t* e_olabel, const float* e_w, int64_t num_e,
                 const int32_t* ne_src, const int32_t* ne_dst,
                 const int32_t* ne_olabel, const float* ne_w,
                 int64_t num_ne, int32_t ne_iters,
                 int32_t num_states, int32_t start,
                 const float* final_costs,
                 const float* loglikes, int64_t T, int64_t P,
                 float acoustic_scale, float beam,
                 int32_t* out_ali, int32_t ali_cap, int32_t* out_ali_len,
                 int32_t* out_words, int32_t words_cap,
                 int32_t* out_words_len, float* out_cost) {
  const int64_t S = num_states;
  std::vector<float> cost(S, kInf), next(S, kInf);
  // backpointers per frame: arc id; emitting arcs are [0, num_e),
  // eps arcs encoded as num_e + id. bp[t][s] for t in [0, T].
  std::vector<int32_t> bp(static_cast<size_t>(T + 1) * S, -1);
  cost[start] = 0.0f;

  auto eps_close = [&](std::vector<float>& c, int64_t t) {
    for (int32_t it = 0; it < ne_iters; ++it) {
      bool changed = false;
      for (int64_t a = 0; a < num_ne; ++a) {
        float nc = c[ne_src[a]] + ne_w[a];
        if (nc < c[ne_dst[a]] - 1e-9f) {
          c[ne_dst[a]] = nc;
          bp[t * S + ne_dst[a]] = static_cast<int32_t>(num_e + a);
          changed = true;
        }
      }
      if (!changed) break;
    }
  };

  eps_close(cost, 0);

  for (int64_t t = 0; t < T; ++t) {
    const float* frame = loglikes + t * P;
    float best = kInf;
    for (int64_t s = 0; s < S; ++s) best = std::min(best, cost[s]);
    if (best >= kInf / 2) return -1;
    const float cutoff = best + beam;
    std::fill(next.begin(), next.end(), kInf);
    int32_t* bpt = bp.data() + (t + 1) * S;
    for (int64_t a = 0; a < num_e; ++a) {
      const float sc = cost[e_src[a]];
      if (sc > cutoff) continue;
      const float nc = sc + e_w[a] - acoustic_scale * frame[e_pdf[a]];
      if (nc < next[e_dst[a]]) {
        next[e_dst[a]] = nc;
        bpt[e_dst[a]] = static_cast<int32_t>(a);
      }
    }
    eps_close(next, t + 1);
    cost.swap(next);
  }

  // choose best final
  float best_cost = kInf;
  int32_t best_state = -1;
  for (int64_t s = 0; s < S; ++s) {
    const float c = cost[s] + final_costs[s];
    if (c < best_cost) {
      best_cost = c;
      best_state = static_cast<int32_t>(s);
    }
  }
  if (best_state < 0 || best_cost >= kInf / 2) return -1;

  // traceback
  std::vector<int32_t> ali, words;
  int64_t t = T;
  int32_t s = best_state;
  while (t > 0 || bp[t * S + s] >= 0) {
    const int32_t arc = bp[t * S + s];
    if (arc < 0) {
      if (t == 0) break;
      return -2;  // inconsistent backpointers (bug guard)
    }
    if (arc >= num_e) {  // eps arc, same frame
      const int64_t a = arc - num_e;
      if (ne_olabel[a] != 0) words.push_back(ne_olabel[a]);
      s = ne_src[a];
    } else {
      ali.push_back(e_ilabel[arc]);
      if (e_olabel[arc] != 0) words.push_back(e_olabel[arc]);
      s = e_src[arc];
      --t;
    }
  }
  if (ali.size() > static_cast<size_t>(ali_cap) ||
      words.size() > static_cast<size_t>(words_cap)) {
    return -3;  // caller's buffers too small; no bytes written
  }
  std::reverse(ali.begin(), ali.end());
  std::reverse(words.begin(), words.end());
  *out_ali_len = static_cast<int32_t>(ali.size());
  *out_words_len = static_cast<int32_t>(words.size());
  std::memcpy(out_ali, ali.data(), ali.size() * sizeof(int32_t));
  std::memcpy(out_words, words.data(), words.size() * sizeof(int32_t));
  *out_cost = best_cost;
  return 0;
}

}  // extern "C"
