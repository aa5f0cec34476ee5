// Native CIDEr-D scorer (a copy of captionkit/native/cider.cpp), bound with
// ctypes by captionkit_torch/metrics/fast.py.
//
// The same algorithm as captionkit_torch/metrics/cider.py (clipped tf-idf
// cosine per n=1..4, Gaussian length penalty, x10), against a precomputed
// document-frequency table, exposed through a C ABI.
//
// Tokens are dense integer ids assigned by the Python wrapper (exact token
// equality semantics, no hashing collisions: n-gram keys are the raw bytes
// of their id sequence).
//
// Built at first use by captionkit_torch/utils/nativebuild.py (g++ -O3
// -std=c++17 -fPIC -shared) into build/captionkit_torch/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxN = 4;

struct NgramMap {
  std::unordered_map<std::string, double> table;

  static std::string key(const int32_t* ids, int n) {
    return std::string(reinterpret_cast<const char*>(ids),
                       sizeof(int32_t) * n);
  }
};

struct Cider {
  double sigma = 6.0;
  double log_corpus = 0.0;
  NgramMap df;
};

// Sparse tf-idf vector per n plus norms and unigram length.
struct SentVec {
  std::unordered_map<std::string, double> vec[kMaxN];
  double norm[kMaxN] = {0, 0, 0, 0};
  int length = 0;
};

void build_vec(const Cider& c, const int32_t* toks, int len, SentVec* out) {
  // Count n-grams.
  std::unordered_map<std::string, int> counts[kMaxN];
  for (int n = 1; n <= kMaxN; ++n) {
    for (int i = 0; i + n <= len; ++i) {
      counts[n - 1][NgramMap::key(toks + i, n)] += 1;
    }
  }
  out->length = len;  // unigram count == token count
  for (int n = 0; n < kMaxN; ++n) {
    for (const auto& kv : counts[n]) {
      auto it = c.df.table.find(kv.first);
      double dfv = it == c.df.table.end() ? 0.0 : it->second;
      double idf = c.log_corpus - std::log(std::max(1.0, dfv));
      double w = kv.second * idf;
      out->vec[n][kv.first] = w;
      out->norm[n] += w * w;
    }
    out->norm[n] = std::sqrt(out->norm[n]);
  }
}

double sim_cider_d(const Cider& c, const SentVec& h, const SentVec& r) {
  double delta = static_cast<double>(h.length - r.length);
  double pen = std::exp(-(delta * delta) / (2.0 * c.sigma * c.sigma));
  double total = 0.0;
  for (int n = 0; n < kMaxN; ++n) {
    double v = 0.0;
    for (const auto& kv : h.vec[n]) {
      auto it = r.vec[n].find(kv.first);
      if (it != r.vec[n].end()) {
        v += std::min(kv.second, it->second) * it->second;
      }
    }
    if (h.norm[n] != 0.0 && r.norm[n] != 0.0) v /= h.norm[n] * r.norm[n];
    total += v * pen;
  }
  return total / kMaxN * 10.0;
}

}  // namespace

extern "C" {

void* cider_new(double sigma) {
  auto* c = new Cider();
  c->sigma = sigma;
  return c;
}

void cider_free(void* handle) { delete static_cast<Cider*>(handle); }

// df entries: flattened id sequences + per-entry n-gram orders + counts.
void cider_set_df(void* handle, const int32_t* flat, const int32_t* orders,
                  const double* counts, int64_t n_entries,
                  int64_t corpus_size) {
  auto* c = static_cast<Cider*>(handle);
  c->df.table.clear();
  c->df.table.reserve(static_cast<size_t>(n_entries) * 2);
  int64_t off = 0;
  for (int64_t i = 0; i < n_entries; ++i) {
    int n = orders[i];
    c->df.table.emplace(NgramMap::key(flat + off, n), counts[i]);
    off += n;
  }
  c->log_corpus = std::log(std::max<int64_t>(corpus_size, 1));
}

// Score S sets of B hypotheses against the same B images' references
// (CIDEr-D): out_scores[s * B + b]. Each image's reference vectors are
// built once for all S sets; every score is the arithmetic of scoring its
// set alone. hyps: flat ids + lens, set-major. refs: flat ids + lens +
// refs_per_img counts.
void cider_d_score_sets(void* handle, int64_t sets, const int32_t* hyp_flat,
                        const int32_t* hyp_lens, const int32_t* ref_flat,
                        const int32_t* ref_lens, const int32_t* refs_per_img,
                        int64_t batch, double* out_scores) {
  auto* c = static_cast<Cider*>(handle);
  std::vector<int64_t> hyp_off(static_cast<size_t>(sets * batch) + 1, 0);
  for (int64_t i = 0; i < sets * batch; ++i) {
    hyp_off[i + 1] = hyp_off[i] + hyp_lens[i];
  }
  int64_t ref_off = 0, ref_idx = 0;
  std::vector<SentVec> rvs;
  for (int64_t b = 0; b < batch; ++b) {
    int nr = refs_per_img[b];
    rvs.clear();
    rvs.resize(static_cast<size_t>(nr));
    for (int r = 0; r < nr; ++r) {
      build_vec(*c, ref_flat + ref_off, ref_lens[ref_idx], &rvs[r]);
      ref_off += ref_lens[ref_idx];
      ++ref_idx;
    }
    for (int64_t s = 0; s < sets; ++s) {
      int64_t i = s * batch + b;
      SentVec hv;
      build_vec(*c, hyp_flat + hyp_off[i], hyp_lens[i], &hv);
      double acc = 0.0;
      for (int r = 0; r < nr; ++r) acc += sim_cider_d(*c, hv, rvs[r]);
      out_scores[i] = nr > 0 ? acc / nr : 0.0;
    }
  }
}

}  // extern "C"
