// Host preprocessing kernels of the graph builder: the port's own copy of
// `equidock_public_tpu/native/graph_builder.cc`, the same arithmetic.
//
// residue_mean_dist is the O(A^2) all-atom pairwise distance reduction per
// residue pair (mean atom distance), threaded over rows; knn_edges picks each
// node's neighbours from that matrix. Built by one plain g++ call at first
// use and bound with ctypes (equidock_public_tpu_torch/native/__init__.py).
// Each distance is taken from float32 differences, squared and summed in
// double (the products are exact there) and rooted in double; a residue
// pair's sum runs in one fixed order. The build turns off floating-point
// contraction, so no host CPU changes a bit of the result.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

// atoms:       (A, 3) float32, all atoms of one protein, residue-major order
// res_offsets: (n_res + 1) int64, atoms of residue i are [off[i], off[i+1])
// out:         (n_res, n_res) float32, mean all-atom pairwise distance,
//              +inf on the diagonal
void residue_mean_dist(const float* atoms, const int64_t* res_offsets,
                       int64_t n_res, float* out) {
  const float inf = std::numeric_limits<float>::infinity();
  int64_t n_threads = std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_res) n_threads = n_res;

  auto worker = [&](int64_t tid) {
    // round-robin rows for load balance (row i costs ~ (n_res - i))
    for (int64_t i = tid; i < n_res; i += n_threads) {
      const int64_t ai0 = res_offsets[i], ai1 = res_offsets[i + 1];
      out[i * n_res + i] = inf;
      for (int64_t j = i + 1; j < n_res; ++j) {
        const int64_t aj0 = res_offsets[j], aj1 = res_offsets[j + 1];
        double sum = 0.0;
        for (int64_t a = ai0; a < ai1; ++a) {
          const float ax = atoms[3 * a], ay = atoms[3 * a + 1],
                      az = atoms[3 * a + 2];
          for (int64_t b = aj0; b < aj1; ++b) {
            const float dx = ax - atoms[3 * b];
            const float dy = ay - atoms[3 * b + 1];
            const float dz = az - atoms[3 * b + 2];
            sum += std::sqrt(static_cast<double>(dx) * dx +
                             static_cast<double>(dy) * dy +
                             static_cast<double>(dz) * dz);
          }
        }
        const float mean =
            static_cast<float>(sum / static_cast<double>((ai1 - ai0) * (aj1 - aj0)));
        out[i * n_res + j] = mean;
        out[j * n_res + i] = mean;
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
}

// kNN edge selection over a precomputed distance matrix, matching
// `protein_utils.py:339-343`: for each node i take all j with d < cutoff,
// or the max_neighbor nearest when more. Outputs fixed-degree tables.
// nbr/nbr_mask/nbr_dist: (n_res, max_neighbor)
void knn_edges(const float* dist, int64_t n_res, float cutoff,
               int64_t max_neighbor, int32_t* nbr, uint8_t* nbr_mask,
               float* nbr_dist) {
  std::vector<int64_t> idx(n_res);
  for (int64_t i = 0; i < n_res; ++i) {
    const float* row = dist + i * n_res;
    int64_t count = 0;
    for (int64_t j = 0; j < n_res; ++j)
      if (row[j] < cutoff) ++count;

    int64_t k = 0;
    if (count > max_neighbor) {
      // argsort of the full row, take the first max_neighbor
      idx.resize(n_res);
      for (int64_t j = 0; j < n_res; ++j) idx[j] = j;
      std::partial_sort(idx.begin(), idx.begin() + max_neighbor, idx.end(),
                        [row](int64_t a, int64_t b) { return row[a] < row[b]; });
      for (; k < max_neighbor; ++k) {
        nbr[i * max_neighbor + k] = static_cast<int32_t>(idx[k]);
        nbr_mask[i * max_neighbor + k] = 1;
        nbr_dist[i * max_neighbor + k] = row[idx[k]];
      }
    } else {
      for (int64_t j = 0; j < n_res && k < max_neighbor; ++j) {
        if (row[j] < cutoff) {
          nbr[i * max_neighbor + k] = static_cast<int32_t>(j);
          nbr_mask[i * max_neighbor + k] = 1;
          nbr_dist[i * max_neighbor + k] = row[j];
          ++k;
        }
      }
    }
    for (; k < max_neighbor; ++k) {
      nbr[i * max_neighbor + k] = static_cast<int32_t>(i);
      nbr_mask[i * max_neighbor + k] = 0;
      nbr_dist[i * max_neighbor + k] = 0.0f;
    }
  }
}

}  // extern "C"
