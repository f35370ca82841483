// Monte-Carlo correctness estimation (paper Lemma 4) over one pool's draws,
// the estimator behind GreedyLLM on xi, written for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `mc_correctness_pallas` in
// src/repro/kernels/mc_correctness.py; the design note is in
// src/repro_torch/kernels/mc_correctness.py.
//
// The shared body of mc_tie_hist.cuh at G=1, with every draw valid and
// theta = T: one launch, one thread-block cluster per candidate, bitwise the
// plain version (`xi_from_responses`).
#include "mc_tie_hist.cuh"

extern "C" int mc_correctness_launch(const void* resp, const void* masks,
                                     const void* w, const void* empty,
                                     void* out, int C, int T, int L, int K,
                                     int cluster, void* stream) {
  if (C <= 0) return 0;
  if (T < 1) return (int)cudaErrorInvalidValue;
  return mc::tie_hist_launch(resp, masks, w, empty, nullptr, nullptr, out, 1, C, T, L,
                             K, cluster, stream);
}
