// Grouped Monte-Carlo correctness estimation (paper Lemma 4) for the
// planner, written for Hopper (sm_90a). Replaces the Pallas TPU kernel
// `mc_correctness_grouped_pallas` in src/repro/kernels/mc_correctness.py; the
// design note is in src/repro_torch/kernels/mc_correctness.py.
//
// The shared body of mc_tie_hist.cuh over G groups, with each group's
// `valid` draw mask and theta: one launch, one thread-block cluster per
// (group, candidate), bitwise the plain version (`_masked_xi_core`).
#include "mc_tie_hist.cuh"

extern "C" int mc_correctness_grouped_launch(const void* resp, const void* masks,
                                             const void* w, const void* empty,
                                             const void* valid, const void* theta,
                                             void* out, int G, int C, int T,
                                             int L, int K, int cluster, void* stream) {
  return mc::tie_hist_launch(resp, masks, w, empty, valid, theta, out, G, C, T, L, K,
                             cluster, stream);
}
