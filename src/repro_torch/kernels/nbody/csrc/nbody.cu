// All-pairs FR repulsion of one vertex set on Hopper.
//
// Replaces the Pallas kernel kernels/nbody/kernel.py:nbody_repulsion_pallas
// (body _nbody_kernel) of the JAX package. The kernel itself is the two-set
// n-body template in two_set.cuh (see there for the bound and the design);
// here targets and sources are the same n vertices, a source's weight is
// mass·vmask, and a target outside vmask gets force 0.
#include "two_set.cuh"

extern "C" int nbody_repulsion_launch(const float* pos, const float* mass,
                                      const bool* vmask, int n, float cl2,
                                      float md2, float* out,
                                      cudaStream_t stream) {
  if (n > 0) {
    repro_torch::two_set_kernel<true, true>
        <<<repro_torch::two_set_blocks(n), repro_torch::TS_THREADS, 0,
           stream>>>(pos, n, pos, 2, mass, 1, vmask, n, vmask, cl2, md2, out);
  }
  return (int)cudaGetLastError();
}
