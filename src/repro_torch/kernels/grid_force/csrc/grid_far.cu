// Far field of the grid repulsion on Hopper: every vertex against every
// cell aggregate (x, y, mass).
//
// Replaces the Pallas kernel kernels/grid_force/kernel.py:grid_far_pallas
// (body _far_kernel) of the JAX package. The kernel is the two-set n-body
// template in ../../nbody/csrc/two_set.cuh (bound: fp32 throughput; design:
// one thread per vertex, cell tiles staged through shared memory); here the
// sources are the G² cell aggregates, read from one interleaved [nc, 3]
// array, and no output is masked (the caller masks the composed force).
#include "../../nbody/csrc/two_set.cuh"

extern "C" int grid_far_launch(const float* pos, int n, const float* cell_xyw,
                               int nc, float cl2, float md2, float* out,
                               cudaStream_t stream) {
  if (n > 0) {
    repro_torch::two_set_kernel<false, false>
        <<<repro_torch::two_set_blocks(n), repro_torch::TS_THREADS, 0,
           stream>>>(pos, n, cell_xyw, 3, cell_xyw + 2, 3, nullptr, nc,
                     nullptr, cl2, md2, out);
  }
  return (int)cudaGetLastError();
}
