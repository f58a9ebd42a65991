"""Hand-written Hopper kernels of the port, one subpackage per Pallas kernel
of the JAX package on the layout path:

  nbody/          — all-pairs FR repulsion (exact mode)
  neighbor_force/ — k-hop neighbor-list repulsion (neighbor mode)
  grid_force/     — grid repulsion: exact 3×3 near field and the far field
                    against per-cell aggregates (grid mode)

Each subpackage holds its CUDA C++ source under ``csrc/``, a plain PyTorch
version of the same function in ``ref.py``, and the wrapper in ``ops.py``
that launches the kernel for a CUDA tensor and runs the plain version for a
CPU tensor. ``_build`` compiles the sources with ``nvcc`` at first use and
counts launches per kernel.
"""
