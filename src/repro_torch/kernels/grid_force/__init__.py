from repro_torch.kernels.grid_force.ops import (bin_vertices, choose_grid,
                                                grid_cell_size, grid_far,
                                                grid_near, grid_repulsion,
                                                near_field, neighbor_table)
from repro_torch.kernels.grid_force.ref import (grid_near_ref, grid_far_ref,
                                                near_field_ref)
