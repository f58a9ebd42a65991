from repro_torch.kernels.nbody.ops import nbody_repulsion
from repro_torch.kernels.nbody.ref import nbody_repulsion_ref, two_set_ref
