"""PyTorch/CUDA port of the Multi-GiLA layout system and its LM scaffold.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``graphs/``, ``configs/``, ``models/``, ``kernels/<name>/``,
``utils/``) and imports neither it nor JAX. Entry points run on the card
unless the caller passes ``device="cpu"``:
``repro_torch.core.multigila_layout(edges, n, LayoutConfig())``, and for
the dense LM ``repro_torch.models.prefill`` / ``decode_step`` on a model
from ``repro_torch.models.init_params``.
"""
