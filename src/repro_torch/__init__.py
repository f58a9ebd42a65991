"""PyTorch/CUDA port of the Multi-GiLA layout system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``graphs/``, ``kernels/<name>/``, ``utils/``) and imports
neither it nor JAX. Entry points run on the card unless the caller passes
``device="cpu"``: ``repro_torch.core.multigila_layout(edges, n, LayoutConfig())``.
"""
