"""Config registry: one module per architecture the port runs.

``get_config(name)`` returns the exact published config; ``get_smoke_config``
returns the reduced same-family config used by CPU tests. Registered: the
dense ``internlm2-1.8b``, ``starcoder2-7b``, ``starcoder2-15b`` and
``gemma-2b``, the mixture-of-experts ``granite-moe-3b-a800m`` and
``deepseek-moe-16b``, the SSM ``mamba2-1.3b``, the hybrid
``jamba-v0.1-52b``, the encoder-decoder ``seamless-m4t-medium`` and the VLM
``internvl2-76b``: every model the JAX package registers. Beside them,
``multigila_presets`` (``configs/multigila.py``): the paper's layout
experiments and the dry run's layout sizes.
"""
from repro_torch.configs.base import (ArchConfig, MoEConfig, SSMConfig,
                                      ShapeCell, SHAPES, cells_for,
                                      get_config, get_smoke_config,
                                      list_archs, pad_to)

# importing the modules populates the registry
from repro_torch.configs import (deepseek_moe_16b, gemma_2b,
                                 granite_moe_3b_a800m, internlm2_1_8b,
                                 internvl2_76b, jamba_v0_1_52b, mamba2_1_3b,
                                 seamless_m4t_medium, starcoder2_7b,
                                 starcoder2_15b)
from repro_torch.configs import multigila as multigila_presets
