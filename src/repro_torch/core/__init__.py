from repro_torch.core.multilevel import (LayoutConfig, LayoutStats,
                                         build_hierarchy, connected_components,
                                         layout_component, multigila_layout)
from repro_torch.core.solar_merger import (LevelInfo, MergerState, next_level,
                                           run_merger, init_state,
                                           UNASSIGNED, SUN, PLANET, MOON)
from repro_torch.core.solar_placer import solar_placer
