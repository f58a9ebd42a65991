from repro_torch.core.multilevel import (GraphJob, LayoutConfig, LayoutStats,
                                         WaveScheduler, build_hierarchy,
                                         connected_components,
                                         layout_component, multigila_layout,
                                         multigila_layout_many)
from repro_torch.core.solar_merger import (LevelInfo, MergerState, next_level,
                                           run_merger, init_state,
                                           UNASSIGNED, SUN, PLANET, MOON)
from repro_torch.core.solar_placer import solar_placer
