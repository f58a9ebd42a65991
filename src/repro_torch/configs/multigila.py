"""Paper-side presets: Multi-GiLA layout experiment configurations, the
JAX package's ``configs/multigila.py`` on the port's ``LayoutConfig``.

These mirror the paper's three benchmarks (REGULARGRAPHS quality set,
REALGRAPHS/BIGGRAPHS scalability sets, scaled to one machine) plus the
dry run's layout sizes (10M-edge class, as in BigGraphs), which
``launch/dryrun.py``'s ``layout`` suite runs."""
from __future__ import annotations

import dataclasses

from repro_torch.core.multilevel import LayoutConfig


@dataclasses.dataclass(frozen=True)
class LayoutExperiment:
    name: str
    generator: str          # graphs/generators.py function name
    args: tuple
    cfg: LayoutConfig = LayoutConfig()


# Quality benchmark (paper Table 1 families)
REGULAR = "regulargraphs_suite"

# Scalability stand-ins (paper Tables 2–3 families, scaled down)
REAL_GRAPHS = [
    LayoutExperiment("asic_like", "scale_free", (30_000, 4, 11)),
    LayoutExperiment("amazon_like", "scale_free", (50_000, 3, 12)),
    LayoutExperiment("road_like", "road_like", (260, 200, 0.25, 13)),
]

# The dry run's layout sizes (BigGraphs class: ~10M edges). The `coarse`
# entry stands for a mid-hierarchy level where exact N-body applies.
BIG_GRAPH_DRYRUN = dict(
    hugetric_like=dict(n_pad=8 << 20, m_pad=32 << 20, cap=32),   # ~8.4M vtx
    delaunay_like=dict(n_pad=4 << 20, m_pad=32 << 20, cap=32),
    coarse_level=dict(n_pad=1 << 16, m_pad=1 << 19, cap=64),     # exact mode
)
