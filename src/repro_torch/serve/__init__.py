"""Layout serving: a finished multilevel layout becomes a queryable
quadtree tile pyramid (tiles.py), persisted as npz shards (store.py),
served by a batched viewport resolver on the card (query.py) behind a
micro-batching front door (batcher.py). Whole-graph layout requests get a
fixed-window front door (layout_service.py) and a continuous-batching
engine (engine.py) over the batched multi-graph driver. The JAX package's
``serve/`` on the port, with its exports."""
from repro_torch.serve.tiles import TileBand, TilePyramid, build_pyramid
from repro_torch.serve.store import (TileStore, save_pyramid, load_pyramid,
                                     MANIFEST)
from repro_torch.serve.query import (QueryEngine, reference_resolve,
                                     trim_result, band_for_zoom, MAX_TILES)
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.layout_service import LayoutService
from repro_torch.serve.engine import (ContinuousLayoutService, EngineCore,
                                      EngineBusy, DeadlineExceeded,
                                      LayoutRequest, Clock, SystemClock,
                                      VirtualClock, SimEvent, poisson_trace,
                                      run_sim, null_dispatch, validate_graph)
