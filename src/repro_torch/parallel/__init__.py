from repro_torch.parallel.sharding import (ShardingRules, batch_axes,
                                          current_mesh, current_rules,
                                          make_rules, param_shardings,
                                          use_shardings)
