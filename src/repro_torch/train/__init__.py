from repro_torch.train.optim import (AdamWConfig, OptState, apply_updates,
                                     init_opt_state, lr_at)
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)
from repro_torch.train.data import DataConfig, batch_at, extra_inputs
