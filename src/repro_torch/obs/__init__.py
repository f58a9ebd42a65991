from repro_torch.obs.clock import Clock, SystemClock, VirtualClock
