"""The LM serving path of the port: the dense decoder family."""
from repro_torch.models.model import (LM, DecodeGraph, DecoderLayer,
                                      compile_decode, decode_step, forward,
                                      init_decode_state, init_params, prefill)
