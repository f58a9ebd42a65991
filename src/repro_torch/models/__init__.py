"""The LM serving path of the port: every family the JAX package registers."""
from repro_torch.models.model import (LM, DecodeGraph, DecoderLayer,
                                      EncoderLayer, compile_decode,
                                      decode_step, forward,
                                      init_decode_state, init_params, prefill)
