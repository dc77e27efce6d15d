from repro_torch.models.api import (
    decode_step,
    forward,
    init_cache,
    init_model,
    init_model_shapes,
    loss_fn,
)
from repro_torch.models.params import ParamTree, from_reference

__all__ = ["ParamTree", "decode_step", "forward", "from_reference",
           "init_cache", "init_model", "init_model_shapes", "loss_fn"]
