from repro_torch.serve.engine import (
    BatchingQueue, greedy_generate, make_decode_step, make_prefill_step,
)

__all__ = ["BatchingQueue", "greedy_generate", "make_decode_step", "make_prefill_step"]
