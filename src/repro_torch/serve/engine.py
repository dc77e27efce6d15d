"""Serving steps (the port's copy of ``repro/serve/engine.py``): prefill
(process a full prompt) and decode (one token per call against the
cache), plus a batched greedy generation loop and the continuous-batching
request queue.

The steps run eagerly under ``torch.no_grad`` on the device the
parameters lie on.  A prefill batch is ``{"tokens"}`` plus the family's
stub embeddings (``patch_embeds`` for a vlm, ``frame_embeds`` for the
encdec family), handed to the model's forward as they are.
``use_flash`` defaults to False as in the reference; with it, every
causal prefill layer of the dense, vlm and moe families without an
attention softcap, and every application of the hybrid's shared block,
runs flash attention (kernel K2 on the card); gemma2 (softcaps) and the
encdec family keep the plain attention, as the reference's dispatch
does.  ``use_scan_kernel`` (default False, the reference's route) runs
every prefill layer's WKV scan of the ssm family in kernel K3, and every
mamba layer's SSD scan of the hybrid family in kernel K4; the hybrid
honours both flags.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward, init_cache


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = False,
                      use_scan_kernel: bool = False,
                      last_token_only: bool = False):
    """``last_token_only`` returns logits for the final position only — the
    only logits serving needs after a prefill — and skips the full
    (b, s, vocab) unembedding."""

    @torch.no_grad()
    def prefill_step(params, batch: dict) -> torch.Tensor:
        logits, _ = forward(cfg, params, batch, use_flash=use_flash,
                            use_scan_kernel=use_scan_kernel,
                            unembed_last_only=last_token_only)
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def _decode(params, tokens: torch.Tensor, positions: torch.Tensor,
                cache: dict):
        return decode_step(cfg, params, tokens, positions, cache)

    return _decode


def greedy_generate(
    cfg: ModelConfig,
    params,
    prompt,                   # (b, s0) token ids
    max_new_tokens: int,
    max_seq: int | None = None,
) -> torch.Tensor:
    """Greedy decoding: prefill via repeated decode (cache-exact), then
    generate.  Runs on the device the parameters lie on."""
    dev = params["embed"]["embedding"].device
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, s0 = prompt.shape
    max_seq = max_seq or (s0 + max_new_tokens)
    cache = init_cache(cfg, b, max_seq, device=dev)
    step = make_decode_step(cfg)

    tokens = prompt[:, :1]
    out = [prompt]
    for t in range(s0 + max_new_tokens - 1):
        pos = torch.full((b,), t, dtype=torch.long, device=dev)
        logits, cache = step(params, tokens, pos, cache)
        if t + 1 < s0:
            tokens = prompt[:, t + 1 : t + 2]
        else:
            tokens = logits[:, -1].argmax(dim=-1)[:, None]
            out.append(tokens)
    return torch.cat(out, dim=1)


class BatchingQueue:
    """Continuous-batching request queue for the serve runtime: requests
    join/leave the decode batch at token boundaries (slot-based, static
    batch shape).  A plain copy of the reference's queue."""

    def __init__(self, cfg: ModelConfig, batch_slots: int, max_seq: int):
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.free = list(range(batch_slots))
        self.active: dict[int, dict] = {}   # slot -> request
        self.waiting: list[dict] = []
        self.finished: list[dict] = []

    def submit(self, request: dict) -> None:
        """request: {"id", "prompt" (list[int]), "max_new_tokens"}."""
        self.waiting.append(request)

    def admit(self) -> list[tuple[int, dict]]:
        admitted = []
        while self.free and self.waiting:
            slot = self.free.pop()
            req = self.waiting.pop(0)
            req = {**req, "generated": [], "pos": 0}
            self.active[slot] = req
            admitted.append((slot, req))
        return admitted

    def step_done(self, slot: int, token: int) -> None:
        req = self.active[slot]
        if req["pos"] + 1 >= len(req["prompt"]):
            req["generated"].append(token)
        req["pos"] += 1
        done_len = len(req["generated"]) >= req["max_new_tokens"]
        if done_len or req["pos"] >= self.max_seq - 1:
            self.finished.append(req)
            del self.active[slot]
            self.free.append(slot)

    @property
    def idle(self) -> bool:
        return not self.active and not self.waiting
