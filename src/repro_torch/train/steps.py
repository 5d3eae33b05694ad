"""Prefill and decode steps (port of ``repro/train/steps.py:143-170``).

The training steps wait for ROADMAP Queue 1 item 15. Both steps run under
``torch.inference_mode()``: serving builds no autograd graph.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_len: int):
    @torch.inference_mode()
    def prefill_step(params, batch):
        """Last-position logits (B, V_pad) of a fresh cache of ``max_len``
        filled with ``batch["tokens"]``, and that state."""
        tokens = batch["tokens"]
        state = T.init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
        hidden, new_state = T.hidden_forward(params, tokens, cfg, state=state, decode=False)
        return T.last_logits(params, hidden, cfg), new_state

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def decode_step(params, state: T.StepState, tokens):
        """One token per sequence at ``state.index``: (logits (B, V_pad),
        greedy next tokens (B,) int32, new state)."""
        logits, new_state = T.forward(params, tokens, cfg, state=state, decode=True)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return logits[:, -1], next_tok, new_state

    return decode_step
