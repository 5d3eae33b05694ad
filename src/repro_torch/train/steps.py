"""Step builders (port of ``repro/train/steps.py:18-170``): the train step
with its optimizer state, batches, and the prefill and decode steps.

The train step runs under autograd for every family: the model's
forward (``hidden_forward``, each cycle recomputed in the backward under
``cfg.remat``), the chunked loss, one ``torch.autograd.grad`` for every
parameter (zero for those the batch does not reach: a vlm or Whisper
batch without its frontend input skips the cross layers and the
encoder, and the reference's gradient there is 0), then
``apply_updates``. Its kernels: attention's forward (and
its remat recompute) is the flash kernel, the embedding's backward the PB
rows reduce; in the moe family the dispatch runs the row scatter forward
and the rows reduce backward, the combine the rows reduce forward and the
row scatter backward, and counting dispatch the histogram and positions
kernels (``models/layers.py``). Prefill and decode run under
``torch.inference_mode()``: serving builds no autograd graph.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import OptConfig, OptState, apply_updates, init_opt_state


class TrainState(NamedTuple):
    params: T.LM
    opt: OptState


def default_opt_config(cfg: ModelConfig, total_steps: int = 10_000) -> OptConfig:
    # factored moments for the very large MoEs: AdamW moments alone would
    # be 2x4 bytes/param
    if cfg.num_experts and cfg.num_layers * cfg.d_model >= 94 * 4096:
        return OptConfig(kind="adafactor", total_steps=total_steps)
    return OptConfig(kind="adamw", total_steps=total_steps)


def make_batch(cfg: ModelConfig, shape: ShapeSpec, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A random batch of ``shape`` with the reference's names, shapes and
    dtypes (``batch_struct``): int32 ``tokens`` and, to train, ``labels``
    (B, S) ((B, 1) to decode); for train and prefill, the vlm's
    ``img_embed`` (B, num_image_tokens, frontend_dim) and Whisper's
    ``enc_embed`` (B, encoder_seq, d), normal times 0.02 in the compute
    dtype, the stub frontends' outputs. Drawn from ``generator`` on its
    device, in that order. The draws are torch's, not ``jax.random``'s:
    tests that hold the port to the reference feed both the same numpy
    batch."""
    B, S = shape.global_batch, shape.seq_len
    dev = generator.device
    names = ("tokens", "labels") if shape.kind == "train" else ("tokens",)
    size = (B, 1) if shape.kind == "decode" else (B, S)
    out = {n: torch.randint(0, cfg.vocab_size, size, generator=generator,
                            dtype=torch.int32, device=dev) for n in names}
    frontend = {"vlm": ("img_embed", cfg.num_image_tokens, cfg.frontend_dim or cfg.d_model),
                "encdec": ("enc_embed", cfg.encoder_seq, cfg.d_model)}.get(cfg.family)
    if frontend and shape.kind != "decode":
        name, rows, width = frontend
        out[name] = (torch.randn(B, rows, width, generator=generator, device=dev)
                     * 0.02).to(cfg.cdtype)
    return out


def make_loss_fn(cfg: ModelConfig):
    """``loss_fn(model, batch)``: the mean next-token loss of
    ``batch["tokens"]`` against ``batch["labels"]`` (the reference's
    ``loss_fn``): the backbone, with the batch's ``img_embed`` or
    ``enc_embed`` where it has one, then the chunked loss."""

    def loss_fn(model, batch):
        hidden, _ = T.hidden_forward(model, batch["tokens"], cfg,
                                     img_embed=batch.get("img_embed"),
                                     enc_embed=batch.get("enc_embed"))
        return T.chunked_lm_loss(model, hidden, batch["labels"], cfg, chunk=cfg.loss_chunk)

    return loss_fn


def make_train_step(cfg: ModelConfig, oc: Optional[OptConfig] = None, accum_steps: int = 1):
    """``train_step(state, batch) -> (state, {"loss", "lr", "grad_norm"})``.

    The step updates the model's parameters and the moments in place
    (``apply_updates``) and returns the state with the new step.
    ``accum_steps > 1`` splits the batch into that many microbatches of
    consecutive rows, run one after another: losses and float32 gradients
    are summed, then divided by ``accum_steps``. A parameter the batch
    does not reach gets a zero gradient, as under ``jax.grad``."""
    oc = oc or default_opt_config(cfg)
    loss_fn = make_loss_fn(cfg)

    def value_and_grad(model, params, batch):
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
        return loss.detach(), dict(zip(params, grads))

    def train_step(state: TrainState, batch):
        model = state.params
        params = dict(model.named_parameters())
        with torch.enable_grad():
            if accum_steps == 1:
                loss, grads = value_and_grad(model, params, batch)
            else:
                B = batch["tokens"].shape[0]
                if B % accum_steps:
                    raise ValueError(f"batch {B} does not split into {accum_steps} microbatches")
                b = B // accum_steps
                loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
                grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for n, p in params.items()}
                for i in range(accum_steps):
                    mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                    li, gi = value_and_grad(model, params, mb)
                    loss = loss + li
                    for n, g in gi.items():
                        grads[n] += g
                    del gi
                loss = loss / accum_steps
                grads = {n: g / accum_steps for n, g in grads.items()}
        _, opt, metrics = apply_updates(params, grads, state.opt, oc)
        return TrainState(model, opt), dict(metrics, loss=loss)

    return train_step


def make_init_fn(cfg: ModelConfig, oc: Optional[OptConfig] = None):
    """``init_fn(seed, device=None) -> TrainState``: ``init_params`` and
    zero moments."""
    oc = oc or default_opt_config(cfg)

    def init_fn(seed: int = 0, device=None) -> TrainState:
        model = T.init_params(cfg, seed=seed, device=device)
        return TrainState(model, init_opt_state(dict(model.named_parameters()), oc))

    return init_fn


def make_prefill_step(cfg: ModelConfig, max_len: int):
    @torch.inference_mode()
    def prefill_step(params, batch):
        """Last-position logits (B, V_pad) of a fresh cache of ``max_len``
        filled with ``batch["tokens"]`` (and the cross caches from its
        ``img_embed`` or ``enc_embed``, where it has one), and that state."""
        tokens = batch["tokens"]
        state = T.init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
        hidden, new_state = T.hidden_forward(
            params, tokens, cfg, img_embed=batch.get("img_embed"),
            enc_embed=batch.get("enc_embed"), state=state, decode=False)
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
