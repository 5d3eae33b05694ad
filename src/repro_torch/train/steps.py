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

import contextlib
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (OptConfig, OptState, apply_updates, init_opt_state,
                                         reference_leaf)


class TrainState(NamedTuple):
    params: T.LM
    opt: OptState


def default_opt_config(cfg: ModelConfig, total_steps: int = 10_000) -> OptConfig:
    # factored moments for the very large MoEs: AdamW moments alone would
    # be 2x4 bytes/param
    if cfg.num_experts and cfg.num_layers * cfg.d_model >= 94 * 4096:
        return OptConfig(kind="adafactor", total_steps=total_steps)
    return OptConfig(kind="adamw", total_steps=total_steps)


def batch_struct(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> Dict[str, torch.Tensor]:
    """The model inputs of one step as empty tensors (on ``meta``: shapes
    and dtypes only; the dry run's stand-ins), with the reference's names:
    int32 ``tokens`` and, to train, ``labels`` (B, S) ((B, 1) to decode);
    for train and prefill, the vlm's ``img_embed`` (B, num_image_tokens,
    frontend_dim) and Whisper's ``enc_embed`` (B, encoder_seq, d) in the
    compute dtype, the stub frontends' outputs."""
    B, S = shape.global_batch, shape.seq_len
    names = ("tokens", "labels") if shape.kind == "train" else ("tokens",)
    size = (B, 1) if shape.kind == "decode" else (B, S)
    out = {n: torch.empty(size, dtype=torch.int32, device=device) for n in names}
    frontend = {"vlm": ("img_embed", cfg.num_image_tokens, cfg.frontend_dim or cfg.d_model),
                "encdec": ("enc_embed", cfg.encoder_seq, cfg.d_model)}.get(cfg.family)
    if frontend and shape.kind != "decode":
        name, rows, width = frontend
        out[name] = torch.empty((B, rows, width), dtype=cfg.cdtype, device=device)
    return out


def serve_state_struct(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> T.StepState:
    """A decode-time ``StepState`` with a cache of depth ``shape.seq_len``
    for ``shape.global_batch`` sequences, on ``meta`` by default (the dry
    run's KV and state stand-in)."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, device=device)


def make_batch(cfg: ModelConfig, shape: ShapeSpec, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A random batch of ``batch_struct``'s names, shapes and dtypes:
    tokens and labels uniform in the vocabulary, the frontend inputs normal
    times 0.02 (drawn in float32, then cast). Drawn from ``generator`` on
    its device, in that order. The draws are torch's, not ``jax.random``'s:
    tests that hold the port to the reference feed both the same numpy
    batch."""
    dev = generator.device
    out = {}
    for name, t in batch_struct(cfg, shape).items():
        if t.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, t.shape, generator=generator,
                                      dtype=torch.int32, device=dev)
        else:
            out[name] = (torch.randn(t.shape, generator=generator, device=dev) * 0.02).to(t.dtype)
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


def mesh_rules(cfg: ModelConfig) -> dict:
    """The sharding rules of the config's profile."""
    return shd.rules_for_profile(cfg.sharding_profile)


def rows_of(batch: Dict[str, torch.Tensor], mesh, rules) -> tuple:
    """(this rank's block of rows of each tensor of a global batch, the
    axes the rows are split on: ``spec_for`` of the batch dim under the
    ``batch`` rule). A batch that does not split over the rule's axes
    present in the mesh is refused."""
    B = batch["tokens"].shape[0]
    entry = shd.spec_for(mesh, (B,), ("batch",), rules)[0]
    axes = shd.entry_axes(entry)
    want = mesh.axes([a for a in rules.get("batch", ()) if a in mesh.shape])
    if axes != want:
        raise ValueError(f"a batch of {B} rows does not split over the mesh axes {want}")
    return {k: shd.shard_of(v, (entry,), mesh) for k, v in batch.items()}, axes


def make_train_step(cfg: ModelConfig, oc: Optional[OptConfig] = None, accum_steps: int = 1,
                    mesh=None):
    """``train_step(state, batch) -> (state, {"loss", "lr", "grad_norm"})``.

    The step updates the model's parameters and the moments in place
    (``apply_updates``) and returns the state with the new step.
    ``accum_steps > 1`` splits the batch into that many microbatches of
    consecutive rows, run one after another: losses and float32 gradients
    are summed, then divided by ``accum_steps``. A parameter the batch
    does not reach gets a zero gradient, as under ``jax.grad``.

    On a ``mesh`` (every family; ``distributed/sharding.py``)
    the state holds the rank's blocks (``init_params(mesh=)``,
    ``train_state_from_numpy(mesh=)``) and every rank passes the same
    global batch: each microbatch's rows are split over the batch axes and
    the rank takes its block. Its loss is its rows' NLL over the global
    count of labelled tokens, so the ranks' losses and gradients add up to
    the global ones: a leaf sharded on a batch axis got that sum from its
    gather's backward (a reduce-scatter), the others are all-reduced over
    the batch axes they are not sharded on. The reported loss is the sum;
    every rank ends the step with the same replicated leaves."""
    oc = oc or default_opt_config(cfg)
    loss_fn = make_loss_fn(cfg)
    specs = rules = None
    if mesh is not None:
        rules = mesh_rules(cfg)
        specs = T.param_specs(cfg, mesh, rules)

    def value_and_grad(model, params, batch):
        split = ()
        if mesh is not None:
            batch, split = rows_of(batch, mesh, rules)
        with shd.batch_split(split):
            loss = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
        if mesh is not None:
            loss = shd.all_reduce(loss.detach(), split, mesh)
        return loss.detach(), dict(zip(params, grads)), split

    def grads_of(model, params, batch):
        if accum_steps == 1:
            return value_and_grad(model, params, batch)
        B = batch["tokens"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} microbatches")
        b = B // accum_steps
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for n, p in params.items()}
        for i in range(accum_steps):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            li, gi, split = value_and_grad(model, params, mb)
            loss = loss + li
            for n, g in gi.items():
                grads[n] += g
            del gi
        return loss / accum_steps, {n: g / accum_steps for n, g in grads.items()}, split

    def train_step(state: TrainState, batch):
        model = state.params
        params = dict(model.named_parameters())
        ctx = shd.use_mesh(mesh, rules) if mesh is not None else contextlib.nullcontext()
        with ctx, torch.enable_grad():
            loss, grads, split = grads_of(model, params, batch)
        if mesh is not None:
            for n in grads:
                sharded = shd.spec_axes(specs[n])
                grads[n] = shd.all_reduce(grads[n], [a for a in split if a not in sharded], mesh)
        _, opt, metrics = apply_updates(params, grads, state.opt, oc, mesh=mesh, specs=specs)
        return TrainState(model, opt), dict(metrics, loss=loss)

    return train_step


def state_specs(state: TrainState, cfg: ModelConfig, mesh) -> tuple:
    """({path: spec}, {path: whole shape}) of a ``TrainState``'s tensors on
    ``mesh`` under the config's profile, by ``CheckpointManager``'s paths:
    ``params/<name>``; AdamW's ``opt/m/<name>`` and ``opt/v/<name>`` like
    their parameter; Adafactor's ``opt/v/<key>`` (``/0`` and ``/1`` for its
    factors) by ``adafactor_specs``."""
    from repro_torch.train.optimizer import _factored_shape, adafactor_specs, moment_spec

    specs = T.param_specs(cfg, mesh, mesh_rules(cfg))
    shapes = T.param_shapes(cfg)
    out, full = {}, {}
    for n in specs:
        for pre in ("params", "opt/m", "opt/v") if state.opt.m is not None else ("params",):
            out[f"{pre}/{n}"], full[f"{pre}/{n}"] = specs[n], shapes[n]
    if state.opt.m is None:
        vspecs = adafactor_specs(specs, list(specs))
        for key, v in state.opt.v.items():
            names = [n for n in specs if reference_leaf(n)[0] == key]
            stack = reference_leaf(names[0])[1]
            whole = (() if stack is None else tuple(
                max(reference_leaf(n)[1][a] for n in names) + 1 for a in range(len(stack)))
                     ) + shapes[names[0]]
            sp = moment_spec(vspecs[key], v)
            if isinstance(v, tuple):
                fs = _factored_shape(whole)
                for i in range(2):
                    out[f"opt/v/{key}/{i}"], full[f"opt/v/{key}/{i}"] = sp[i], fs[i]
            else:
                out[f"opt/v/{key}"], full[f"opt/v/{key}"] = sp, whole
    return out, full


def make_init_fn(cfg: ModelConfig, oc: Optional[OptConfig] = None):
    """``init_fn(seed, device=None) -> TrainState``: ``init_params`` and
    zero moments."""
    oc = oc or default_opt_config(cfg)

    def init_fn(seed: int = 0, device=None, mesh=None) -> TrainState:
        model = T.init_params(cfg, seed=seed, device=device, mesh=mesh)
        return TrainState(model, init_opt_state(dict(model.named_parameters()), oc))

    return init_fn


def _last_logits(params, hidden, cfg: ModelConfig):
    """(float32 logits of the last position over this rank's block of the
    vocabulary, its first column, the axes the vocabulary is split on);
    the whole vocabulary, 0 and () without a mesh."""
    w, start, tp = L.vocab_weight(params.embed, cfg)
    return L._local_logits(w, hidden[:, -1], cfg, tp), start, tp


def make_prefill_step(cfg: ModelConfig, max_len: int, mesh=None, slots: Optional[int] = None):
    """``prefill_step(params, batch) -> (logits (B, V_pad), state)``.

    On a ``mesh`` (the rank's; ``params`` its blocks) every rank passes the
    same global batch. The state is laid out as the ``slots`` rows of an
    engine's state would be (default: the batch's own rows): the rows are
    split as there when they split the same way (the rank runs its rows),
    else every rank runs them all, with its blocks of the other dims (the
    one-row prefill the engine splices into a slot). The logits come back
    whole on every rank. Without a mesh every collective is the identity."""
    rules = None if mesh is None else mesh_rules(cfg)

    @torch.inference_mode()
    def prefill_step(params, batch):
        """Last-position logits (B, V_pad) of a fresh cache of ``max_len``
        filled with ``batch["tokens"]`` (and the cross caches from its
        ``img_embed`` or ``enc_embed``, where it has one), and that state."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        entry = T.batch_entry(mesh, B, slots, rules)
        rows = {k: shd.shard_of(v, (entry,), mesh) for k, v in batch.items()}
        state = T.init_cache(cfg, B, max_len, device=tokens.device, mesh=mesh,
                             layout_batch=slots, rules=rules)
        with shd.use_mesh(mesh, rules), shd.batch_split(shd.entry_axes(entry)):
            hidden, new_state = T.hidden_forward(
                params, rows["tokens"], cfg, img_embed=rows.get("img_embed"),
                enc_embed=rows.get("enc_embed"), state=state, decode=False)
            local, _, tp = _last_logits(params, hidden, cfg)
        return shd.gather(local, (entry, tp), mesh), new_state

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``decode_step(params, state, tokens) -> (logits (B, V_pad), next
    tokens (B,) int32, new state)``: one token per sequence at
    ``state.index``, the greedy one.

    On a ``mesh`` every rank passes the global tokens (B, 1) and the state
    of its blocks; the rank runs its rows, its logits' block of the
    vocabulary gives the greedy token by the distributed argmax
    (``sharding.vocab_argmax``: ``torch.argmax``'s first index on a tie),
    and the rows' tokens and the logits are gathered, so every rank
    returns them whole. Without a mesh every collective is the identity."""
    rules = None if mesh is None else mesh_rules(cfg)

    @torch.inference_mode()
    def decode_step(params, state: T.StepState, tokens):
        entry = T.rows_entry(state)
        split = shd.entry_axes(entry)
        with shd.use_mesh(mesh, rules), shd.batch_split(split):
            hidden, new_state = T.hidden_forward(params, shd.shard_of(tokens, (entry,), mesh), cfg,
                                                 state=state, decode=True)
            local, start, tp = _last_logits(params, hidden, cfg)
            next_tok = shd.all_gather(shd.vocab_argmax(local, start, tp), 0, split)
        return shd.gather(local, (entry, tp), mesh), next_tok.to(torch.int32), new_state

    return decode_step
