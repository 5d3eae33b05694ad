"""Batched LM serving: prefill + decode with continuous batching (port of
``repro/serving/server.py``).

Requests (prompt token arrays) are admitted into a fixed set of batch
slots; every engine tick decodes one token for all active slots; finished
slots (EOS or max tokens) are refilled by prefilling pending requests.
Slot state lives in one ``StepState`` whose batch axis is the slot count:
a prefill runs on a one-sequence cache, which ``_splice_slot`` copies into
its slot in place. Everything runs under ``torch.inference_mode()`` on the
model's device.

Like the reference, every slot decodes at one shared position,
``state.index``, the longest prompt admitted so far plus the ticks since:
a slot whose prompt is shorter than another active slot's gets that
position for its RoPE and its cache write. The port keeps this so that it
gives the reference's tokens; the fault is recorded in ROADMAP Queue 3.
So is the splice of the hybrid family's Mamba2 states and of the vlm's
self-attention caches, which the reference writes into batch row 0
whatever the slot (``_splice_slot``), and so does the port. Requests are
prompts only, as in the reference: a vlm or Whisper prefill fills its
cross caches from the prompt itself (``models/transformer.py``), and a
prompt longer than those caches raises ``ValueError``.

Over a (data, model) mesh of ranks (``mesh=``; ``params`` the rank's
blocks, ``init_params(mesh=)``) every rank runs the same admissions and
ticks on the same requests. The state holds each leaf's ``spec_for``
block (slots over the batch axes, the cache's positions over the axes
the slots leave, the recurrent states' heads over ``model``); the
one-row prefill holds its row whole on every rank with the state's
blocks of the other dims, so a splice moves only the slot's rows and
only on the ranks that hold them (batch row 0, where the reference's
fault writes the twice-stacked leaves, lives on data rank 0). Every rank
agrees on every token: the prefill's logits come back whole, and a
tick's tokens come from the distributed argmax.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.graph_frontend import Clock
from repro_torch.train.steps import make_decode_step, make_prefill_step, mesh_rules


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: T.LM,
        slots: int = 4,
        max_len: int = 256,
        clock: Optional[Clock] = None,
        mesh=None,
    ):
        """``mesh``: serve over this rank's mesh (module docstring)."""
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        # injected monotonic clock; tests inject a FakeClock
        self.clock = clock or Clock()
        self.device = params.embed.table.device
        self.mesh = mesh
        with torch.inference_mode():
            self.state = T.init_cache(cfg, slots, max_len, device=self.device, mesh=mesh,
                                      rules=None if mesh is None else mesh_rules(cfg))
        self.active: List[Optional[Request]] = [None] * slots
        self.pending: Deque[Request] = deque()
        self._prefill = make_prefill_step(cfg, max_len, mesh=mesh, slots=slots)
        self._decode = make_decode_step(cfg, mesh=mesh)
        self.last_tok = np.zeros((slots, 1), dtype=np.int32)

    def submit(self, req: Request):
        req.t_submit = self.clock.now()
        self.pending.append(req)

    @torch.inference_mode()
    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.pending:
                req = self.pending.popleft()
                # prefill a single-sequence batch, then splice into slot s
                prompt = np.ascontiguousarray(req.prompt, dtype=np.int32)[None, :]
                tokens = torch.from_numpy(prompt).to(self.device)
                logits, st1 = self._prefill(self.params, {"tokens": tokens})
                tok = int(torch.argmax(logits[0]))
                req.out.append(tok)
                req.t_first = self.clock.now()
                self.last_tok[s, 0] = tok
                self.state = _splice_slot(self.state, st1, s, self.mesh)
                self.active[s] = req

    def tick(self) -> int:
        """One engine step: admit + decode all active slots. Returns the
        number of active slots."""
        self._admit()
        if not any(a is not None for a in self.active):
            return 0
        tokens = torch.from_numpy(self.last_tok).to(self.device)
        logits, nxt, self.state = self._decode(self.params, self.state, tokens)
        nxt = nxt.cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[s])
            req.out.append(tok)
            self.last_tok[s, 0] = tok
            done = len(req.out) >= req.max_new or (
                req.eos_id is not None and tok == req.eos_id
            )
            if done:
                req.t_done = self.clock.now()
                self.active[s] = None
        return sum(a is not None for a in self.active)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_ticks):
            before = [a for a in self.active if a is not None]
            n = self.tick()
            for r in before:
                if r not in self.active and r.t_done:
                    finished.append(r)
            if n == 0 and not self.pending:
                break
        return finished


def _splice_slot(state: T.StepState, single: T.StepState, slot: int, mesh=None) -> T.StepState:
    """Copy a one-sequence prefill state into batch position ``slot`` of
    ``state``, in place, leaf by leaf as the reference does: each cache
    leaf's batch is taken to be its axis 1 (``_update_axis1``). That holds
    for the KV caches and the ssm family's states, whose axis 0 is the
    cycle, so the whole ``S_max`` row or state goes to the slot and nothing
    of the slot's previous request survives. The hybrid family's Mamba2
    states are stacked twice, (cycles, attn_every, B, ...): there axis 1 is
    the block, and the reference (``src/repro/serving/server.py:119-133``)
    writes every admitted request's Mamba2 states into batch row 0 of every
    block; so with the vlm's self caches, (cycles, n_self, B, ...), whose
    axis 1 is the layer. Its cross caches and Whisper's caches are
    stacked once and land in their slot. The port keeps that fault, so
    that it gives the reference's tokens (ROADMAP Queue 3). On a ``mesh``
    the two states are blocks by their specs, and each rank writes the
    part of the slot's region its block holds."""
    dst_specs = [None] * len(T.cache_leaves(state.caches))
    src_specs = dst_specs
    if mesh is not None:
        dst_specs, src_specs = T.cache_leaves(state.specs), T.cache_leaves(single.specs)
    for dst, src, dsp, ssp in zip(T.cache_leaves(state.caches), T.cache_leaves(single.caches),
                                  dst_specs, src_specs):
        _update_axis1(dst, src, slot, mesh, dsp, ssp)
    # decode positions are per-slot in intent; the reference keeps the
    # max index and decodes every slot there (ROADMAP Queue 3)
    return T.StepState(caches=state.caches, index=max(state.index, single.index),
                       specs=state.specs)


def _update_axis1(dst: torch.Tensor, src: torch.Tensor, start: int, mesh=None, dst_spec=None,
                  src_spec=None) -> None:
    """``jax.lax.dynamic_update_slice_in_dim(dst, src, start, axis=1)`` in
    place: ``src`` goes to ``dst`` at ``start`` on axis 1 and 0 on every
    other axis, the start clamped so that ``src`` fits, as XLA clamps it.
    On a ``mesh`` both are the rank's blocks by their specs (``LeafSpec``):
    the rank writes the part of that region its ``dst`` block holds, from
    its ``src`` block, which must hold it."""
    at_dst, at_src = [], []
    for a in range(dst.ndim):
        dax = () if mesh is None else shd.entry_axes(dst_spec.entries[a])
        sax = () if mesh is None else shd.entry_axes(src_spec.entries[a])
        n_dst = dst.shape[a] * (1 if mesh is None else mesh.axis_size(dax))
        n_src = src.shape[a] * (1 if mesh is None else mesh.axis_size(sax))
        lo = min(max(start, 0), n_dst - n_src) if a == 1 else 0
        d0 = shd.block_range(n_dst, dax, mesh)[0] if dax else 0
        s0 = shd.block_range(n_src, sax, mesh)[0] if sax else 0
        r0, r1 = max(lo, d0), min(lo + n_src, d0 + dst.shape[a])
        if r0 >= r1:
            return  # no part of the region is this rank's
        if r0 - lo < s0 or r1 - lo > s0 + src.shape[a]:
            raise ValueError(f"the prefill's block of axis {a} does not hold the slot's region")
        at_dst.append(slice(r0 - d0, r1 - d0))
        at_src.append(slice(r0 - lo - s0, r1 - lo - s0))
    dst[tuple(at_dst)] = src[tuple(at_src)]
