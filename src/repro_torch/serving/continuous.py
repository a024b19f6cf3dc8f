"""Continuous-batching decode engine: counterpart of
``repro.serving.continuous``.

A fixed-width pool of decode slots shares ONE KV cache (one row per slot);
queued prompts are admitted into freed slots between steps (vLLM-style
scheduling) on the same ``lm.decode_step`` path the predictor serves with.
Every step advances ALL slots by one token.  With ``prefill_chunk=0`` (the
teacher-forced reference path) an admitted prompt is caught up by feeding
its tokens through the decode path, one per step, before it generates.
With ``prefill_chunk=C`` the prompt instead runs through ``lm.prefill_chunk``
in ceil(P/C) calls on a one-row cache, whose rows are then copied into the
slot's row, and the request enters the pool with its first token already
emitted.  Idle slots process a pad token whose writes land in their own
cache rows, never leaking across slots.

The engine runs on the device of the parameters and updates its caches in
place (``zero_`` / ``copy_`` on dim 1, the slot dim, of every ``phase*``
leaf).  Every step and every prefill pulls its argmax to the host, as the
reference does; that pull also waits for the card, which is what makes the
wall-clock timing of ``run()`` (``serving.gateway.router.BatcherBackend``)
a measurement of the device work.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..models import lm

PAD = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list          # token ids
    max_new: int
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    admitted_step: int = -1
    finished_step: int = -1


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0              # next cache position for this row
    remaining_prompt: int = 0  # tokens still being teacher-forced


def _device_of(params: dict) -> torch.device:
    for v in params.values():
        return _device_of(v) if isinstance(v, dict) else v.device
    raise ValueError("empty parameter tree")


def _slot_leaves(cache: dict):
    """Every per-slot tensor of a cache: the leaves under ``phase*``, whose
    dim 1 is the batch (slot) dim."""
    def walk(t):
        for v in t.values():
            yield from (walk(v) if isinstance(v, dict) else (v,))
    for k, v in cache.items():
        if k.startswith("phase"):
            yield from walk(v)


class ContinuousBatcher:
    def __init__(self, cfg: ArchConfig, params: dict, *, max_slots: int = 4,
                 max_len: int = 128, eos_id: Optional[int] = None,
                 prefill_chunk: int = 0):
        if cfg.family == "audio":
            raise ValueError("enc-dec admission not supported")
        self.cfg = cfg
        self.params = params
        self.device = _device_of(params)
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.prefill_chunk = int(prefill_chunk)
        self.cache = lm.init_cache(cfg, max_slots, max_len, device=self.device)
        self.slots = [_Slot() for _ in range(max_slots)]
        # deque: admission pops the head every step (a list's pop(0) is O(n))
        self.queue: collections.deque[Request] = collections.deque()
        self.requests: list[Request] = []   # submitted, not yet run()-returned
        self.step_count = 0
        self._next_rid = 0
        if self.prefill_chunk > 0:
            # one-row prefill cache, zeroed before each admission
            self._row_cache = lm.init_cache(cfg, 1, max_len, device=self.device)
            # per-phase counters the disaggregated cost model reads
            self.prefill_stats = {"requests": 0, "chunks": 0, "tokens": 0}

    # -- client API ---------------------------------------------------------
    def submit(self, prompt: list, max_new: int) -> Request:
        # A prompt must leave room for at least one generated token: the
        # done-check fires at pos >= max_len - 1 only once output exists, so a
        # longer prompt would walk pos past the cache bound.
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_len {self.max_len}: "
                "no room in the KV cache to generate")
        # rid is monotonic, not len(queue): admission pops the queue, so a
        # later submit would reuse a live rid.
        req = Request(rid=self._next_rid, prompt=list(prompt), max_new=max_new)
        self._next_rid += 1
        self.queue.append(req)
        self.requests.append(req)
        return req

    @property
    def active(self) -> int:
        return sum(s.req is not None for s in self.slots)

    def _reset_row(self, i: int) -> None:
        """Zero cache row i: KV rows would be masked by the lengths anyway,
        but recurrent state (SSM / mLSTM carries) persists across occupants
        and must be cleared at re-admission."""
        for t in _slot_leaves(self.cache):
            t[:, i].zero_()

    def _admit(self) -> None:
        for i, s in enumerate(self.slots):
            # loop: a prefilled request can finish at once (max_new 1, eos,
            # cache bound), freeing the slot for the next in the queue
            while s.req is None and self.queue:
                req = self.queue.popleft()
                req.admitted_step = self.step_count
                s.req = req
                self._reset_row(i)
                if self.prefill_chunk > 0 and req.prompt:
                    req.output.append(self._prefill_into(i, req))
                    s.pos = len(req.prompt)
                    s.remaining_prompt = 0
                    self._maybe_finish(s)
                else:
                    s.pos = 0
                    s.remaining_prompt = len(req.prompt)

    def _maybe_finish(self, s: _Slot) -> None:
        """The termination predicate the decode loop applies each step."""
        req = s.req
        hit_eos = self.eos_id is not None and req.output \
            and req.output[-1] == self.eos_id
        if req.output and (len(req.output) >= req.max_new or hit_eos
                           or s.pos >= self.max_len - 1):
            req.done = True
            req.finished_step = self.step_count
            s.req = None

    @torch.no_grad()
    def _prefill_into(self, i: int, req: Request) -> int:
        """Run the prompt through ``lm.prefill_chunk`` on the one-row cache,
        then copy its rows into slot i.  Returns the first generated token
        (argmax of the last prompt position's logits)."""
        prompt = torch.as_tensor(req.prompt, dtype=torch.int32, device=self.device)
        n = len(req.prompt)
        for t in _slot_leaves(self._row_cache):
            t.zero_()
        t0, logits = 0, None
        while t0 < n:
            c = min(self.prefill_chunk, n - t0)
            pos = torch.arange(t0, t0 + c, dtype=torch.int32, device=self.device)[None]
            logits, _ = lm.prefill_chunk(self.params, self.cfg, prompt[None, t0:t0 + c], pos,
                                         self._row_cache)
            self.prefill_stats["chunks"] += 1
            t0 += c
        self.prefill_stats["tokens"] += n
        self.prefill_stats["requests"] += 1
        self._scatter_row(i, self._row_cache)
        return int(torch.argmax(logits[0, -1]).item())

    def _scatter_row(self, i: int, row_cache: dict) -> None:
        """Copy a one-row prefill cache into row i of the shared cache."""
        for dst, src in zip(_slot_leaves(self.cache), _slot_leaves(row_cache)):
            dst[:, i].copy_(src[:, 0])

    # -- engine -------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        """Advance every slot one token; admit queued work into free slots."""
        self._admit()
        tokens, positions = [], []
        for s in self.slots:
            if s.req is None:
                tokens.append(PAD)
            elif s.remaining_prompt > 0:       # teacher-force the prompt
                tokens.append(s.req.prompt[len(s.req.prompt) - s.remaining_prompt])
            else:                              # feed back the last generated token
                tokens.append(s.req.output[-1] if s.req.output else s.req.prompt[-1])
            positions.append(s.pos)
        tok = torch.tensor(tokens, dtype=torch.int32, device=self.device)[:, None]
        pos = torch.tensor(positions, dtype=torch.int32, device=self.device)
        logits, _ = lm.decode_step(self.params, self.cfg, tok, pos, self.cache)
        nxt = torch.argmax(logits, dim=-1).tolist()     # the host pull: waits for the card

        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            s.pos += 1
            if s.remaining_prompt > 0:
                s.remaining_prompt -= 1
                if s.remaining_prompt == 0:
                    s.req.output.append(nxt[i])        # first generated token
            else:
                s.req.output.append(nxt[i])
            self._maybe_finish(s)
        self.step_count += 1

    def run(self, max_steps: int = 10_000) -> list:
        """Drain the queue; returns the requests finished since the last
        run() (each request is returned exactly once across repeated
        submit/run cycles, and returned requests stop being tracked).
        ``max_steps`` bounds this call, not the batcher's lifetime."""
        finished: list[Request] = []

        def collect():
            done = [r for r in self.requests if r.done]
            if done:
                finished.extend(done)
                self.requests = [r for r in self.requests if not r.done]

        collect()                      # finished through manual step()s
        start = self.step_count
        while (self.queue or self.active) and self.step_count - start < max_steps:
            self.step()
            collect()
        return finished
