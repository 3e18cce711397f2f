"""Batched serving: continuous-batching request scheduler
(``repro/serve/scheduler.py``).

Requests (prompts) queue up; the scheduler packs up to ``max_batch`` slots,
prefills new requests into their slots, then decodes all active slots
together one token per step. A slot frees when its request emits EOS, hits
``max_new_tokens`` or reaches the end of the cache, and is refilled from
the queue on the next cycle.

The cache position is a per-slot vector (``cache["pos"]: (max_batch,)``),
so an admission wave prefills into *free* slots only: the wave runs on a
fresh zero cache and only the admitted slots' rows are merged back, so
in-flight slots keep their KV rows and decode positions. Attention masks
per slot, so right-padding an uneven wave cannot leak into the generated
tokens; SSM state carries the reference's small right-pad approximation
for uneven waves (the recurrence has no positions to mask), kept so that
the port's tokens equal the reference server's.

The server runs on the device its parameters lie on, eagerly (no ``jit``);
the model writes K/V rows into the cache in place. Latency accounting uses
``time.perf_counter`` and folds TTFT and total latency into the
``serve.ttft_s`` / ``serve.latency_s`` obs histograms.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs
from ..models.model import build_model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (len,) int32
    max_new_tokens: int = 32
    out_tokens: list = field(default_factory=list)
    done: bool = False
    # monotonic (perf_counter) timestamps: durations only, not wall time
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


def _merge_rows(live, fresh, mask: torch.Tensor):
    """``fresh``'s batch rows where ``mask`` holds, ``live``'s elsewhere, in a
    tree of stacked caches (the leading axis is the layer/site stack; batch
    is axis 1)."""
    if isinstance(live, dict):
        return {k: _merge_rows(live[k], fresh[k], mask) for k in live}
    return torch.where(mask.reshape((1, -1) + (1,) * (live.dim() - 2)), fresh, live)


class BatchedServer:
    def __init__(self, cfg, params, *, max_batch: int = 4, max_len: int = 256,
                 eos_id: int = 2):
        self.cfg = cfg
        self.params = params
        self.model = build_model(cfg)
        self.device = params["embed"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id

        # per-slot caches (batch dim = max_batch); positions per slot
        self.cache = self._fresh_cache()
        self.slot_req: list[Request | None] = [None] * max_batch
        self.queue: list[Request] = []
        self._next_rid = 0

    def _fresh_cache(self) -> dict:
        cache = self.model.init_cache(self.max_batch, self.max_len, device=self.device)
        cache["pos"] = torch.zeros((self.max_batch,), dtype=torch.int32, device=self.device)
        return cache

    # ------------------------------------------------------------------- API
    def submit(self, prompt, max_new_tokens=32, rid=None) -> Request:
        if rid is None:
            rid = self._next_rid
        # keep the counter ahead of explicit rids so later defaults never
        # collide with them (or with requests already drained from the queue)
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens,
                      t_submit=time.perf_counter())
        self.queue.append(req)
        return req

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Run until queue + slots drain. Returns completed requests."""
        completed: list[Request] = []
        seen_rids: set[int] = set()
        steps = 0
        while (self.queue or any(self.slot_req)) and steps < max_steps:
            self._fill_slots()
            self._decode_once()
            steps += 1
            for i, req in enumerate(self.slot_req):
                if req is not None and req.done:
                    if req.rid in seen_rids:
                        raise RuntimeError(f"duplicate request id {req.rid}")
                    seen_rids.add(req.rid)
                    completed.append(req)
                    self.slot_req[i] = None
        return completed

    # -------------------------------------------------------------- internals
    def _merge_admitted(self, live: dict, fresh: dict, mask: np.ndarray) -> dict:
        """Take admitted slots' rows from ``fresh``, everything else from
        ``live``: in-flight slots' KV rows and positions are untouched."""
        m = torch.from_numpy(mask).to(self.device)
        out = dict(live)
        out["pos"] = torch.where(m, fresh["pos"], live["pos"])
        for key in ("layers", "sites", "cross"):
            if key in live:
                out[key] = _merge_rows(live[key], fresh[key], m)
        return out

    def _fill_slots(self):
        """Admit queued requests into free slots while others keep decoding.

        The admission wave prefills on a *fresh* zero cache (so stale KV in
        recycled slots can't bleed in), then only the admitted slots' cache
        rows and positions are merged into the live cache."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not free or not self.queue:
            return
        admitted = []
        for i in free:
            if not self.queue:
                break
            req = self.queue.pop(0)
            self.slot_req[i] = req
            admitted.append((i, req))
        maxp = max(len(r.prompt) for _, r in admitted)
        toks = np.zeros((self.max_batch, maxp), np.int32)
        lens = np.zeros(self.max_batch, np.int32)
        mask = np.zeros(self.max_batch, bool)
        for i, req in admitted:
            toks[i, : len(req.prompt)] = req.prompt
            lens[i] = len(req.prompt)
            mask[i] = True
        fresh = self._fresh_cache()
        logits, fresh = self.model.forward_with_cache(self.params, {"tokens": toks}, fresh)
        # the wave is right-padded: each admitted slot's position is its own
        # prompt length, so decode overwrites the pad KV instead of appending
        fresh["pos"] = torch.from_numpy(lens).to(self.device)
        self.cache = self._merge_admitted(self.cache, fresh, mask)
        # first token comes from the last *real* prompt position
        slots = [i for i, _ in admitted]
        last = [len(r.prompt) - 1 for _, r in admitted]
        first = torch.argmax(logits[slots, last], dim=-1).tolist()
        now = time.perf_counter()
        for (_, req), nxt in zip(admitted, first):
            req.out_tokens = [int(nxt)]
            req.t_first = now
            obs.observe("serve.ttft_s", req.t_first - req.t_submit)

    def _decode_once(self):
        active = [(i, r) for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        cur = np.zeros((self.max_batch, 1), np.int32)
        for i, req in active:
            cur[i, 0] = req.out_tokens[-1] if req.out_tokens else self.eos_id
        logits, self.cache = self.model.decode_step(self.params, cur, self.cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).tolist()
        pos = self.cache["pos"].tolist()
        for i, req in active:
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            if tok == self.eos_id or len(req.out_tokens) >= req.max_new_tokens \
               or int(pos[i]) >= self.max_len - 1:
                req.done = True
                req.t_done = time.perf_counter()
                obs.observe("serve.latency_s", req.t_done - req.t_submit)
