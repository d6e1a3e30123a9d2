"""Continuous-batching serving engine (the counterpart of the JAX package's
`serve/engine.py`).

* fixed-size slot table — B concurrent sequences, slot i == batch row i of
  the batched KV cache / recurrent state;
* admission: waiting requests claim free slots; each prompt is prefilled
  into a single-lane cache, which is then copied into the slot's row;
* one decode step per engine tick advances every slot;
* completion: slots free on reaching their token budget (or their decode
  deadline) and are immediately reusable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.obs import NULL_OBS


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [P] int
    max_new_tokens: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    # per-request decode-tick deadline (None = engine default); past it the
    # request is evicted (done=True, evicted=True) and its slot freed
    deadline_ticks: Optional[int] = None
    evicted: bool = False


def _merge_lane(cache, lane_cache, row: int):
    """Copy lane 0 of `lane_cache` into batch row `row` of `cache`. Every
    cache tensor of the port is batch-first."""
    for dst, src in zip(cache["layers"], lane_cache["layers"]):
        for name, sub in dst.items():
            for key, t in sub.items():
                t[row] = src[name][key][0]


class ServeEngine:
    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 512,
                 dtype=torch.float32, obs=None,
                 deadline_ticks: Optional[int] = None, device="cuda"):
        self.device = api.resolve_device(device)
        api.require_params_on(params, self.device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.dtype = dtype
        self.deadline_ticks = deadline_ticks
        self.obs = obs if obs is not None else NULL_OBS
        self.cache = api.init_cache(cfg, slots, max_len, dtype, self.device)
        self._prefill = api.make_prefill_step(cfg)
        self._decode = api.make_decode_step(cfg)
        self.active: Dict[int, Request] = {}      # slot -> request
        self.positions = np.zeros(slots, np.int64)
        self.last_tok = np.zeros(slots, np.int64)
        self.slot_ticks = np.zeros(slots, np.int64)  # decode ticks in slot
        self.waiting: List[Request] = []

    def submit(self, req: Request):
        self.waiting.append(req)

    def _admit(self):
        free = [s for s in range(self.slots) if s not in self.active]
        while free and self.waiting:
            slot = free.pop(0)
            req = self.waiting.pop(0)
            with self.obs.span("serve/prefill", key=len(req.prompt),
                               slot=slot, prompt_len=len(req.prompt)) as sp:
                lane = api.init_cache(self.cfg, 1, self.max_len, self.dtype,
                                      self.device)
                toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                       device=self.device)[None]
                logits, lane = self._prefill(self.params, lane, {"tokens": toks})
                _merge_lane(self.cache, lane, slot)
                tok = int(torch.argmax(logits[0]))
                sp.sync = logits
            req.out.append(tok)
            self.active[slot] = req
            self.positions[slot] = len(req.prompt)
            self.last_tok[slot] = tok
            self.slot_ticks[slot] = 0
            self.obs.count("serve/admitted")

    @torch.inference_mode()
    def step(self):
        """One engine tick: admit, decode every slot, retire."""
        self._admit()
        if not self.active:
            return []
        with self.obs.span("serve/decode", key=self.slots,
                           active=len(self.active)) as sp:
            toks = torch.as_tensor(self.last_tok, dtype=torch.long,
                                   device=self.device)[:, None]
            pos = torch.as_tensor(self.positions, dtype=torch.int32,
                                  device=self.device)[:, None]
            logits, self.cache = self._decode(self.params, self.cache, toks, pos)
            nxt = torch.argmax(logits, -1).cpu().numpy()
            sp.sync = logits
        self.obs.count("serve/decode_tokens", len(self.active))
        finished = []
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.out.append(tok)
            self.positions[slot] += 1
            self.last_tok[slot] = tok
            self.slot_ticks[slot] += 1
            if (len(req.out) >= req.max_new_tokens
                    or self.positions[slot] >= self.max_len - 1):
                req.done = True
                finished.append(req)
                del self.active[slot]
                continue
            # max-ticks eviction: a stuck decode frees its slot
            deadline = req.deadline_ticks if req.deadline_ticks is not None \
                else self.deadline_ticks
            if deadline is not None and self.slot_ticks[slot] >= deadline:
                req.done = True
                req.evicted = True
                finished.append(req)
                del self.active[slot]
                self.obs.count("serve/evicted")
        return finished

    def run(self, max_ticks: int = 1000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_ticks):
            done += self.step()
            if not self.active and not self.waiting:
                break
        return done
