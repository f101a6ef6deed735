"""Continuous batching over the engine's request slots (port of
`magicpig_tpu/runtime/serving.py`).

Requests join a free slot whenever one opens (a prefill into slot i writes
only slot i's state), every decode step advances all live slots together,
and a finished request frees its slot at once (`LLM.release_slot`).

Two admission modes:
  * `interleave=False` (default): a queued request is prefilled in one go
    (`LLM.prefill`) before the next decode step, which stalls the live
    slots for the whole prompt;
  * `interleave=True`: each `step()` runs one prompt chunk of the request
    in flight (`LLM.start_prefill`), then the batched decode, so a live
    slot waits at most one chunk per step. It costs the engine's staging
    pair, one more request's K/V.

The batched decode runs over every slot, free ones included: their lengths
grow from 0 and their caches take rows nobody reads (the append clamps to
the last row, `runtime/server.py`). A fill sets a slot's caches and lengths
outright, so a later admission starts clean. Greedy tokens come from each
step's logits, one host read per step.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from magicpig_tpu_torch.runtime import state as state_lib


@dataclasses.dataclass
class Request:
    uid: int
    prompt: torch.Tensor          # [P] int64 token ids on the engine's device
    max_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    slot: int | None = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_tokens


class Scheduler:
    """Continuous batching over an `LLM` engine's slots.

        s = Scheduler(llm)
        s.submit(prompt_ids, max_tokens=64)
        while s.pending:
            finished = s.step()
    """

    def __init__(self, llm, interleave: bool = False):
        self.llm = llm
        self.interleave = interleave
        self.free = deque(range(llm.batch_size))
        self.active: dict[int, Request] = {}   # slot -> request
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._uid = 0
        self._next_tokens = np.zeros((llm.batch_size,), np.int64)
        self._inflight = None                   # (request, ChunkedPrefill)

    @property
    def pending(self) -> bool:
        return bool(self.queue or self.active or self._inflight)

    def submit(self, prompt, max_tokens: int = 64) -> int:
        """Queue a prompt (token ids); returns its request id."""
        lsh = self.llm.lsh
        budget = (state_lib.hot_capacity(lsh) - lsh.num_sink_tokens
                  - lsh.num_local_tokens)
        if lsh.enabled and max_tokens > budget:
            raise ValueError(f"max_tokens={max_tokens} exceeds the "
                             f"generation buffer ({budget} tokens)")
        self._uid += 1
        self.queue.append(Request(self._uid, self.llm._tokens(prompt),
                                  max_tokens))
        return self._uid

    def _activate(self, req: Request, logits: torch.Tensor) -> None:
        tok = int(logits[0].argmax())
        req.generated.append(tok)
        self._next_tokens[req.slot] = tok
        self.active[req.slot] = req

    def _admit(self) -> None:
        """Prefill queued requests into free slots."""
        while self.queue and self.free:
            req = self.queue.popleft()
            req.slot = self.free.popleft()
            self._activate(req, self.llm.prefill(req.prompt,
                                                 request_id=req.slot))

    def _admit_one_chunk(self) -> None:
        """Interleaved admission: at most one chunk of prefill work. The
        slot in flight is neither free nor active until its last chunk."""
        if self._inflight is None and self.queue and self.free:
            req = self.queue.popleft()
            req.slot = self.free.popleft()
            self._inflight = (req, self.llm.start_prefill(req.prompt,
                                                          req.slot))
        if self._inflight is not None:
            req, cp = self._inflight
            logits = cp.step()
            if logits is not None:
                self._activate(req, logits)
                self._inflight = None

    def _retire(self, req: Request, slot: int) -> None:
        self.active.pop(slot)
        self.free.append(slot)
        self.finished.append(req)
        self.llm.release_slot(slot)

    def step(self) -> list[Request]:
        """Admission, then one batched greedy decode step; returns the
        requests that finished in it."""
        if self.interleave:
            self._admit_one_chunk()
        else:
            self._admit()
        if not self.active:
            return []
        logits = self.llm.inference(self._next_tokens)
        tokens = logits.argmax(dim=-1).tolist()
        newly_done = []
        for slot, req in list(self.active.items()):
            tok = tokens[slot]
            req.generated.append(tok)
            self._next_tokens[slot] = tok
            if req.done or tok in self.llm.config.eos_token_ids:
                newly_done.append(req)
                self._retire(req, slot)
        return newly_done

    def run(self) -> list[Request]:
        """Drain everything; returns every finished request in finish order."""
        while self.pending:
            self.step()
        return self.finished
