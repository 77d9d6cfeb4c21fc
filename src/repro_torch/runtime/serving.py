"""Batched LM serving: prefill + decode with credit-bounded admission —
the port of ``repro.runtime.serving``.

Requests are admitted into a fixed-size batch of decode slots; a request
enters only when a slot (a §V-A credit) is free, so the KV cache can never
be overrun.  Prompts are left-padded to the batch's longest, prefilled
together (attention through the flash kernel), and decoded greedily over
the padded vocab.  The decode step runs eagerly; capturing it as a CUDA
graph is later work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.admission import AdmissionController
from repro_torch.models import transformer as tmod
from repro_torch.runtime.pipeline import resolve_device


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Single-sequence-position batch engine: all slots share a position
    clock, prompts are left-padded to a common length (the standard
    static-batch serving scheme).

    Runs on ``device`` (the card by default; raises when there is none
    unless ``device="cpu"``), where ``params`` must already lie.  On the
    card it sets f32 products to full f32 (TF32 off) for the process, once,
    as the reference's f32 unembed needs."""

    def __init__(self, params, arch: ArchConfig, *, batch_slots: int = 4,
                 max_seq: int = 128, device="cuda"):
        self.device = resolve_device(device)
        where = params["embed"]["table"].device
        if where.type != self.device.type:
            raise ValueError(f"params lie on {where}, the engine runs on "
                             f"{self.device}")
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self.params = params
        self.arch = arch
        self.slots = batch_slots
        self.max_seq = max_seq
        # free decode slots ARE §V-A credits
        self.admission = AdmissionController(batch_slots, name="lm-serving")

    @property
    def credits(self) -> int:
        """Free slots (read-only view of the admission controller)."""
        return self.admission.free_credits

    def admit(self, reqs: List[Request]) -> List[Request]:
        """Admit up to ``credits`` requests; returns those admitted."""
        taken = []
        for r in reqs:
            if not self.admission.try_acquire():
                break
            taken.append(r)
        return taken

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve all requests to completion, batch at a time."""
        pending = list(requests)
        finished: List[Request] = []
        while pending:
            batch = self.admit(pending)
            pending = pending[len(batch):]
            if batch:
                finished.extend(self._serve_batch(batch))
                self.admission.release(len(batch))
        self.admission.assert_quiescent()
        return finished

    @torch.inference_mode()
    def _serve_batch(self, batch: List[Request]) -> List[Request]:
        arch = self.arch
        S = max(len(r.prompt) for r in batch)
        toks = np.zeros((len(batch), S), np.int64)
        for i, r in enumerate(batch):
            toks[i, S - len(r.prompt):] = r.prompt      # left pad
        feed = {"tokens": torch.from_numpy(toks).to(self.device)}
        # the stub front ends' inputs, zeros as in the JAX engine
        if arch.family == "vlm":
            feed["patches"] = torch.zeros(
                (len(batch), arch.n_patches, arch.d_model),
                dtype=torch.float32, device=self.device)
        if arch.enc_dec:
            feed["frames"] = torch.zeros(
                (len(batch), arch.n_frames, arch.d_model),
                dtype=torch.float32, device=self.device)
        logits, cache = tmod.prefill(self.params, arch, feed, self.max_seq)
        nxt = logits.argmax(-1)
        for r, t in zip(batch, nxt.tolist()):
            r.out.append(t)
        max_new = max(r.max_new for r in batch)
        pos = S
        for _ in range(max_new - 1):
            logits, cache = tmod.decode_step(self.params, arch, cache,
                                             nxt[:, None], pos)
            nxt = logits.argmax(-1)
            for r, t in zip(batch, nxt.tolist()):
                if len(r.out) < r.max_new:
                    r.out.append(t)
            pos += 1
        for r in batch:
            r.done = True
        return batch
