"""Deterministic, resumable synthetic token pipeline.

Every batch is derived purely from (seed, step), so any worker can
regenerate any batch and a restart needs only the step counter from the
checkpoint manifest.  The numpy draws are the reference's
(``repro.data.pipeline``) word for word, so a batch is bytes-equal to
the reference's; :func:`make_batch` hands it over as torch tensors on
an explicit device (the card unless ``"cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lm"            # lm | vlm | encdec
    n_image_patches: int = 0
    d_vision: int = 0
    d_model: int = 0            # encdec frame-embedding dim
    src_len: int = 0


def _tokens_for_step(cfg: DataConfig, step: int) -> np.ndarray:
    """Markov-ish synthetic tokens: deterministic in (seed, step)."""
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    base = rng.integers(0, cfg.vocab, size=(cfg.global_batch, cfg.seq_len + 1),
                        dtype=np.int64)
    # Learnable structure: each position repeats its predecessor with
    # p=0.5 (so tiny models show the loss decreasing).
    repeat = rng.random((cfg.global_batch, cfg.seq_len + 1)) < 0.5
    repeat[:, 0] = False
    out = np.where(repeat, np.roll(base, 1, axis=1), base)
    return out.astype(np.int32)


def make_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """Batch for ``step`` (pure function of config + step): int32
    ``tokens``/``labels`` (``tgt_tokens``/``labels`` and float32
    ``src_embeds`` for ``encdec``; float32 ``image_embeds`` added for
    ``vlm``) on ``device``."""
    device = resolve_device(device)

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    toks = _tokens_for_step(cfg, step)
    if cfg.kind == "encdec":
        rng = np.random.default_rng(np.uint64(cfg.seed * 9_000_003 + step))
        return {"src_embeds": t(rng.standard_normal(
                    (cfg.global_batch, cfg.src_len, cfg.d_model),
                    dtype=np.float32)),
                "tgt_tokens": t(toks[:, :-1]), "labels": t(toks[:, 1:])}
    batch = {"tokens": t(toks[:, :-1]), "labels": t(toks[:, 1:])}
    if cfg.kind == "vlm":
        # Labels cover the text positions only (the loss drops the prefix).
        rng = np.random.default_rng(np.uint64(cfg.seed * 7_000_003 + step))
        batch["image_embeds"] = t(rng.standard_normal(
            (cfg.global_batch, cfg.n_image_patches, cfg.d_vision),
            dtype=np.float32))
    return batch


class SyntheticLM:
    """Stateful iterator facade with O(1) checkpoint/restore."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device=None):
        self.cfg = cfg
        self.step = start_step
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = make_batch(self.cfg, self.step, self.device)
        self.step += 1
        return batch

    # -- checkpoint integration ------------------------------------------

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError("data seed mismatch on resume")
        self.step = int(state["step"])
