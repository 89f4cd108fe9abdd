"""Architecture registry of the port: the dense archs this slice serves.

``get_arch(name)`` returns an :class:`ArchDef` with the published config
(``make_config``) and the reduced smoke config the tests use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models.lm import LMConfig

__all__ = ["ArchDef", "ARCHS", "get_arch"]


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str
    kind: str                          # lm
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    source: str


def _minitron_4b() -> LMConfig:
    # [dense] 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
    return LMConfig(name="minitron-4b", n_layers=32, d_model=3072,
                    n_heads=24, n_kv=8, head_dim=128, d_ff=9216,
                    vocab=256000, tie_embeddings=True)


def _minitron_4b_smoke() -> LMConfig:
    return LMConfig(name="minitron-4b-smoke", n_layers=2, d_model=96,
                    n_heads=6, n_kv=2, head_dim=16, d_ff=192, vocab=256,
                    dtype="float32", q_block=16, kv_block=16)


def _smollm_135m() -> LMConfig:
    # [dense] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
    return LMConfig(name="smollm-135m", n_layers=30, d_model=576, n_heads=9,
                    n_kv=3, head_dim=64, d_ff=1536, vocab=49152,
                    tie_embeddings=True)


def _smollm_135m_smoke() -> LMConfig:
    return LMConfig(name="smollm-135m-smoke", n_layers=2, d_model=48,
                    n_heads=3, n_kv=1, head_dim=16, d_ff=96, vocab=256,
                    dtype="float32", q_block=16, kv_block=16)


ARCHS = {a.name: a for a in (
    ArchDef("minitron-4b", "dense", "lm", _minitron_4b, _minitron_4b_smoke,
            "arXiv:2407.14679; hf"),
    ArchDef("smollm-135m", "dense", "lm", _smollm_135m, _smollm_135m_smoke,
            "hf:HuggingFaceTB/SmolLM-135M; hf"),
)}


def get_arch(name: str) -> ArchDef:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}")
    return ARCHS[name]
