"""Architecture registry of the port: the reference's ten archs.

Dense (minitron, smollm), the GELU-MLP MQA stack (granite), MoE (olmoe),
MLA + MoE (deepseek-v3), the attention-free Mamba-2 stack (mamba2), the
Mamba + attention + MoE hybrid (jamba), the VLM backbone with its image
projector (pixtral) and the encoder-decoder (seamless-m4t).

``get_arch(name)`` returns an :class:`ArchDef` with the published config
(``make_config``) and the reduced smoke config the tests use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models.encdec import EncDecConfig
from repro_torch.models.lm import LMConfig
from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig

__all__ = ["ArchDef", "ARCHS", "get_arch", "OPT_DTYPE_OVERRIDES",
           "DECODE_SRC_LEN"]

# Optimizer-state dtype overrides: the largest configs keep Adam moments
# in bf16.
OPT_DTYPE_OVERRIDES = {
    "deepseek-v3-671b": "bfloat16",
    "jamba-v0.1-52b": "bfloat16",
    "granite-34b": "bfloat16",
}

DECODE_SRC_LEN = 1024  # seamless: encoder frames cached for decoding


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str
    kind: str                          # lm | encdec
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
                    dtype="float32", remat="none", q_block=16, kv_block=16)


def _smollm_135m() -> LMConfig:
    # [dense] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
    return LMConfig(name="smollm-135m", n_layers=30, d_model=576, n_heads=9,
                    n_kv=3, head_dim=64, d_ff=1536, vocab=49152,
                    tie_embeddings=True)


def _smollm_135m_smoke() -> LMConfig:
    return LMConfig(name="smollm-135m-smoke", n_layers=2, d_model=48,
                    n_heads=3, n_kv=1, head_dim=16, d_ff=96, vocab=256,
                    dtype="float32", remat="none", q_block=16, kv_block=16)


def _minitron_8b() -> LMConfig:
    # [dense] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
    return LMConfig(name="minitron-8b", n_layers=32, d_model=4096,
                    n_heads=32, n_kv=8, head_dim=128, d_ff=16384,
                    vocab=256000, mixer="attn", ffn="dense",
                    tie_embeddings=True)


def _minitron_8b_smoke() -> LMConfig:
    return LMConfig(name="minitron-8b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=256,
                    dtype="float32", remat="none", mixer="attn", ffn="dense",
                    q_block=16, kv_block=16)


def _granite_34b() -> LMConfig:
    # [dense] 88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576
    # vocab=49152; GPT-BigCode plain GELU MLP.
    return LMConfig(name="granite-34b", n_layers=88, d_model=6144,
                    n_heads=48, n_kv=1, head_dim=128, d_ff=24576,
                    vocab=49152, mixer="attn", ffn="dense", gated_ffn=False,
                    tie_embeddings=True)


def _granite_34b_smoke() -> LMConfig:
    return LMConfig(name="granite-34b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv=1, head_dim=16, d_ff=128, vocab=256,
                    dtype="float32", remat="none", mixer="attn", ffn="dense",
                    gated_ffn=False, q_block=16, kv_block=16)


def _olmoe_1b_7b() -> LMConfig:
    # [moe] 16L d_model=2048 16H (kv=16 = MHA) d_ff=1024 (per expert)
    # vocab=50304, MoE 64 experts top-8 on every layer.
    return LMConfig(name="olmoe-1b-7b", n_layers=16, d_model=2048,
                    n_heads=16, n_kv=16, head_dim=128, d_ff=1024,
                    vocab=50304, mixer="attn", ffn="moe", moe_every=1,
                    tie_embeddings=True,
                    moe=MoEConfig(n_experts=64, top_k=8, d_model=2048,
                                  d_ff=1024, capacity_factor=1.25))


def _olmoe_1b_7b_smoke() -> LMConfig:
    return LMConfig(name="olmoe-1b-7b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv=4, head_dim=16, d_ff=32, vocab=256,
                    dtype="float32", remat="none", mixer="attn", ffn="moe",
                    moe_every=1, q_block=16, kv_block=16,
                    moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32,
                                  capacity_factor=2.0))


DEEPSEEK_DENSE_PREFIX_FF = 18432   # d_ff of the 3 dense prefix layers


def _deepseek_v3_671b() -> LMConfig:
    # [moe] 61L d_model=7168 128H d_ff=2048 (per routed expert)
    # vocab=129280; 1 shared + 256 routed experts top-8, the first 3
    # layers dense (d_ff 18432); MLA q_lora 1536, kv_lora 512, nope 128,
    # rope 64, v 128; untied head.  The MTP head is omitted, as in the
    # reference.
    return LMConfig(name="deepseek-v3-671b", n_layers=61, d_model=7168,
                    n_heads=128, n_kv=128, head_dim=128,
                    d_ff=DEEPSEEK_DENSE_PREFIX_FF, vocab=129280,
                    mixer="mla", ffn="moe", moe_every=1, moe_start_layer=3,
                    tie_embeddings=False,
                    mla=MLAConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                                  kv_lora_rank=512, qk_nope_dim=128,
                                  qk_rope_dim=64, v_head_dim=128),
                    moe=MoEConfig(n_experts=256, top_k=8, d_model=7168,
                                  d_ff=2048, n_shared=1, shared_d_ff=2048,
                                  capacity_factor=1.25))


def _deepseek_v3_671b_smoke() -> LMConfig:
    return LMConfig(name="deepseek-v3-671b-smoke", n_layers=4, d_model=64,
                    n_heads=4, n_kv=4, head_dim=16, d_ff=128, vocab=256,
                    dtype="float32", remat="none", mixer="mla", ffn="moe",
                    moe_every=1, moe_start_layer=1, tie_embeddings=False,
                    q_block=16, kv_block=16,
                    mla=MLAConfig(d_model=64, n_heads=4, q_lora_rank=32,
                                  kv_lora_rank=16, qk_nope_dim=16,
                                  qk_rope_dim=8, v_head_dim=16),
                    moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32,
                                  n_shared=1, shared_d_ff=32,
                                  capacity_factor=2.0))


def _mamba2_780m() -> LMConfig:
    # [ssm] 48L d_model=1536 (attention-free) vocab=50280, ssm_state=128;
    # d_inner = 2 * d_model = 3072, head_dim 64 -> 48 SSD heads, conv 4.
    return LMConfig(name="mamba2-780m", n_layers=48, d_model=1536,
                    n_heads=0, n_kv=0, head_dim=1, d_ff=0, vocab=50280,
                    mixer="mamba", ffn="none", tie_embeddings=True,
                    ssd_chunk=512,
                    mamba=Mamba2Config(d_model=1536, d_inner=3072,
                                       head_dim=64, d_state=128, n_groups=1,
                                       d_conv=4))


def _mamba2_780m_smoke() -> LMConfig:
    return LMConfig(name="mamba2-780m-smoke", n_layers=2, d_model=32,
                    n_heads=0, n_kv=0, head_dim=1, d_ff=0, vocab=256,
                    dtype="float32", remat="none", mixer="mamba", ffn="none",
                    ssd_chunk=16,
                    mamba=Mamba2Config(d_model=32, d_inner=64, head_dim=16,
                                       d_state=8, n_groups=1, d_conv=4))


def _jamba_v01_52b() -> LMConfig:
    # [hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
    # MoE 16 experts top-2 on every 2nd layer; period-8 blocks, attention
    # at index 3 of each, Mamba elsewhere.  Jamba v0.1's Mamba-1 mixers
    # are instantiated, as in the reference, as the SSD (Mamba-2) block
    # with Jamba's state size 16.
    return LMConfig(name="jamba-v0.1-52b", n_layers=32, d_model=4096,
                    n_heads=32, n_kv=8, head_dim=128, d_ff=14336,
                    vocab=65536, mixer="mamba", attn_every=8, attn_offset=3,
                    ffn="moe", moe_every=2, moe_offset=1, tie_embeddings=True,
                    mamba=Mamba2Config(d_model=4096, d_inner=8192,
                                       head_dim=128, d_state=16, n_groups=1,
                                       d_conv=4),
                    moe=MoEConfig(n_experts=16, top_k=2, d_model=4096,
                                  d_ff=14336, capacity_factor=1.25))


def _jamba_v01_52b_smoke() -> LMConfig:
    return LMConfig(name="jamba-v0.1-52b-smoke", n_layers=8, d_model=32,
                    n_heads=4, n_kv=2, head_dim=8, d_ff=64, vocab=256,
                    dtype="float32", remat="none", mixer="mamba", attn_every=8,
                    attn_offset=3, ffn="moe", moe_every=2, moe_offset=1,
                    q_block=16, kv_block=16, ssd_chunk=8,
                    mamba=Mamba2Config(d_model=32, d_inner=64, head_dim=16,
                                       d_state=8, n_groups=1, d_conv=4),
                    moe=MoEConfig(n_experts=4, top_k=2, d_model=32, d_ff=64,
                                  capacity_factor=2.0))


PIXTRAL_PATCHES, PIXTRAL_D_VISION = 256, 1024


def _pixtral_12b() -> LMConfig:
    # [vlm] 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072; the
    # vision frontend is a stub: 256 precomputed patch embeddings of
    # d_vision 1024, mapped into the decoder by a learned projector.
    return LMConfig(name="pixtral-12b", n_layers=40, d_model=5120,
                    n_heads=32, n_kv=8, head_dim=128, d_ff=14336,
                    vocab=131072, mixer="attn", ffn="dense",
                    tie_embeddings=True, n_image_patches=PIXTRAL_PATCHES,
                    d_vision=PIXTRAL_D_VISION)


def _pixtral_12b_smoke() -> LMConfig:
    return LMConfig(name="pixtral-12b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=256,
                    dtype="float32", mixer="attn", ffn="dense", q_block=16,
                    kv_block=16, remat="none", n_image_patches=8,
                    d_vision=32)


def _seamless_m4t_large_v2() -> EncDecConfig:
    # [audio] 24 + 24 L d_model=1024 16H (kv=16 = MHA) d_ff=8192
    # vocab=256206; the speech frontend (w2v-BERT) is a stub: precomputed
    # frame embeddings.
    return EncDecConfig(name="seamless-m4t-large-v2", enc_layers=24,
                        dec_layers=24, d_model=1024, n_heads=16, n_kv=16,
                        head_dim=64, d_ff=8192, vocab=256206)


def _seamless_m4t_large_v2_smoke() -> EncDecConfig:
    return EncDecConfig(name="seamless-m4t-large-v2-smoke", enc_layers=2,
                        dec_layers=2, d_model=64, n_heads=4, n_kv=4,
                        head_dim=16, d_ff=128, vocab=256, dtype="float32",
                        q_block=16, kv_block=16, remat="none")


ARCHS = {a.name: a for a in (
    ArchDef("minitron-4b", "dense", "lm", _minitron_4b, _minitron_4b_smoke,
            "arXiv:2407.14679; hf"),
    ArchDef("smollm-135m", "dense", "lm", _smollm_135m, _smollm_135m_smoke,
            "hf:HuggingFaceTB/SmolLM-135M; hf"),
    ArchDef("minitron-8b", "dense", "lm", _minitron_8b, _minitron_8b_smoke,
            "arXiv:2407.14679; hf"),
    ArchDef("granite-34b", "dense", "lm", _granite_34b, _granite_34b_smoke,
            "arXiv:2405.04324; hf"),
    ArchDef("olmoe-1b-7b", "moe", "lm", _olmoe_1b_7b, _olmoe_1b_7b_smoke,
            "arXiv:2409.02060; hf"),
    ArchDef("deepseek-v3-671b", "moe", "lm", _deepseek_v3_671b,
            _deepseek_v3_671b_smoke, "arXiv:2412.19437; hf"),
    ArchDef("mamba2-780m", "ssm", "lm", _mamba2_780m, _mamba2_780m_smoke,
            "arXiv:2405.21060; unverified"),
    ArchDef("jamba-v0.1-52b", "hybrid", "lm", _jamba_v01_52b,
            _jamba_v01_52b_smoke, "arXiv:2403.19887; hf"),
    ArchDef("pixtral-12b", "vlm", "lm", _pixtral_12b, _pixtral_12b_smoke,
            "hf:mistralai/Pixtral-12B-2409; unverified"),
    ArchDef("seamless-m4t-large-v2", "audio", "encdec",
            _seamless_m4t_large_v2, _seamless_m4t_large_v2_smoke,
            "arXiv:2308.11596; hf"),
)}


def get_arch(name: str) -> ArchDef:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
