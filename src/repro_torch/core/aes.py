"""AES-128 (FIPS-197) in plain torch.

The S-box and round constants are built with numpy at import time (a
copy of the reference's construction, GF(2^8) inversion plus the affine
map); block encryption runs batched over a leading axis on any device.
State layout: a block is ``(16,)`` bytes in FIPS column-major order
(byte ``i`` is row ``i % 4``, column ``i // 4``).  Bytes are carried as
int64 during the rounds so table lookups can index directly.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SBOX_NP", "RCON_NP", "SHIFT_ROWS_PERM_NP", "key_expansion_np",
           "key_expansion", "sub_bytes", "shift_rows", "mix_columns",
           "add_round_key", "aes128_encrypt_block", "aes128_encrypt"]


def _build_sbox() -> np.ndarray:
    """AES S-box from GF(2^8) inversion + affine transform."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x1B if x & 0x80 else 0)
        x &= 0xFF
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    sbox = np.zeros(256, dtype=np.uint8)
    for v in range(256):
        inv = 0 if v == 0 else int(exp[255 - log[v]])
        res = 0x63
        for shift in range(5):
            res ^= ((inv << shift) | (inv >> (8 - shift))) & 0xFF
        sbox[v] = res
    return sbox


SBOX_NP = _build_sbox()
RCON_NP = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B,
                    0x36], dtype=np.uint8)
# ShiftRows on the column-major state: new[r + 4c] = old[r + 4((c + r) % 4)].
SHIFT_ROWS_PERM_NP = np.array(
    [(r + 4 * ((c + r) % 4)) for c in range(4) for r in range(4)],
    dtype=np.int64)

_TABLES: dict = {}


def _tables(device) -> tuple:
    """(sbox, perm, rcon) int64 tensors on ``device`` (cached)."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (
            torch.as_tensor(SBOX_NP.astype(np.int64), device=device),
            torch.as_tensor(SHIFT_ROWS_PERM_NP, device=device),
            torch.as_tensor(RCON_NP.astype(np.int64), device=device))
    return _TABLES[key]


def key_expansion_np(key) -> np.ndarray:
    """FIPS-197 key expansion in numpy: (16,) uint8 -> (11, 16) uint8,
    round keys in the key's flat byte order (bytes 4i..4i+3 = word i)."""
    key = np.asarray(key, dtype=np.uint8).reshape(16)
    words = [key[4 * i: 4 * i + 4].copy() for i in range(4)]
    for i in range(4, 44):
        temp = words[i - 1].copy()
        if i % 4 == 0:
            temp = np.roll(temp, -1)
            temp = SBOX_NP[temp]
            temp[0] ^= RCON_NP[i // 4 - 1]
        words.append(words[i - 4] ^ temp)
    return np.stack([np.concatenate(words[4 * r: 4 * r + 4])
                     for r in range(11)])


def key_expansion(key: torch.Tensor) -> torch.Tensor:
    """Batched key expansion on device: (..., 16) uint8 -> (..., 11, 16)."""
    sbox, _, rcon = _tables(key.device)
    k = key.to(torch.int64)
    words = [k[..., 4 * i: 4 * i + 4] for i in range(4)]
    for i in range(4, 44):
        temp = words[i - 1]
        if i % 4 == 0:
            temp = sbox[torch.roll(temp, -1, dims=-1)]
            temp = torch.cat([temp[..., :1] ^ rcon[i // 4 - 1], temp[..., 1:]],
                             dim=-1)
        words.append(words[i - 4] ^ temp)
    rounds = [torch.cat(words[4 * r: 4 * r + 4], dim=-1) for r in range(11)]
    return torch.stack(rounds, dim=-2).to(torch.uint8)


def sub_bytes(state: torch.Tensor) -> torch.Tensor:
    return _tables(state.device)[0][state]


def shift_rows(state: torch.Tensor) -> torch.Tensor:
    return state[..., _tables(state.device)[1]]


def _xtime(x: torch.Tensor) -> torch.Tensor:
    """Multiply by 2 in GF(2^8) with the AES reduction polynomial."""
    return ((x << 1) ^ ((x >> 7) & 1) * 0x1B) & 0xFF


def mix_columns(state: torch.Tensor) -> torch.Tensor:
    s = state.reshape(state.shape[:-1] + (4, 4))          # (..., col, row)
    a0, a1, a2, a3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    x0, x1, x2, x3 = _xtime(a0), _xtime(a1), _xtime(a2), _xtime(a3)
    b0 = x0 ^ (x1 ^ a1) ^ a2 ^ a3
    b1 = a0 ^ x1 ^ (x2 ^ a2) ^ a3
    b2 = a0 ^ a1 ^ x2 ^ (x3 ^ a3)
    b3 = (x0 ^ a0) ^ a1 ^ a2 ^ x3
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(state.shape)


def add_round_key(state: torch.Tensor,
                  round_key: torch.Tensor) -> torch.Tensor:
    return state ^ round_key


def aes128_encrypt_block(block: torch.Tensor,
                         round_keys: torch.Tensor) -> torch.Tensor:
    """Encrypt ``(..., 16)`` uint8 blocks with ``(11, 16)`` round keys
    (or per-block ``(..., 11, 16)`` schedules)."""
    rk = round_keys.to(torch.int64)
    state = block.to(torch.int64) ^ rk[..., 0, :]
    for i in range(1, 10):
        state = mix_columns(shift_rows(sub_bytes(state))) ^ rk[..., i, :]
    state = shift_rows(sub_bytes(state)) ^ rk[..., 10, :]
    return state.to(torch.uint8)


def aes128_encrypt(blocks: torch.Tensor,
                   round_keys: torch.Tensor) -> torch.Tensor:
    """Batched AES-128 encryption of ``(n, 16)`` uint8 blocks."""
    return aes128_encrypt_block(blocks, round_keys)
