"""Port kernel wrappers against the JAX kernels and their references.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernel
runs only on the card); the JAX kernels run in Pallas interpret mode at
tiny N, as ``tests/test_kernels.py`` runs them.  Bytes must be equal.
``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mac as j_mac
from repro.core.secure_memory import SecureKeys as JKeys
from repro.kernels.aes_ctr import ops as j_aes_ops
from repro.kernels.aes_ctr import ref as j_aes_ref
from repro.kernels.fused_crypt_mac import kernel as j_fused
from repro.kernels.fused_crypt_mac import ops as j_fused_ops
from repro.kernels.fused_crypt_mac import ref as j_fused_ref
from repro.core import baes as j_baes
from repro.kernels.otp_xor import ops as j_ox_ops
from repro.kernels.otp_xor.ops import _div_lanes as j_div_lanes
from repro.kernels.otp_xor.ref import otp_xor_ref as j_otp_xor_ref
from repro.kernels.xormac import ops as j_xm_ops
from repro.kernels.xormac.ref import nh_hash_ref as j_nh_hash_ref
from repro_torch.core import mac
from repro_torch.core.bytesutil import i64
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.core.aes import SBOX_NP, key_expansion_np
from repro_torch.kernels.aes_ctr import kernel as aes_kernel
from repro_torch.kernels.aes_ctr import ops as aes_ops
from repro_torch.kernels.aes_ctr import ref as aes_ref
from repro_torch.kernels.common import check_operand, on_cpu
from repro_torch.kernels.fused_crypt_mac import kernel as fused
from repro_torch.kernels.fused_crypt_mac import ops as fused_ops
from repro_torch.kernels.fused_crypt_mac import ref as fused_ref
from repro_torch.kernels.otp_xor import ops as ox_ops
from repro_torch.kernels.otp_xor import ref as ox_ref
from repro_torch.kernels.xormac import kernel as xm_kernel
from repro_torch.kernels.xormac import ops as xm_ops
from repro_torch.kernels.xormac import ref as xm_ref


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    """Port tensor -> numpy in the reference dtype (u32 for int32 lanes)."""
    a = t.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


@pytest.fixture(scope="module")
def keys():
    return JKeys.derive(99), SecureKeys.derive(99, device="cpu")


def test_keystream_matches_jax_kernel_and_ref(keys):
    jk, tk = keys
    words = np.random.default_rng(0).integers(0, 2 ** 32, (11, 4), np.uint32)
    reset_launches()
    lanes = aes_ops.keystream_lanes(_u32(words), tk.round_keys)
    byts = aes_ops.keystream_bytes(_u32(words), tk.round_keys)
    assert LAUNCHES["aes_ctr_keystream"] == 0      # CPU: plain version
    j_lanes = np.asarray(j_aes_ops.keystream_lanes(jnp.asarray(words),
                                                   jk.round_keys))
    assert (_np(lanes) == j_lanes).all()
    assert (_np(byts) == np.asarray(j_aes_ops.keystream_bytes(
        jnp.asarray(words), jk.round_keys))).all()
    assert (_np(aes_ref.aes_ctr_keystream_lanes_ref(_u32(words),
                                                    tk.round_keys))
            == np.asarray(j_aes_ref.aes_ctr_keystream_lanes_ref(
                jnp.asarray(words), jk.round_keys))).all()



# A numpy model of the CUDA AES kernels' round structure
# (csrc/aes_ctr.cu), with the T-table the wrappers ship to the card.

def _byte_perm(x, y, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm(x, y, sel)`` on u32 arrays: result byte i is
    byte ``(sel >> 4 i) & 7`` of the eight bytes of (y:x)."""
    x, y = np.broadcast_arrays(np.uint32(x), np.uint32(y))
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _rotl(x, bits: int) -> np.ndarray:
    return (x << np.uint32(bits)) | (x >> np.uint32(32 - bits))


def _model_shared_tables(te0) -> np.ndarray:
    """The kernel's 64 KB of shared tables as u32 words: entry x is 256
    bytes, Te0[x] once per lane at byte 4 L, Te2[x] = rotl16(Te0[x])
    once per lane at byte 128 + 4 L."""
    halves = np.stack([te0, _rotl(te0, 16)], axis=1)        # (256, 2)
    return np.repeat(halves[:, :, None], 32, axis=2).reshape(-1)


def _model_keystream(words, rk_words, te0) -> np.ndarray:
    """(N, 4) u32 counter words and (N, 11, 4) u32 round-key words (each
    block's schedule, little-endian words) -> (N, 4) u32 OTP lanes, the
    way the kernel computes them: a byte swap per counter word, nine
    T-table rounds whose lookup addresses are one byte permute with the
    lane's offset, the last round's S bytes taken as byte 1 of Te0.
    Block i runs in lane i % 32."""
    mem = _model_shared_tables(te0)
    lane = np.arange(len(words), dtype=np.uint32) % np.uint32(32)
    off0, off2 = np.uint32(4) * lane, np.uint32(128) + np.uint32(4) * lane

    def look(x, row, off):                 # look<row>
        return mem[_byte_perm(x, off, 0x5504 | (row << 4)) // np.uint32(4)]

    s = [_byte_perm(words[:, j], 0, 0x0123) ^ rk_words[:, 0, j]
         for j in range(4)]
    for r in range(1, 10):                 # round_col
        cols = []
        for c in range(4):
            a, b, cc, d = (s[(c + i) % 4] for i in range(4))
            odd = look(b, 1, off0) ^ look(d, 3, off2)
            cols.append(look(a, 0, off0) ^ look(cc, 2, off2)
                        ^ _rotl(odd, 8) ^ rk_words[:, r, c])
        s = cols
    out = []
    for c in range(4):                     # last_col
        t = [look(s[(c + i) % 4], i, off0) for i in range(4)]
        lo = _byte_perm(t[0], t[1], 0x0051)
        hi = _byte_perm(t[2], t[3], 0x0051)
        out.append(_byte_perm(lo, hi, 0x5410) ^ rk_words[:, 10, c])
    return np.stack(out, axis=1)


def _table_case(case: str):
    """(counter words, (K, 11, 16) schedules, rows) for one case."""
    rng = np.random.default_rng(21)
    if case == "fips197_c1":               # FIPS-197 appendix C.1
        words = np.array([[0x00112233, 0x44556677, 0x8899AABB, 0xCCDDEEFF]],
                         np.uint32)
        return words, key_expansion_np(np.arange(16))[None], np.zeros(1, int)
    k = 1 if case == "one_key" else 12
    keys = rng.integers(0, 256, (k, 16), dtype=np.uint8)
    bank = np.stack([key_expansion_np(key) for key in keys])
    words = rng.integers(0, 2 ** 32, (97, 4), dtype=np.uint32)
    return words, bank, rng.integers(0, k, 97)


@pytest.mark.parametrize("case", ["one_key", "bank12", "fips197_c1"])
def test_t_table_model_matches_jax_and_plain(case):
    words, bank, rows = _table_case(case)
    te0 = _np(aes_kernel.t_table("cpu"))
    rk_words = bank.view("<u4").reshape(bank.shape[0], 11, 4)[rows]
    got = _model_keystream(words, rk_words, te0)
    want = np.empty_like(got)
    for r in np.unique(rows):              # the JAX reference, row by row
        sel = rows == r
        want[sel] = np.asarray(j_aes_ref.aes_ctr_keystream_lanes_ref(
            jnp.asarray(words[sel]), jnp.asarray(bank[r])))
    assert (got == want).all()
    if len(bank) == 1:
        plain = aes_ref.aes_ctr_keystream_lanes_ref(_u32(words),
                                                    torch.from_numpy(bank[0]))
    else:
        plain = aes_ref.aes_ctr_keystream_multi_lanes_ref(
            _u32(words), torch.from_numpy(bank),
            torch.from_numpy(rows.astype(np.int32)))
    assert (_np(plain) == got).all()
    if case == "fips197_c1":
        assert got.view(np.uint8).tobytes().hex() == \
            "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("row", [0, 1, 2, 3])
def test_t_table_rotations_are_mix_columns(row):
    """Te0 rotated left by 8 ``row`` bits is MixColumns of a column that
    holds S[x] in ``row`` and zeros elsewhere; S[x] is byte 1 of Te0."""
    te0 = aes_kernel.te0_table_np()
    assert (_np(aes_kernel.t_table("cpu")) == te0).all()
    s = SBOX_NP.astype(np.uint32)
    x2 = ((s << 1) ^ np.where(s & 0x80, 0x1B, 0)) & 0xFF
    coeffs = {1: s, 2: x2, 3: x2 ^ s}
    mix = [[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]]
    want = sum(coeffs[mix[out][row]].astype(np.uint32) << np.uint32(8 * out)
               for out in range(4))
    got = te0 if row == 0 else _rotl(te0, 8 * row)
    assert (got == want).all()
    assert ((te0 >> np.uint32(8)) & np.uint32(0xFF) == s).all()

def _fused_inputs(rng, jk, n, s):
    data = rng.integers(0, 2 ** 32, (n, 4 * s), np.uint32)
    base = rng.integers(0, 2 ** 32, (n, 4), np.uint32)
    bind = rng.integers(0, 2 ** 32, (n, 8), np.uint32)
    div = np.asarray(j_div_lanes(jk.round_keys, s))
    key = np.asarray(jk.hash_key)[: 4 * s + 8]
    return data, base, div, bind, key


@pytest.mark.parametrize("s", [1, 4, 11])
@pytest.mark.parametrize("write", [False, True])
def test_fused_crypt_mac_matches_jax(keys, s, write):
    jk, tk = keys
    rng = np.random.default_rng(10 * s + write)
    args = _fused_inputs(rng, jk, 6, s)
    assert (_np(fused_ops._div_lanes(tk.round_keys, s)) == args[2]).all()
    j_kernel = j_fused.fused_crypt_mac_write if write else j_fused.fused_crypt_mac
    j_ref = (j_fused_ref.fused_crypt_mac_write_ref if write
             else j_fused_ref.fused_crypt_mac_ref)
    port = fused.fused_crypt_mac_write if write else fused.fused_crypt_mac
    port_ref = (fused_ref.fused_crypt_mac_write_ref if write
                else fused_ref.fused_crypt_mac_ref)
    want_out, want_nh = j_ref(*map(jnp.asarray, args))
    if s == 4:      # seda's shape; the Pallas kernel in interpret mode
        k_out, k_nh = j_kernel(*map(jnp.asarray, args))
        assert (np.asarray(k_out) == np.asarray(want_out)).all()
        assert (np.asarray(k_nh) == np.asarray(want_nh)).all()
    for fn in (port, port_ref):
        out, nh = fn(*map(_u32, args))
        assert (_np(out) == np.asarray(want_out)).all()
        assert (_np(nh) == np.asarray(want_nh)).all()


@pytest.mark.parametrize("write", [False, True])
def test_secure_crossing_matches_jax_ops(keys, write):
    jk, tk = keys
    rng = np.random.default_rng(20 + write)
    n, bb = 5, 64
    data = rng.integers(0, 256, n * bb, np.uint8)
    words = rng.integers(0, 2 ** 32, (n, 4), np.uint32)
    fields = [rng.integers(0, 2 ** 32, n, np.uint32) for _ in range(5)]
    jb = j_mac.Binding.make(*map(jnp.asarray, fields))
    tb = mac.Binding.make(*(torch.from_numpy(f.astype(np.int64))
                            for f in fields))
    j_fn = (j_fused_ops.secure_write_kernel if write
            else j_fused_ops.secure_read_kernel)
    fn = fused_ops.secure_write_kernel if write else fused_ops.secure_read_kernel
    want_out, want_macs = j_fn(jnp.asarray(data), jb, jk.round_keys,
                               jnp.asarray(words), jk.hash_key, block_bytes=bb)
    out, macs = fn(torch.from_numpy(data), tb, tk.round_keys,
                   i64(_u32(words)), tk.hash_key, block_bytes=bb)
    assert (out.numpy() == np.asarray(want_out)).all()
    assert (macs.numpy() == np.asarray(want_macs)).all()
    # The crossing's MACs are the core engine's MACs of the ciphertext.
    ct = out if write else torch.from_numpy(data)
    core = mac.block_macs(ct.reshape(n, bb), tb, hash_key_u32=tk.hash_key,
                          round_keys=tk.round_keys)
    assert (core.numpy() == macs.numpy()).all()


def test_wide_blocks_are_refused(keys):
    _, tk = keys
    tb = mac.Binding.make(*(torch.zeros(1, dtype=torch.int64),) * 5)
    with pytest.raises(ValueError, match="narrow"):
        fused_ops.secure_read_kernel(torch.zeros(512, dtype=torch.uint8), tb,
                                     tk.round_keys,
                                     torch.zeros((1, 4), dtype=torch.int64),
                                     tk.hash_key, block_bytes=512)


def test_operand_checks_refuse_what_the_kernel_does_not_take():
    t = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        check_operand(t, "x", torch.int32, (None, 4))
    assert on_cpu(t, t)
    with pytest.raises(ValueError, match="devices"):
        on_cpu(t, torch.zeros(1, device="meta"))


@pytest.mark.parametrize("n,s", [(1, 2), (13, 4), (300, 8), (64, 32)])
def test_otp_xor_matches_jax_kernel(n, s):
    rng = np.random.default_rng(n * s)
    data = rng.integers(0, 2 ** 32, (n, s * 4), np.uint32)
    base = rng.integers(0, 2 ** 32, (n, 4), np.uint32)
    div = rng.integers(0, 2 ** 32, (s, 4), np.uint32)
    want = np.asarray(j_ox_ops.otp_xor(*map(jnp.asarray, (data, base, div))))
    assert (want == np.asarray(j_otp_xor_ref(
        *map(jnp.asarray, (data, base, div))))).all()
    reset_launches()
    for fn in (ox_ops.otp_xor, ox_ref.otp_xor_ref):
        assert (_np(fn(*map(_u32, (data, base, div)))) == want).all()
    assert LAUNCHES["otp_xor"] == 0                 # CPU: plain version


@pytest.mark.parametrize("block_bytes", [16, 32, 64, 128, 176])
def test_baes_encrypt_kernel_matches_jax(keys, block_bytes):
    jk, tk = keys
    rng = np.random.default_rng(block_bytes)
    n = 40
    pt = rng.integers(0, 256, block_bytes * n, np.uint8)
    cw = np.stack([np.zeros(n, np.uint32),
                   np.arange(n, dtype=np.uint32) * (block_bytes // 16),
                   np.zeros(n, np.uint32), np.full(n, 3, np.uint32)], -1)
    want = np.asarray(j_ox_ops.baes_encrypt_kernel(
        jnp.asarray(pt), jk.round_keys, jnp.asarray(cw),
        block_bytes=block_bytes))
    assert (want == np.asarray(j_baes.baes_encrypt(
        jnp.asarray(pt), jk.round_keys, jnp.asarray(cw),
        block_bytes=block_bytes, key=jk.key))).all()
    for words in (_u32(cw), i64(_u32(cw))):          # int32 or int64 words
        got = ox_ops.baes_encrypt_kernel(torch.from_numpy(pt), tk.round_keys,
                                         words, block_bytes=block_bytes)
        assert (got.numpy() == want).all()
    assert (_np(ox_ops._div_lanes(tk.round_keys, block_bytes // 16))
            == np.asarray(j_div_lanes(jk.round_keys, block_bytes // 16))).all()


def test_baes_encrypt_kernel_refuses_wide_blocks(keys):
    _, tk = keys
    with pytest.raises(ValueError, match="narrow"):
        ox_ops.baes_encrypt_kernel(torch.zeros(192, dtype=torch.uint8),
                                   tk.round_keys,
                                   torch.zeros((1, 4), dtype=torch.int32),
                                   block_bytes=192)


@pytest.mark.parametrize("n,lanes", [(1, 8), (50, 24), (200, 136), (3, 6)])
def test_nh_hash_kernel_matches_jax(keys, n, lanes):
    jk, tk = keys
    payload = np.random.default_rng(n).integers(0, 2 ** 32, (n, lanes),
                                                 np.uint32)
    key = np.asarray(jk.hash_key)[:lanes]
    want = np.asarray(j_xm_ops.nh_hash_kernel_call(jnp.asarray(payload),
                                                   jnp.asarray(key)))
    assert (want == np.asarray(j_nh_hash_ref(jnp.asarray(payload),
                                             jnp.asarray(key)))).all()
    reset_launches()
    for fn in (xm_kernel.nh_hash_kernel_call, xm_ref.nh_hash_ref):
        assert (_np(fn(_u32(payload), tk.hash_key[:lanes])) == want).all()
    assert LAUNCHES["nh_hash_kernel_call"] == 0


def test_nh_hash_kernel_checks_its_contract(keys):
    _, tk = keys
    with pytest.raises(ValueError, match="even"):
        xm_kernel.nh_hash_kernel_call(torch.zeros((2, 5), dtype=torch.int32),
                                      tk.hash_key[:5])
    with pytest.raises(ValueError, match="even"):
        xm_kernel.nh_hash_kernel_call(
            torch.zeros((1, 2 * xm_kernel.MAX_PAIRS + 2), dtype=torch.int32),
            torch.zeros(2 * xm_kernel.MAX_PAIRS + 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="key_u32"):
        xm_kernel.nh_hash_kernel_call(torch.zeros((2, 8), dtype=torch.int32),
                                      tk.hash_key[:10])


@pytest.mark.parametrize("block_bytes", [64, 512])
def test_block_and_layer_macs_kernel_match_jax(keys, block_bytes):
    jk, tk = keys
    rng = np.random.default_rng(2 + block_bytes)
    n = 33
    blocks = rng.integers(0, 256, (n, block_bytes), np.uint8)
    fields = (np.arange(n) * (block_bytes // 16), 7, 2, 1, np.arange(n))
    jb = j_mac.Binding.make(*fields)
    tb = mac.Binding.make(*(torch.as_tensor(np.asarray(f, np.int64))
                            for f in fields))
    kw = dict(hash_key_u32=jk.hash_key, round_keys=jk.round_keys)
    want = np.asarray(j_xm_ops.block_macs_kernel(jnp.asarray(blocks), jb,
                                                 **kw))
    assert (want == np.asarray(j_mac.block_macs(jnp.asarray(blocks), jb,
                                                **kw))).all()
    tkw = dict(hash_key_u32=tk.hash_key, round_keys=tk.round_keys)
    got = xm_ops.block_macs_kernel(torch.from_numpy(blocks), tb, **tkw)
    assert (got.numpy() == want).all()
    assert (xm_ref.block_macs_ref(torch.from_numpy(blocks), tb,
                                  **tkw).numpy() == want).all()
    want_layer = np.asarray(j_xm_ops.layer_mac_kernel(jnp.asarray(blocks), jb,
                                                      **kw))
    for fn in (xm_ops.layer_mac_kernel, xm_ref.layer_mac_ref):
        assert (fn(torch.from_numpy(blocks), tb, **tkw).numpy()
                == want_layer).all()
    with pytest.raises(ValueError, match="NH key too short"):
        xm_ops.block_macs_kernel(torch.from_numpy(blocks), tb,
                                 hash_key_u32=tk.hash_key[:8],
                                 round_keys=tk.round_keys)
