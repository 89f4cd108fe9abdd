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
