"""Port mixed-key kernels (queue B 4-6) against the JAX kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels
run in Pallas interpret mode, as ``tests/test_kernels.py`` runs them.
The port's kernels take the key bank and one bank row per block; the
JAX kernels take the per-block tables gathered from the same bank.
Inputs come from numpy seeds; bytes must be equal for N in {1, 37, 300},
S in {1, 4, 11}, with rows mixed and all equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mac as j_mac
from repro.kernels.aes_ctr import kernel as j_aes
from repro.kernels.fused_crypt_mac import kernel as j_fused
from repro.kernels.fused_crypt_mac import ops as j_fused_ops
from repro.kernels.otp_xor.ops import _div_lanes as j_div_lanes
from repro.tenancy import KeyHierarchy as JHierarchy
from repro.tenancy import TenantRegistry as JRegistry
from repro_torch.core import mac
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.aes_ctr import kernel as aes_k
from repro_torch.kernels.aes_ctr import ops as aes_ops
from repro_torch.kernels.aes_ctr import ref as aes_ref
from repro_torch.kernels.fused_crypt_mac import kernel as fused
from repro_torch.kernels.fused_crypt_mac import ops as fused_ops
from repro_torch.kernels.fused_crypt_mac import ref as fused_ref
from repro_torch.tenancy import KeyHierarchy, TenantRegistry

NS = [1, 37, 300]
SS = [1, 4, 11]


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


@pytest.fixture(scope="module")
def banks():
    """The same 12-row key bank in both packages (4 tenants, retain 2,
    one rotation)."""
    out = []
    for reg in (JRegistry(JHierarchy(21), max_tenants=4),
                TenantRegistry(KeyHierarchy(21, device="cpu"),
                               max_tenants=4)):
        for t in range(4):
            reg.register(f"t{t}")
        reg.rotate("t2")
        out.append(reg.bank)
    return out


def _rows(rng, n: int, k: int, mixed: bool) -> np.ndarray:
    return (rng.integers(0, k, n) if mixed
            else np.full(n, 5)).astype(np.int32)


@pytest.mark.parametrize("mixed", [True, False])
@pytest.mark.parametrize("n", NS)
def test_keystream_multi_matches_jax_kernel(banks, n, mixed):
    j_bank, bank = banks
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2 ** 32, (n, 4), np.uint32)
    rows = _rows(rng, n, bank.key.shape[0], mixed)
    want = np.asarray(j_aes.aes_ctr_keystream_multi(
        jnp.asarray(words), j_bank.round_keys[rows]))
    reset_launches()
    lanes = aes_ops.keystream_lanes_multi(_u32(words), bank.round_keys,
                                          torch.from_numpy(rows))
    byts = aes_ops.keystream_bytes_multi(_u32(words), bank.round_keys,
                                         torch.from_numpy(rows))
    assert LAUNCHES["aes_ctr_keystream_multi"] == 0      # CPU: plain version
    assert (_np(lanes) == want).all()
    assert (byts.numpy() == want.view(np.uint8).reshape(n, 16)).all()
    assert (_np(aes_ref.aes_ctr_keystream_multi_lanes_ref(
        _u32(words), bank.round_keys, torch.from_numpy(rows))) == want).all()
    if mixed:
        # Bit-identical to the single-key kernel per distinct row.
        for r in np.unique(rows):
            sel = rows == r
            one = aes_k.aes_ctr_keystream(_u32(words[sel]),
                                          bank.round_keys[int(r)])
            assert (_np(one) == want[sel]).all()


@pytest.mark.parametrize("mixed", [True, False])
@pytest.mark.parametrize("s", SS)
@pytest.mark.parametrize("n", NS)
def test_fused_mixed_pair_matches_jax_kernels(banks, n, s, mixed):
    j_bank, bank = banks
    rng = np.random.default_rng(100 * n + s)
    k = bank.key.shape[0]
    rows = _rows(rng, n, k, mixed)
    data = rng.integers(0, 2 ** 32, (n, 4 * s), np.uint32)
    base = rng.integers(0, 2 ** 32, (n, 4), np.uint32)
    bind = rng.integers(0, 2 ** 32, (n, 8), np.uint32)
    j_div_bank = np.stack([np.asarray(j_div_lanes(j_bank.round_keys[r], s))
                           for r in range(k)])
    div_bank = fused_ops._div_bank(bank.round_keys, s)
    assert (_np(div_bank) == j_div_bank).all()
    key_bank = bank.hash_key[:, : 4 * s + 8].contiguous()
    j_key_per = np.asarray(j_bank.hash_key)[:, : 4 * s + 8][rows]
    port_args = (_u32(data), _u32(base), div_bank, _u32(bind), key_bank,
                 torch.from_numpy(rows))
    j_args = tuple(map(jnp.asarray, (data, base, j_div_bank[rows], bind,
                                     j_key_per)))
    for j_kernel, port, port_ref in (
            (j_fused.fused_crypt_mac_mixed, fused.fused_crypt_mac_mixed,
             fused_ref.fused_crypt_mac_mixed_ref),
            (j_fused.fused_crypt_mac_write_mixed,
             fused.fused_crypt_mac_write_mixed,
             fused_ref.fused_crypt_mac_write_mixed_ref)):
        want_out, want_nh = map(np.asarray, j_kernel(*j_args))
        for fn in (port, port_ref):
            out, nh = fn(*port_args)
            assert (_np(out) == want_out).all()
            assert (_np(nh) == want_nh).all()


@pytest.mark.parametrize("n,s", [(1, 11), (37, 4), (300, 1)])
@pytest.mark.parametrize("write", [False, True])
def test_secure_crossing_mixed_matches_jax_ops(banks, n, s, write):
    j_bank, bank = banks
    rng = np.random.default_rng(7 * n + s + write)
    bb = 16 * s
    rows = _rows(rng, n, bank.key.shape[0], mixed=n > 1)
    data = rng.integers(0, 256, n * bb, np.uint8)
    words = rng.integers(0, 2 ** 32, (n, 4), np.uint32)
    fields = [rng.integers(0, 2 ** 32, n, np.uint32) for _ in range(5)]
    jb = j_mac.Binding.make(*map(jnp.asarray, fields))
    tb = mac.Binding.make(*(torch.from_numpy(f.astype(np.int64))
                            for f in fields))
    j_fn = (j_fused_ops.secure_write_kernel_mixed if write
            else j_fused_ops.secure_read_kernel_mixed)
    fn = (fused_ops.secure_write_kernel_mixed if write
          else fused_ops.secure_read_kernel_mixed)
    want_out, want_macs = j_fn(jnp.asarray(data), jb, j_bank.round_keys,
                               jnp.asarray(words), j_bank.hash_key,
                               jnp.asarray(rows), block_bytes=bb)
    out, macs = fn(torch.from_numpy(data), tb, bank.round_keys,
                   _u32(words).to(torch.int64), bank.hash_key,
                   torch.from_numpy(rows), block_bytes=bb)
    assert (out.numpy() == np.asarray(want_out)).all()
    assert (macs.numpy() == np.asarray(want_macs)).all()
    # The MACs are the core engine's, block by block under each row.
    ct = out if write else torch.from_numpy(data)
    for i in (0, n - 1):
        one = mac.block_macs(
            ct.reshape(n, bb)[i: i + 1],
            mac.Binding(*(f[i: i + 1] for f in tb)),
            hash_key_u32=bank.hash_key[int(rows[i])],
            round_keys=bank.round_keys[int(rows[i])])
        assert (one.numpy() == macs[i: i + 1].numpy()).all()


def test_mixed_crossing_refuses_wide_blocks(banks):
    _, bank = banks
    tb = mac.Binding.make(*(torch.zeros(1, dtype=torch.int64),) * 5)
    with pytest.raises(ValueError, match="narrow"):
        fused_ops.secure_write_kernel_mixed(
            torch.zeros(512, dtype=torch.uint8), tb, bank.round_keys,
            torch.zeros((1, 4), dtype=torch.int64), bank.hash_key,
            torch.zeros(1, dtype=torch.int32), block_bytes=512)


def test_mixed_shared_memory_budget():
    # K = 12 (4 tenants at retain 2) at seda's S = 4: a few KB.
    assert fused.mixed_shared_bytes(12, 4) == 12 * (64 + 96)
    assert fused.mixed_shared_bytes(2000, 4) > 232448
