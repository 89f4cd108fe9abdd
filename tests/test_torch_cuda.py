"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU (marked ``cuda``; skipped without one).  Imports
only ``repro_torch``, so it runs where JAX is not installed::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mac
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.aes_ctr import kernel as aes_k
from repro_torch.kernels.aes_ctr import ref as aes_ref
from repro_torch.kernels.fused_crypt_mac import kernel as fused
from repro_torch.kernels.fused_crypt_mac import ops as fused_ops
from repro_torch.kernels.fused_crypt_mac import ref as fused_ref

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def _u32(rng, shape, device) -> torch.Tensor:
    a = rng.integers(0, 2 ** 32, shape, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


@pytest.mark.parametrize("n", [1, 257, 4099])
def test_keystream_equals_plain(card, n):
    keys = SecureKeys.derive(3, device=card)
    words = _u32(np.random.default_rng(n), (n, 4), card)
    reset_launches()
    got = aes_k.aes_ctr_keystream(words, keys.round_keys)
    torch.cuda.synchronize()
    assert LAUNCHES["aes_ctr_keystream"] == 1
    assert torch.equal(got, aes_ref.aes_ctr_keystream_lanes_ref(
        words, keys.round_keys))


@pytest.mark.parametrize("s", [1, 4, 11])
@pytest.mark.parametrize("write", [False, True])
def test_fused_equals_plain(card, s, write):
    keys = SecureKeys.derive(4, device=card)
    rng = np.random.default_rng(s)
    n = 1000
    args = (_u32(rng, (n, 4 * s), card), _u32(rng, (n, 4), card),
            fused_ops._div_lanes(keys.round_keys, s), _u32(rng, (n, 8), card),
            keys.hash_key[: 4 * s + 8].contiguous())
    kernel = fused.fused_crypt_mac_write if write else fused.fused_crypt_mac
    ref = (fused_ref.fused_crypt_mac_write_ref if write
           else fused_ref.fused_crypt_mac_ref)
    out, nh = kernel(*args)
    torch.cuda.synchronize()
    ref_out, ref_nh = ref(*args)
    assert torch.equal(out, ref_out) and torch.equal(nh, ref_nh)


@pytest.mark.parametrize("write", [False, True])
def test_secure_crossing_kernel_equals_cpu(card, write):
    rng = np.random.default_rng(5)
    n = 300
    data = rng.integers(0, 256, n * 64, dtype=np.uint8)
    words = rng.integers(0, 2 ** 32, (n, 4)).astype(np.int64)
    fields = [rng.integers(0, 2 ** 32, n).astype(np.int64) for _ in range(5)]
    fn = fused_ops.secure_write_kernel if write else fused_ops.secure_read_kernel
    outs = []
    for dev in ("cpu", card):
        keys = SecureKeys.derive(6, device=dev)
        binding = mac.Binding.make(*(torch.from_numpy(f).to(dev)
                                     for f in fields))
        outs.append(fn(torch.from_numpy(data).to(dev), binding,
                       keys.round_keys, torch.from_numpy(words).to(dev),
                       keys.hash_key, block_bytes=64))
    assert torch.equal(outs[0][0], outs[1][0].cpu())
    assert torch.equal(outs[0][1], outs[1][1].cpu())


def test_kernel_refuses_bad_operands(card):
    keys = SecureKeys.derive(7, device=card)
    words = torch.zeros((8, 4), dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        aes_k.aes_ctr_keystream(words, keys.round_keys)
    lanes = torch.zeros((8, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        aes_k.aes_ctr_keystream(lanes[:, ::2], keys.round_keys)
