"""The port's CUDA kernels against their plain versions, on the card.

Rows of the mixed-key kernels are drawn over a (K, ...) key bank at
edge sizes; a bank too large for a thread block's shared memory and bad
operands must raise.  The weights boundary (``protect`` / ``unprotect``
and checkpoints) on the card gives the CPU's bytes, and its narrow
B-AES and NH MACs go through the kernels.

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
from repro_torch.kernels.otp_xor import kernel as ox_k
from repro_torch.kernels.otp_xor import ops as ox_ops
from repro_torch.kernels.otp_xor import ref as ox_ref
from repro_torch.kernels.xormac import kernel as xm_k
from repro_torch.kernels.xormac import ops as xm_ops
from repro_torch.kernels.xormac import ref as xm_ref
from repro_torch.tenancy import KeyHierarchy, TenantRegistry

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



# Sizes at the edges of the persistent grid's stride: "grid" is the
# launch's thread blocks x 256 threads on this card.
EDGE_SIZES = [1, 255, 256, 257, "grid-1", "grid", "grid+1", 655360]


def _edge_n(size, k=None) -> int:
    if isinstance(size, int):
        return size
    return aes_k.grid_blocks(k) * 256 + {"grid-1": -1, "grid": 0,
                                         "grid+1": 1}[size]


@pytest.mark.parametrize("size", EDGE_SIZES)
@pytest.mark.parametrize("multi", [False, True])
def test_keystream_at_grid_stride_edges(card, size, multi):
    rng = np.random.default_rng(31)
    if multi:
        _, round_keys, _, _ = _bank(card, 12)
        n = _edge_n(size, 12)
        words = _u32(rng, (n, 4), card)
        rows = _rows(rng, n, 12, card, mixed=True)
        got = aes_k.aes_ctr_keystream_multi(words, round_keys, rows)
        want = aes_ref.aes_ctr_keystream_multi_lanes_ref(words, round_keys,
                                                         rows)
    else:
        keys = SecureKeys.derive(31, device=card)
        n = _edge_n(size)
        words = _u32(rng, (n, 4), card)
        got = aes_k.aes_ctr_keystream(words, keys.round_keys)
        want = aes_ref.aes_ctr_keystream_lanes_ref(words, keys.round_keys)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


FIPS_C1_WORDS = [0x00112233, 0x44556677, 0x8899AABB, 0xCCDDEEFF]
FIPS_C1_OUT = "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("where", ["one_key", "k1", "row7_of_12"])
def test_keystream_fips197_c1(card, where):
    """FIPS-197 C.1 (key 00..0f, plaintext 00112233..ff) through the
    single-key kernel, and through the mixed one with the key alone in a
    one-row bank or in row 7 of a 12-row bank."""
    from repro_torch.core.aes import key_expansion_np
    rk = torch.from_numpy(key_expansion_np(np.arange(16))).to(card)
    words = torch.from_numpy(
        np.array([FIPS_C1_WORDS], np.uint32).view(np.int32)).to(card)
    if where == "one_key":
        got = aes_k.aes_ctr_keystream(words, rk)
    else:
        k, row = (1, 0) if where == "k1" else (12, 7)
        bank = torch.from_numpy(np.random.default_rng(32).integers(
            0, 256, (k, 11, 16), dtype=np.uint8)).to(card)
        bank[row] = rk
        got = aes_k.aes_ctr_keystream_multi(
            words, bank, torch.full((1,), row, dtype=torch.int32,
                                    device=card))
    torch.cuda.synchronize()
    assert got.cpu().numpy().tobytes().hex() == FIPS_C1_OUT


@pytest.mark.parametrize("rows_kind", ["page_uniform", "per_lane_random"])
def test_keystream_multi_row_patterns(card, rows_kind):
    """Rows as the serving path builds them (one row per 8,192-block
    page) and rows drawn per block, so every warp mixes rows."""
    _, round_keys, _, _ = _bank(card, 12)
    rng = np.random.default_rng(33)
    n = 655360
    if rows_kind == "page_uniform":
        rows_np = np.repeat(rng.integers(0, 12, n // 8192), 8192)
    else:
        rows_np = rng.integers(0, 12, n)
    rows = torch.from_numpy(rows_np.astype(np.int32)).to(card)
    words = _u32(rng, (n, 4), card)
    got = aes_k.aes_ctr_keystream_multi(words, round_keys, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, aes_ref.aes_ctr_keystream_multi_lanes_ref(
        words, round_keys, rows))


def test_keystream_multi_bank_at_the_shared_memory_limit(card):
    k = aes_k.MAX_BANK_ROWS
    assert (aes_k.TABLE_SHARED_BYTES + 176 * k <= 232448
            < aes_k.TABLE_SHARED_BYTES + 176 * (k + 1))
    rng = np.random.default_rng(34)
    n = 4099
    bank = torch.from_numpy(
        rng.integers(0, 256, (k, 11, 16), dtype=np.uint8)).to(card)
    rows = _rows(rng, n, k, card, mixed=True)
    words = _u32(rng, (n, 4), card)
    got = aes_k.aes_ctr_keystream_multi(words, bank, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, aes_ref.aes_ctr_keystream_multi_lanes_ref(
        words, bank, rows))
    over = torch.zeros((k + 1, 11, 16), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match=f"at most {k} rows"):
        aes_k.aes_ctr_keystream_multi(words, over, rows)

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


def _bank(card, k: int):
    """A (K, ...) key bank: the rows of a registry with K rows (K = 1:
    one tenant at retain 1 is not allowed, so take row 0 of a larger
    one)."""
    reg = TenantRegistry(KeyHierarchy(11, device=card), max_tenants=4)
    for t in range(4):
        reg.register(f"t{t}")
    reg.rotate("t1")
    bank = reg.bank
    if k == 1:
        return tuple(t[:1].contiguous() for t in bank)
    assert bank.key.shape[0] == k
    return tuple(bank)


def _rows(rng, n, k, card, mixed: bool) -> torch.Tensor:
    rows = (rng.integers(0, k, n) if mixed else np.full(n, k - 1))
    return torch.from_numpy(rows.astype(np.int32)).to(card)


@pytest.mark.parametrize("n", [1, 257, 4099])
@pytest.mark.parametrize("k", [1, 12])
def test_keystream_multi_equals_plain(card, n, k):
    _, round_keys, _, _ = _bank(card, k)
    rng = np.random.default_rng(n + k)
    words = _u32(rng, (n, 4), card)
    rows = _rows(rng, n, k, card, mixed=True)
    reset_launches()
    got = aes_k.aes_ctr_keystream_multi(words, round_keys, rows)
    torch.cuda.synchronize()
    assert LAUNCHES["aes_ctr_keystream_multi"] == 1
    assert torch.equal(got, aes_ref.aes_ctr_keystream_multi_lanes_ref(
        words, round_keys, rows))


@pytest.mark.parametrize("n", [1, 257, 4099])
@pytest.mark.parametrize("s", [1, 4, 11])
@pytest.mark.parametrize("k", [1, 12])
@pytest.mark.parametrize("write", [False, True])
def test_fused_mixed_equals_plain(card, n, s, k, write):
    _, round_keys, hash_key, _ = _bank(card, k)
    rng = np.random.default_rng(n * s + k)
    args = (_u32(rng, (n, 4 * s), card), _u32(rng, (n, 4), card),
            fused_ops._div_bank(round_keys, s), _u32(rng, (n, 8), card),
            hash_key[:, : 4 * s + 8].contiguous(),
            _rows(rng, n, k, card, mixed=n > 1))
    kernel = (fused.fused_crypt_mac_write_mixed if write
              else fused.fused_crypt_mac_mixed)
    ref = (fused_ref.fused_crypt_mac_write_mixed_ref if write
           else fused_ref.fused_crypt_mac_mixed_ref)
    out, nh = kernel(*args)
    torch.cuda.synchronize()
    ref_out, ref_nh = ref(*args)
    assert torch.equal(out, ref_out) and torch.equal(nh, ref_nh)


@pytest.mark.parametrize("write", [False, True])
def test_large_bank_above_48kb_equals_plain(card, write):
    """400 rows need more than the 48 KB of default shared memory: the
    C entry points opt in to the larger dynamic size."""
    n, s, k = 4099, 4, 400
    rng = np.random.default_rng(40 + write)
    round_keys = torch.from_numpy(
        rng.integers(0, 256, (k, 11, 16), dtype=np.uint8)).to(card)
    hash_key = _u32(rng, (k, 4 * s + 8), card)
    rows = _rows(rng, n, k, card, mixed=True)
    words = _u32(rng, (n, 4), card)
    got = aes_k.aes_ctr_keystream_multi(words, round_keys, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, aes_ref.aes_ctr_keystream_multi_lanes_ref(
        words, round_keys, rows))
    args = (_u32(rng, (n, 4 * s), card), _u32(rng, (n, 4), card),
            fused_ops._div_bank(round_keys, s), _u32(rng, (n, 8), card),
            hash_key, rows)
    kernel = (fused.fused_crypt_mac_write_mixed if write
              else fused.fused_crypt_mac_mixed)
    ref = (fused_ref.fused_crypt_mac_write_mixed_ref if write
           else fused_ref.fused_crypt_mac_mixed_ref)
    out, nh = kernel(*args)
    torch.cuda.synchronize()
    ref_out, ref_nh = ref(*args)
    assert torch.equal(out, ref_out) and torch.equal(nh, ref_nh)


@pytest.mark.parametrize("write", [False, True])
def test_secure_crossing_mixed_kernel_equals_cpu(card, write):
    rng = np.random.default_rng(8)
    n = 300
    data = rng.integers(0, 256, n * 64, dtype=np.uint8)
    words = rng.integers(0, 2 ** 32, (n, 4)).astype(np.int64)
    fields = [rng.integers(0, 2 ** 32, n).astype(np.int64) for _ in range(5)]
    rows = rng.integers(0, 12, n).astype(np.int32)
    fn = (fused_ops.secure_write_kernel_mixed if write
          else fused_ops.secure_read_kernel_mixed)
    outs = []
    for dev in ("cpu", card):
        _, round_keys, hash_key, _ = _bank(dev, 12)
        binding = mac.Binding.make(*(torch.from_numpy(f).to(dev)
                                     for f in fields))
        outs.append(fn(torch.from_numpy(data).to(dev), binding, round_keys,
                       torch.from_numpy(words).to(dev), hash_key,
                       torch.from_numpy(rows).to(dev), block_bytes=64))
    assert torch.equal(outs[0][0], outs[1][0].cpu())
    assert torch.equal(outs[0][1], outs[1][1].cpu())


def test_mixed_kernels_refuse_large_bank_and_bad_operands(card):
    n, s, k = 64, 4, 2000            # 2000 rows: > 227 KB of shared memory
    rng = np.random.default_rng(9)
    words = _u32(rng, (n, 4), card)
    rows = torch.zeros((n,), dtype=torch.int32, device=card)
    big_rk = torch.zeros((k, 11, 16), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        aes_k.aes_ctr_keystream_multi(words, big_rk, rows)
    args = [_u32(rng, (n, 4 * s), card), _u32(rng, (n, 4), card),
            torch.zeros((k, s, 4), dtype=torch.int32, device=card),
            _u32(rng, (n, 8), card),
            torch.zeros((k, 4 * s + 8), dtype=torch.int32, device=card), rows]
    with pytest.raises(ValueError, match="shared memory"):
        fused.fused_crypt_mac_mixed(*args)
    _, round_keys, hash_key, _ = _bank(card, 12)
    args[2] = fused_ops._div_bank(round_keys, s)
    args[4] = hash_key[:, : 4 * s + 8].contiguous()
    with pytest.raises(TypeError):                   # int64 rows
        fused.fused_crypt_mac_write_mixed(*args[:5], rows.long())
    with pytest.raises(ValueError):                  # one row short
        fused.fused_crypt_mac_mixed(*args[:5], rows[:-1])
    with pytest.raises(ValueError):                  # key rows of another S
        fused.fused_crypt_mac_mixed(*args[:4], hash_key[:, :20].contiguous(),
                                    rows)
    with pytest.raises(ValueError):                  # rows on the CPU
        aes_k.aes_ctr_keystream_multi(words, round_keys, rows.cpu())
    with pytest.raises(ValueError):                  # non-contiguous counters
        aes_k.aes_ctr_keystream_multi(
            _u32(rng, (n, 8), card)[:, ::2], round_keys, rows)


@pytest.mark.parametrize("n", [1, 7, 655360])
@pytest.mark.parametrize("s", [1, 4, 11])
def test_otp_xor_equals_plain(card, n, s):
    rng = np.random.default_rng(n + s)
    args = (_u32(rng, (n, 4 * s), card), _u32(rng, (n, 4), card),
            _u32(rng, (s, 4), card))
    reset_launches()
    got = ox_k.otp_xor(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["otp_xor"] == 1
    assert torch.equal(got, ox_ref.otp_xor_ref(*args))


@pytest.mark.parametrize("n", [1, 7, 655360])
@pytest.mark.parametrize("lanes", [6, 24, 136])
def test_nh_hash_equals_plain(card, n, lanes):
    rng = np.random.default_rng(n * lanes)
    payload, key = _u32(rng, (n, lanes), card), _u32(rng, (lanes,), card)
    reset_launches()
    got = xm_k.nh_hash_kernel_call(payload, key)
    torch.cuda.synchronize()
    assert LAUNCHES["nh_hash_kernel_call"] == 1
    assert torch.equal(got, xm_ref.nh_hash_ref(payload, key))


def test_nh_hash_rows_longer_than_a_key_chunk(card):
    """Rows over 4096 lanes loop over key chunks in shared memory."""
    rng = np.random.default_rng(12)
    for lanes in (8200, 8198):
        payload, key = _u32(rng, (37, lanes), card), _u32(rng, (lanes,), card)
        got = xm_k.nh_hash_kernel_call(payload, key)
        torch.cuda.synchronize()
        assert torch.equal(got, xm_ref.nh_hash_ref(payload, key))


@pytest.mark.parametrize("block_bytes", [16, 64, 176])
def test_baes_and_block_macs_kernel_equal_cpu(card, block_bytes):
    rng = np.random.default_rng(block_bytes)
    n = 4099
    data = rng.integers(0, 256, n * block_bytes, dtype=np.uint8)
    words = rng.integers(0, 2 ** 32, (n, 4)).astype(np.int64)
    fields = [rng.integers(0, 2 ** 32, n).astype(np.int64) for _ in range(5)]
    outs = []
    for dev in ("cpu", card):
        keys = SecureKeys.derive(13, device=dev)
        binding = mac.Binding.make(*(torch.from_numpy(f).to(dev)
                                     for f in fields))
        ct = ox_ops.baes_encrypt_kernel(torch.from_numpy(data).to(dev),
                                        keys.round_keys,
                                        torch.from_numpy(words).to(dev),
                                        block_bytes=block_bytes)
        macs = xm_ops.block_macs_kernel(ct.reshape(n, block_bytes), binding,
                                        hash_key_u32=keys.hash_key,
                                        round_keys=keys.round_keys)
        outs.append((ct.cpu(), macs.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_new_kernels_refuse_bad_operands(card):
    rng = np.random.default_rng(14)
    data, base = _u32(rng, (8, 16), card), _u32(rng, (8, 4), card)
    div = _u32(rng, (4, 4), card)
    with pytest.raises(TypeError):
        ox_k.otp_xor(data.long(), base, div)
    with pytest.raises(ValueError):                  # lanes != 4 S
        ox_k.otp_xor(data, base, _u32(rng, (3, 4), card))
    with pytest.raises(ValueError):                  # base rows short
        ox_k.otp_xor(data, base[:-1].contiguous(), div)
    with pytest.raises(ValueError):                  # mixed devices
        ox_k.otp_xor(data, base.cpu(), div)
    payload = _u32(rng, (8, 24), card)
    with pytest.raises(ValueError):                  # key of another L
        xm_k.nh_hash_kernel_call(payload, _u32(rng, (26,), card))
    with pytest.raises(ValueError):                  # non-contiguous
        xm_k.nh_hash_kernel_call(_u32(rng, (8, 48), card)[:, ::2],
                                 _u32(rng, (24,), card))


def _weights_tree(device) -> dict:
    rng = np.random.default_rng(15)
    return {
        "w": torch.from_numpy(rng.standard_normal((64, 48)).astype(
            np.float32)).to(device).to(torch.bfloat16),
        "layers": [{"b": torch.from_numpy(rng.standard_normal(37).astype(
            np.float32)).to(device)},
            {"odd": torch.from_numpy(rng.integers(0, 256, 13).astype(
                np.uint8)).to(device)}],
    }


@pytest.mark.parametrize("scheme", ["seda", "seda512", "sgx64", "mgx512"])
def test_protect_on_the_card_equals_cpu(card, scheme):
    from repro_torch.core.layout import tree_flatten
    from repro_torch.core.secure_exec import SCHEMES, SecureExecutor
    states = []
    for dev in ("cpu", card):
        ex = SecureExecutor(scheme, keys=SecureKeys.derive(16, device=dev))
        tree = _weights_tree(dev)
        spec = ex.region_spec(tree)
        reset_launches()
        state = ex.protect(tree, spec, step=5)
        launches = dict(LAUNCHES)
        out, ok = ex.unprotect(state, spec)
        assert bool(ok)
        for a, b in zip(tree_flatten(out)[0], tree_flatten(tree)[0]):
            assert torch.equal(a, b)
        states.append((state, launches))
    (cpu, cpu_launches), (gpu, gpu_launches) = states
    for a, b in zip(cpu.ciphertexts, gpu.ciphertexts):
        assert torch.equal(a, b.cpu())
    assert torch.equal(cpu.layer_macs, gpu.layer_macs.cpu())
    assert torch.equal(cpu.model_mac, gpu.model_mac.cpu())
    assert cpu.vn_lo == gpu.vn_lo
    assert all(v == 0 for v in cpu_launches.values())
    cfg, n_leaves = SCHEMES[scheme], 3
    narrow = cfg.baes and cfg.block_bytes <= 176
    assert gpu_launches["nh_hash_kernel_call"] == n_leaves
    assert gpu_launches["otp_xor"] == (n_leaves if narrow else 0)
    assert gpu_launches["aes_ctr_keystream"] == n_leaves * (1 + narrow)


def test_checkpoint_saved_on_the_card_loads_on_cpu(card, tmp_path):
    from repro_torch.checkpoint.secure_ckpt import (CheckpointError,
                                                    load_checkpoint,
                                                    save_checkpoint)
    tree = _weights_tree(card)
    path = save_checkpoint(str(tmp_path), 1, tree,
                           SecureKeys.derive(17, device=card),
                           block_bytes=64)
    out, _ = load_checkpoint(path, tree, SecureKeys.derive(17, device="cpu"),
                             device="cpu")
    assert torch.equal(out["w"], tree["w"].cpu())
    out, _ = load_checkpoint(path, tree, SecureKeys.derive(17, device=card))
    assert out["w"].device.type == "cuda" and torch.equal(out["w"], tree["w"])
    with pytest.raises(CheckpointError):
        load_checkpoint(path, tree, SecureKeys.derive(18, device=card))
