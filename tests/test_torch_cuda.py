"""The port's CUDA kernels against their plain versions, on the card.

Rows of the mixed-key kernels are drawn over a (K, ...) key bank at
edge sizes; a bank too large for a thread block's shared memory and bad
operands must raise.  The weights boundary (``protect`` / ``unprotect``
and checkpoints) on the card gives the CPU's bytes, and its narrow
B-AES and NH MACs go through the kernels.  A prefix-cache run (hits,
copy-on-write, reseal-on-share) gives the CPU's tokens and counters and
goes through the mixed-key kernels.  A fault-tolerant run that contains
a bitflip (and, with tenants, a corrupted page MAC) gives the CPU's
tokens, quarantined frames and containment counters, its probes on the
single-key or the mixed-key kernels.  A two-shard cluster on the card
gives the CPU's tokens and counters, its pools byte-equal with the
kernels on and off; with one shard on the card and one on the CPU, the
migration's plaintext hops between the devices.  Each attention-family
smoke config (granite, olmoe, deepseek, minitron-8b) served on the card
with the kernels gives the plain and the CPU tokens, its pools
byte-equal with the kernels on and off; a flipped byte of a deepseek
latent page (c_kv or k_pe) raises.  The chunked SSD scan on the card
equals the sequential recurrence, and jamba's smoke config (attention
pages beside its Mamba state) gives the CPU's tokens, its writes on the
fused kernel.  One seda train step of seamless's smoke config on the
card gives the CPU's loss and params, its crossings on B1, B7 and B8.
Each wrapper charges an active cost profile its launch's operand and
output bytes and its operation count; a seda engine profiled between
ticks on the card keeps its tokens and pools.  The engine's CUDA graphs
of its model steps (one per decode bucket, one per padded prefill
length) give the eager steps' logits, tokens and cache leaves bit for
bit, for each attention, MoE, MLA and Mamba smoke config; a 4-tenant
engine that rotates keys replays them on every tick after the first,
with the CPU's tokens and the eager card run's pool bytes.

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


def _prefix_run(device, params):
    """Hit / miss / copy-on-write traffic over 2 tenants, then a
    reseal-on-share and a hit through it (the smoke config)."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import SecureServingEngine
    arch = get_arch("minitron-4b")
    reg = TenantRegistry(KeyHierarchy(0, device=device), max_tenants=2)
    reg.register("a")
    reg.register("b")
    sa, sb = reg.open_session("a"), reg.open_session("b")
    eng = SecureServingEngine(arch, arch.make_smoke_config(), params,
                              scheme="seda", use_kernel=True, registry=reg,
                              prefix_cache=True, max_slots=2, page_tokens=4,
                              pages_per_slot=4, n_pages=16, device=device)
    rng = np.random.default_rng(3)
    p7 = list(map(int, rng.integers(1, 256, 7)))
    prompts = [p7, p7, p7 + [9], list(map(int, rng.integers(1, 256, 9)))]
    reset_launches()
    rids = [eng.submit(prompt=p, max_new_tokens=4, session=sa)
            for p in prompts]
    eng.run()
    shared = eng.share_prefix(p7, from_session=sa, to_session=sb)
    rids.append(eng.submit(prompt=p7 + [9], max_new_tokens=4, session=sb))
    eng.run()
    return ([eng.requests[r].generated for r in rids], dict(eng.stats),
            shared, dict(LAUNCHES))


def test_prefix_cache_on_the_card_equals_cpu(card):
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    from repro_torch.serve.engine import STAT_NAMES
    cfg = get_arch("minitron-4b").make_smoke_config()
    params = init_params(lm.lm_specs(cfg), 0, device="cpu")
    cpu = _prefix_run("cpu", params)
    gpu = _prefix_run(card, params)
    assert gpu[0] == cpu[0] and gpu[2] == cpu[2]
    assert {k: gpu[1][k] for k in STAT_NAMES} == \
        {k: cpu[1][k] for k in STAT_NAMES}
    assert gpu[1]["decode_graph_replays"] == gpu[1]["decode_steps"] > 0
    stats = gpu[1]
    assert stats["prefix_hit_pages"] > 0 and stats["prefix_cow_pages"] > 0
    assert stats["prefix_inserted_pages"] > 0 and gpu[2] > 0
    assert all(v == 0 for v in cpu[3].values())
    for name in ("aes_ctr_keystream_multi", "fused_crypt_mac_mixed",
                 "fused_crypt_mac_write_mixed"):
        assert gpu[3][name] > 0, name


def _contained_run(device, params, tenants: int):
    """A bitflip (and, with tenants, a corrupted page MAC) contained by
    the fault-tolerant engine on the smoke config."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import SecureServingEngine
    from repro_torch.serve.faults import Fault, FaultPlan
    arch = get_arch("minitron-4b")
    kw, sessions = {}, [None]
    if tenants:
        reg = TenantRegistry(KeyHierarchy(4, device=device),
                             max_tenants=tenants)
        for t in range(tenants):
            reg.register(f"t{t}")
        sessions = [reg.open_session(f"t{t}") for t in range(tenants)]
        kw = dict(registry=reg, rotate_every=1)
    eng = SecureServingEngine(arch, arch.make_smoke_config(), params,
                              scheme="seda", use_kernel=True, max_slots=2,
                              page_tokens=4, pages_per_slot=4, n_pages=12,
                              fault_tolerance=True, audit=True,
                              device=device, **kw)
    faults = [Fault(tick=3, kind="bitflip", slot=tenants and 1)]
    if tenants:
        faults.append(Fault(tick=2, kind="mac_corrupt", slot=0))
    plan = FaultPlan(faults).attach(eng)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 256, n))) for n in (6, 5)]
    rids = [eng.submit(prompt=p, max_new_tokens=4,
                       session=sessions[i % len(sessions)])
            for i, p in enumerate(prompts)]
    reset_launches()
    eng.run()
    counters = {k: eng.stats[k] for k in (
        "integrity_verdicts", "integrity_failures",
        "integrity_quarantined_pages", "sessions_recovered",
        "sessions_lost", "audit_events", "preemptions")}
    return ([eng.requests[r].generated for r in rids], sorted(eng.quarantined),
            counters, len(plan.fired), eng.audit.verify_chain(),
            dict(LAUNCHES))


@pytest.mark.parametrize("tenants", [0, 2])
def test_containment_on_the_card_equals_cpu(card, tenants):
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    cfg = get_arch("minitron-4b").make_smoke_config()
    params = init_params(lm.lm_specs(cfg), 0, device="cpu")
    cpu = _contained_run("cpu", params, tenants)
    gpu = _contained_run(card, params, tenants)
    assert gpu[:5] == cpu[:5]
    assert gpu[1] and gpu[2]["sessions_lost"] == 0 and gpu[4]
    assert gpu[3] == (2 if tenants else 1)
    assert all(v == 0 for v in cpu[5].values())
    route = (("aes_ctr_keystream_multi", "fused_crypt_mac_mixed")
             if tenants else ("aes_ctr_keystream", "fused_crypt_mac"))
    for name in route:
        assert gpu[5][name] > 0, name


def _cluster_run(devices, params, use_kernel: bool):
    """The smoke cluster (2 seda shards) on the migration scenario: two
    long decodes on shard 0, a short one on shard 1, then a migration."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.cluster import ClusterEngine
    arch = get_arch("minitron-4b")
    cl = ClusterEngine(arch, arch.make_smoke_config(), params, shards=2,
                       scheme="seda", use_kernel=use_kernel, max_slots=2,
                       page_tokens=4, pages_per_slot=8, n_pages=8,
                       devices=devices)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 256, n))) for n in (5, 7, 9)]
    rids = [cl.submit(prompt=p, max_new_tokens=n)
            for p, n in zip(prompts, (20, 2, 20))]
    reset_launches()
    cl.run()
    return cl, [cl.requests[r].generated for r in rids], dict(LAUNCHES)


def _smoke_params():
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    cfg = get_arch("minitron-4b").make_smoke_config()
    return init_params(lm.lm_specs(cfg), 0, device="cpu")


def test_cluster_on_the_card_equals_cpu_and_plain(card):
    """Two logical shards on the card: the tokens and counters of the
    CPU's run; both shards' pools byte-equal with the kernels on and
    off; B1-B3 launched, migration included."""
    params = _smoke_params()
    cpu, cpu_tokens, _ = _cluster_run(["cpu", "cpu"], params, True)
    runs = [_cluster_run([card, card], params, uk) for uk in (True, False)]
    (kern, tokens, launches), (plain, plain_tokens, plain_launches) = runs
    assert tokens == plain_tokens == cpu_tokens
    assert dict(kern.stats) == dict(cpu.stats)
    assert kern.stats["migrations"] > 0 and kern.deferred_check()
    for a, b in zip(kern.engines, plain.engines):
        for x, y in zip(a.pool.cts, b.pool.cts):
            assert torch.equal(x, y)
        for name in ("page_macs", "page_vns", "pool_mac"):
            assert torch.equal(getattr(a.pool, name), getattr(b.pool, name))
    for name in ("aes_ctr_keystream", "fused_crypt_mac",
                 "fused_crypt_mac_write"):
        assert launches[name] > 0 and plain_launches[name] == 0, name


def test_cluster_across_card_and_cpu_equals_cpu(card):
    """Shard 0 on the card, shard 1 on the CPU: the migration's
    plaintext hops between the two devices, and the tokens, counters and
    root check are the all-CPU run's."""
    params = _smoke_params()
    cpu, cpu_tokens, _ = _cluster_run(["cpu", "cpu"], params, True)
    mixed, tokens, _ = _cluster_run([card, "cpu"], params, True)
    assert tokens == cpu_tokens
    assert dict(mixed.stats) == dict(cpu.stats)
    assert mixed.stats["migrations"] > 0
    assert [e.device.type for e in mixed.engines] == ["cuda", "cpu"]
    assert mixed.deferred_check()


def test_migrate_refuses_pools_on_two_devices(card):
    """``PageIO.migrate`` is the one-device form: a pool on the card and
    one on the CPU are refused (the cluster moves pages across devices
    with read_raw, a plaintext hop and write)."""
    from repro_torch.models.attention import CacheSpec, KVCache
    from repro_torch.serve import kv_pages as kvp
    tree = [[KVCache(k=CacheSpec((2, 2, 16, 2, 8), "float32"),
                     v=CacheSpec((2, 2, 16, 2, 8), "float32"),
                     length=CacheSpec((2,), "int32"))]]
    spec = kvp.build_page_spec(tree, scheme="seda", page_tokens=4,
                               n_pages=6, max_slots=2, max_len=16)
    keys = SecureKeys.derive(5, device=card)
    with pytest.raises(ValueError, match="one device"):
        kvp.migrate_pages(kvp.init_pool(spec, card), spec,
                          kvp.init_pool(spec, "cpu"), spec, keys, [0], [1],
                          9)


# ---------------------------------------------------------------------------
# The attention-family archs (granite's GELU MLP and MQA, olmoe's MoE,
# deepseek's MLA latent pages) through the engine on the card.
# ---------------------------------------------------------------------------

NEW_ARCHS = ["minitron-8b", "granite-34b", "olmoe-1b-7b", "deepseek-v3-671b"]


def _arch_engine(name, device, params, use_kernel: bool):
    """The smoke config under seda, three prompts of 5, 7 and 6 tokens
    submitted (6 new tokens each)."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import SecureServingEngine
    arch = get_arch(name)
    eng = SecureServingEngine(arch, arch.make_smoke_config(), params,
                              scheme="seda", use_kernel=use_kernel,
                              max_slots=2, page_tokens=4, pages_per_slot=4,
                              device=device)
    rng = np.random.default_rng(8)
    rids = [eng.submit(prompt=list(map(int, rng.integers(1, 256, n))),
                       max_new_tokens=6) for n in (5, 7, 6)]
    return eng, rids


def _arch_run(name, device, params, use_kernel: bool):
    eng, rids = _arch_engine(name, device, params, use_kernel)
    reset_launches()
    done = eng.run()
    pool = [t.cpu() for t in (*eng.pool.cts, eng.pool.page_macs,
                              eng.pool.page_vns, eng.pool.pool_mac)]
    return ([done[r].generated for r in rids], pool, dict(LAUNCHES),
            eng.deferred_check())


def _arch_params(name):
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    cfg = get_arch(name).make_smoke_config()
    return init_params(lm.lm_specs(cfg), 0, device="cpu")


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_arch_on_the_card_kernels_equal_plain_and_cpu(card, name):
    params = _arch_params(name)
    cpu = _arch_run(name, "cpu", params, True)
    plain = _arch_run(name, card, params, False)
    kern = _arch_run(name, card, params, True)
    assert kern[0] == plain[0] == cpu[0]
    assert all(torch.equal(a, b) for a, b in zip(kern[1], plain[1]))
    assert kern[3] and plain[3]
    for k in ("aes_ctr_keystream", "fused_crypt_mac",
              "fused_crypt_mac_write"):
        assert kern[2][k] > 0 and plain[2][k] == 0, k


@pytest.mark.parametrize("leaf", [0, 1])
def test_deepseek_latent_page_tamper_raises_on_the_card(card, leaf):
    """A flipped byte of a live ``c_kv`` (leaf 0) or ``k_pe`` (leaf 1)
    page fails the next tick."""
    from repro_torch.serve.engine import IntegrityError
    eng, _ = _arch_engine("deepseek-v3-671b", card,
                          _arch_params("deepseek-v3-671b"), True)
    eng.step()
    eng.step()
    eng.pool.cts[leaf][eng.slots[0].pages[0], 5] ^= 0x20
    with pytest.raises(IntegrityError):
        eng.step()


# ---------------------------------------------------------------------------
# The Mamba-2 mixer and jamba's recurrent state on the card.
# ---------------------------------------------------------------------------


def test_ssd_chunked_on_the_card_equals_sequential(card):
    """L = 200 over chunks of 64 (padded to 256), 8 heads over 2 groups:
    the chunked scan equals the sequential recurrence within atol 1e-4
    (the reference's own oracle tolerance).  The check is the one the
    card smoke run makes (``chip_smoke._ssd_f32``)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke._ssd_f32()
    assert out["max_abs_err"] <= out["atol"] == 1e-4


def test_jamba_on_the_card_kernels_equal_plain_and_cpu(card):
    """jamba's smoke config (float32): the card's tokens, with the kernels
    and without, equal the CPU's; its pools are byte-equal with the
    kernels on and off, and its dirty writes go through the fused
    kernel."""
    name = "jamba-v0.1-52b"
    params = _arch_params(name)
    cpu = _arch_run(name, "cpu", params, True)
    plain = _arch_run(name, card, params, False)
    eng, rids = _arch_engine(name, card, params, True)
    reset_launches()
    done = eng.run()
    kern_tokens = [done[r].generated for r in rids]
    assert kern_tokens == plain[0] == cpu[0]
    pool = [t.cpu() for t in (*eng.pool.cts, eng.pool.page_macs,
                              eng.pool.page_vns, eng.pool.pool_mac)]
    assert all(torch.equal(a, b) for a, b in zip(pool, plain[1]))
    assert eng.stats["fused_write_ticks"] > 0 and eng.deferred_check()
    assert not eng.prefill_buckets and len(eng.onchip) == 14
    for k in ("aes_ctr_keystream", "fused_crypt_mac",
              "fused_crypt_mac_write"):
        assert LAUNCHES[k] > 0 and plain[2][k] == 0, k


# ---------------------------------------------------------------------------
# Secure training on the card.
# ---------------------------------------------------------------------------


def test_secure_train_step_on_the_card_equals_cpu(card):
    """One seda train step of seamless's smoke config (float32) on the
    card gives the CPU port's loss (rtol 1e-5) and, unprotected, its
    params (atol 1e-5: one AdamW step moves a param by at most lr x
    warmup, 3e-6, so a gradient sign that differs near zero costs at most
    twice that); the card's crossings run B1, B7 and B8, 4, 2 and 2 per
    leaf."""
    from repro_torch.core.layout import tree_flatten
    from repro_torch.core.secure_exec import SecureExecutor
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.train import build
    from repro_torch.models.layers import init_params, tree_map
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_secure_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, cfg, specs = build("seamless-m4t-large-v2", smoke=True)
    params = init_params(specs, 0, device="cpu")
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2,
                      kind="encdec", d_model=cfg.d_model, src_len=8)
    out = {}
    for dev in ("cpu", card):
        ex = SecureExecutor("seda", keys=SecureKeys.derive(0, device=dev))
        p = tree_map(lambda t: t.to(dev), params)
        region = ex.region_spec(p)
        step = make_secure_train_step(arch, cfg, AdamWConfig(), ex, region)
        state = ex.protect(p, region, step=0)
        reset_launches()
        state, _, metrics = step(state, init_opt_state(p, AdamWConfig()),
                                 make_batch(data, 0, device=dev), 0)
        launches = dict(LAUNCHES)
        new, ok = ex.unprotect(state, region)
        assert bool(metrics["integrity_ok"]) and bool(ok)
        out[str(dev)] = (float(metrics["loss"]), tree_flatten(new)[0],
                         launches)
    (loss_c, leaves_c, _), (loss_g, leaves_g, launches) = out.values()
    n = len(leaves_c)
    assert launches == {**{k: 0 for k in LAUNCHES},
                        "aes_ctr_keystream": 4 * n, "otp_xor": 2 * n,
                        "nh_hash_kernel_call": 2 * n}
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-5)
    for a, b in zip(leaves_g, leaves_c, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5,
                                   rtol=0)


def _charges(fn) -> tuple:
    """``(fn(), {kernel: [bytes, ops, launches]})`` with a cost sink
    attached, as a profile attaches one."""
    from repro_torch import kernels
    got: dict = {}

    def sink(name, source, nbytes, ops):
        c = got.setdefault(name, [0.0, 0.0, 0])
        c[0] += nbytes
        c[1] += ops
        c[2] += 1

    kernels.COST_SINKS.append(sink)
    try:
        out = fn()
    finally:
        kernels.COST_SINKS.remove(sink)
    return out, got


def _nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def test_kernel_charges_are_operands_outputs_and_op_counts(card):
    """Each wrapper charges one launch its operands' and outputs' bytes
    (the 1 KB T-table among the AES operands) and the shared op counts;
    with no sink attached it charges nothing."""
    from repro_torch.kernels import common
    rng = np.random.default_rng(21)
    keys = SecureKeys.derive(21, device=card)
    _, bank_rk, bank_hk, _ = _bank(card, 12)
    n, s, lanes = 1000, 4, 24
    words, rows = _u32(rng, (n, 4), card), _rows(rng, n, 12, card, True)
    data, base, bind = (_u32(rng, (n, 4 * s), card), _u32(rng, (n, 4), card),
                        _u32(rng, (n, 8), card))
    div = fused_ops._div_lanes(keys.round_keys, s)
    key = keys.hash_key[: 4 * s + 8].contiguous()
    div_bank = fused_ops._div_bank(bank_rk, s)
    key_bank = bank_hk[:, : 4 * s + 8].contiguous()
    payload, nh_key = _u32(rng, (n, lanes), card), keys.hash_key[:lanes]
    table = 1024.0
    cases = {
        "aes_ctr_keystream": (
            lambda: aes_k.aes_ctr_keystream(words, keys.round_keys),
            _nbytes(words, keys.round_keys, words) + table,
            common.aes_ctr_ops(n)),
        "aes_ctr_keystream_multi": (
            lambda: aes_k.aes_ctr_keystream_multi(words, bank_rk, rows),
            _nbytes(words, bank_rk, rows, words) + table,
            common.aes_ctr_ops(n)),
        "fused_crypt_mac": (
            lambda: fused.fused_crypt_mac(data, base, div, bind, key),
            _nbytes(data, base, div, bind, key, data) + n * 8,
            common.fused_crypt_mac_ops(n, s)),
        "fused_crypt_mac_write_mixed": (
            lambda: fused.fused_crypt_mac_write_mixed(
                data, base, div_bank, bind, key_bank, rows),
            _nbytes(data, base, div_bank, bind, key_bank, rows, data)
            + n * 8, common.fused_crypt_mac_ops(n, s)),
        "otp_xor": (
            lambda: ox_k.otp_xor(data, base, div),
            _nbytes(data, base, div, data), common.otp_xor_ops(n, s)),
        "nh_hash_kernel_call": (
            lambda: xm_k.nh_hash_kernel_call(payload, nh_key),
            _nbytes(payload, nh_key) + n * 8,
            common.nh_hash_ops(n, lanes)),
    }
    for name, (call, nbytes, ops) in cases.items():
        _, got = _charges(call)
        assert got == {name: [nbytes, float(ops), 1]}, name
        reset_launches()
        call()
        assert LAUNCHES[name] == 1, name


def test_profiled_seda_tick_on_the_card_keeps_its_tokens(card):
    """A smoke engine on the card profiled between two ticks (kernels on)
    gives the unprofiled engine's tokens and pools; the profile charged
    B1-B3 and left the launch counts alone."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import SecureServingEngine
    params = _smoke_params()
    arch = get_arch("minitron-4b")
    cfg = arch.make_smoke_config()
    runs = []
    for profiled in (True, False):
        eng = SecureServingEngine(
            arch, cfg, params, scheme="seda", use_kernel=True, max_slots=2,
            page_tokens=4, pages_per_slot=4, device=card)
        rids = [eng.submit(prompt=p, max_new_tokens=6)
                for p in ([5, 9, 3, 7, 1], [2, 8, 6])]
        eng.step()
        eng.step()
        charged = {}
        if profiled:
            launches = dict(LAUNCHES)
            doc, charged = _charges(eng.profile)
            assert dict(LAUNCHES) == launches
            prof = doc["profiles"][0]
            assert prof["overhead_bytes_ratio"] > 0.01
            assert prof["coverage"]["bytes"] >= 0.95
        done = eng.run()
        # The profile's decodes ran eagerly and left the graphs on.
        assert not eng._graphs_off
        assert eng.stats["decode_graph_replays"] == \
            eng.stats["decode_steps"] > 2
        runs.append(([done[r].generated for r in rids], charged,
                     [t.cpu() for t in (*eng.pool.cts, eng.pool.page_macs,
                                        eng.pool.page_vns,
                                        eng.pool.pool_mac)]))
    (tokens, charged, pool), (want_tokens, _, want_pool) = runs
    assert tokens == want_tokens
    assert all(torch.equal(a, b) for a, b in zip(pool, want_pool))
    assert set(charged) == {"aes_ctr_keystream", "fused_crypt_mac",
                            "fused_crypt_mac_write"}


def _span_chain(events, e) -> list:
    by_id = {x["id"]: x for x in events}
    out = []
    while e.get("parent") is not None:
        e = by_id[e["parent"]]
        out.append(e["name"])
    return out


def test_program_spans_on_the_card_wrap_each_launch(card):
    """With the program's spans on, every launch of a hand-written kernel
    sits in one ``kernel.<name>`` span under a page crossing under its
    tick phase, the weights crossing's under ``crossing.*``; tokens equal
    the run with spans off, and with profiler ranges on the device trace
    carries the spans' names."""
    from repro_torch.configs import get_arch
    from repro_torch.obs import trace
    from repro_torch.serve.engine import SecureServingEngine
    params = _smoke_params()
    arch = get_arch("minitron-4b")
    cfg = arch.make_smoke_config()
    runs = []
    for spans in (False, True):
        reg = TenantRegistry(KeyHierarchy(5, device=card), max_tenants=2)
        for t in "ab":
            reg.register(t)
        sessions = [reg.open_session(t) for t in "ab"]
        eng = SecureServingEngine(
            arch, cfg, params, scheme="seda", use_kernel=True, max_slots=2,
            page_tokens=4, pages_per_slot=4, registry=reg, rotate_every=2,
            trace=True, device=card)
        if spans:
            trace.enable()
        reset_launches()
        try:
            rids = [eng.submit(prompt=p, max_new_tokens=6, session=s)
                    for p, s in zip(([5, 9, 3, 7, 1], [2, 8, 6]), sessions)]
            eng.run()
        finally:
            trace.disable()
        runs.append(([eng.requests[r].generated for r in rids],
                     eng.tracer.events(), dict(LAUNCHES)))
    (off_tokens, _, _), (tokens, events, launches) = runs
    assert tokens == off_tokens
    kernel_spans = [e for e in events if e["name"].startswith("kernel.")]
    counts: dict = {}
    for e in kernel_spans:
        counts[e["name"][len("kernel."):]] = counts.get(
            e["name"][len("kernel."):], 0) + 1
    assert counts == {k: v for k, v in launches.items() if v}
    for e in kernel_spans:
        chain = _span_chain(events, e)
        assert chain[0] in ("pageio.crypt",), chain
        assert any(n.startswith("pageio.") and n != "pageio.crypt"
                   for n in chain), chain
        assert chain[-1] == "tick" and chain[-2] in (
            "tick_begin", "decode_dispatch", "tick_end"), chain
    keys = SecureKeys.derive(6, device=card)
    from repro_torch.core import secure_memory as sm
    tree = {"w": torch.randn(64, 96, device=card)}
    spec = sm.make_region_spec(tree)
    process = trace.enable(ranges=True)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            state = sm.protect(tree, keys, spec)
            _, ok = sm.unprotect(state, keys, spec)
            torch.cuda.synchronize()
    finally:
        trace.disable()
    assert bool(ok)
    got = process.events()
    for name in ("kernel.otp_xor", "kernel.nh_hash_kernel_call"):
        spans_named = [e for e in got if e["name"] == name]
        assert spans_named, name
        assert all(_span_chain(got, e)[-1] in ("crossing.protect",
                                                "crossing.unprotect")
                   for e in spans_named)
    names = {e.name for e in prof.events()}
    assert {"crossing.protect", "kernel.otp_xor"} <= names


# ---------------------------------------------------------------------------
# CUDA graphs of the model's serving steps.
# ---------------------------------------------------------------------------


def _graph_engine(name, card, dtype: str = "float32", **kw):
    """An engine on the card over the smoke config in ``dtype``: 2 slots
    of 8 pages of 4 tokens, so decode buckets 1, 2, 4, 8 and padded
    prefill lengths 1 to 32."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    from repro_torch.serve.engine import SecureServingEngine
    arch = get_arch(name)
    cfg = dataclasses.replace(arch.make_smoke_config(), dtype=dtype)
    params = init_params(lm.lm_specs(cfg), 0, device="cpu")
    return SecureServingEngine(arch, cfg, params, scheme="seda",
                               use_kernel=True, max_slots=2, page_tokens=4,
                               pages_per_slot=8, device=card, **kw)


def _assert_bitwise(want, got) -> None:
    from repro_torch.models.step_graph import tensors
    want, got = tensors(want), tensors(got)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


GRAPH_CASES = [("minitron-4b", "float32"), ("minitron-4b", "bfloat16"),
               ("olmoe-1b-7b", "float32"), ("deepseek-v3-671b", "float32"),
               ("jamba-v0.1-52b", "float32")]


@pytest.mark.parametrize("name,dtype", GRAPH_CASES)
def test_decode_graphs_equal_eager_steps(card, name, dtype):
    """For every page bucket, the replayed decode graph gives the eager
    ``lm_decode`` bit for bit: logits, sampled tokens and new cache
    leaves.  The buckets replay in a mixed order on fresh inputs and
    fresh on-chip state, so a stale static buffer shows."""
    from repro_torch.models import lm
    from repro_torch.serve import kv_pages as kvp
    from repro_torch.serve.serve_step import greedy_sample
    eng = _graph_engine(name, card, dtype)
    gen = torch.Generator(device=card).manual_seed(0)
    assert eng._step_graph("decode", 1) is not None
    assert sorted(eng._graphs["decode"]) == [1, 2, 4, 8]
    assert eng.stats["graph_captures"] == len(eng._graphs["decode"]) + len(
        eng._graphs["prefill"])
    s, ptok = eng.max_slots, eng.page_tokens
    for bucket in (8, 1, 4, 2, 8, 2, 1, 4):
        for t in eng.onchip:
            t.copy_(torch.randn(t.shape, generator=gen, device=card))
        lengths = torch.randint(0, bucket * ptok, (s,), generator=gen,
                                device=card)
        tokens = torch.randint(0, eng.cfg.vocab, (s, 1), generator=gen,
                               device=card)
        dense = [torch.randn((leaf.steps, s, bucket * ptok) + leaf.rest,
                             generator=gen, device=card).to(
                                 kvp._torch_dtype(leaf.dtype))
                 for leaf in eng.spec.leaves]
        caches = eng._merge_cache_leaves(dense, lengths)
        want = lm.lm_decode(eng.cfg, eng.params, tokens, caches)
        got = lm.lm_decode(eng.cfg, eng.params, tokens, caches,
                           graph=eng._step_graph("decode", bucket))
        _assert_bitwise(want, got)
        assert torch.equal(greedy_sample(want[0]), greedy_sample(got[0]))
    assert eng.stats["decode_graph_replays"] == 9


@pytest.mark.parametrize("name,dtype", GRAPH_CASES[:4])
def test_prefill_graphs_equal_eager_steps(card, name, dtype):
    """For every padded prefill length, the replayed prefill graph gives
    the eager padded prefill (its last position an int) bit for bit:
    logits and cache leaves; lengths in a mixed order, each with a
    prompt of its own length."""
    from repro_torch.models import lm
    eng = _graph_engine(name, card, dtype)
    rng = np.random.default_rng(1)
    assert eng.prefill_buckets and eng._step_graph("prefill", 1) is not None
    lengths = sorted(eng._graphs["prefill"])
    assert lengths == [1, 2, 4, 8, 16, 32]
    for n in lengths[::-1] + lengths:
        lp = int(rng.integers(n // 2 + 1, n + 1))
        seq = list(map(int, rng.integers(1, eng.cfg.vocab, lp)))
        batch = {"tokens": torch.tensor([seq + [0] * (n - lp)],
                                        dtype=torch.int64, device=card)}
        want = lm.lm_prefill(eng.cfg, eng.params, batch, eng.max_len,
                             last_pos=lp - 1)
        got = lm.lm_prefill(
            eng.cfg, eng.params, batch, eng.max_len,
            last_pos=torch.full((1,), lp - 1, dtype=torch.int64,
                                device=card),
            graph=eng._step_graph("prefill", n))
        _assert_bitwise(want, got)
    assert eng.stats["prefill_graph_replays"] == 1 + 2 * len(lengths)


def _tenant_graph_run(device, params, graphs: bool = True) -> dict:
    """4 tenants on the smoke config, a rotation every 3 ticks, every
    tick verified: the graph counters after each tick, the tokens, the
    pool and the Merkle root."""
    from repro_torch.configs import get_arch
    from repro_torch.serve import kv_pages as kvp
    from repro_torch.serve.engine import SecureServingEngine
    arch = get_arch("minitron-4b")
    reg = TenantRegistry(KeyHierarchy(9, device=device), max_tenants=4)
    for t in range(4):
        reg.register(f"t{t}")
    sessions = [reg.open_session(f"t{t}") for t in range(4)]
    eng = SecureServingEngine(arch, arch.make_smoke_config(), params,
                              scheme="seda", use_kernel=True, registry=reg,
                              rotate_every=3, max_slots=4, page_tokens=4,
                              pages_per_slot=8, n_pages=32,
                              verify_every_step=True, device=device)
    if not graphs:
        eng._step_graph = lambda kind, key: None
    rng = np.random.default_rng(12)
    rids = [eng.submit(prompt=list(map(int, rng.integers(1, 256, n))),
                       max_new_tokens=m, session=sessions[i % 4])
            for i, (n, m) in enumerate(zip((3, 9, 14, 6, 11, 5, 17, 2),
                                           (20, 22, 17, 24, 20, 25, 14, 28)))]
    ticks = []
    while not all(eng.requests[r].state == "finished" for r in rids):
        eng.step()
        ticks.append({k: eng.stats[k] for k in (
            "decode_steps", "decode_graph_replays", "prefill_graph_replays",
            "graph_captures", "admitted")})
        assert eng.tick < 100
    pool = [t.cpu() for t in (*eng.pool.cts, eng.pool.page_macs,
                              eng.pool.page_vns, eng.pool.pool_mac)]
    merkle_ok = eng.merkle.verify_against(
        kvp.merkle_leaf_macs(eng.pool, eng.spec))
    return {"tokens": [eng.requests[r].generated for r in rids],
            "ticks": ticks, "pool": pool, "root": eng.merkle.root(),
            "ok": bool(eng.deferred_check()) and merkle_ok,
            "rotations": eng.stats["rotations"]}


def test_tenant_engine_replays_graphs_every_tick(card):
    """A 4-tenant engine with rotations replays its decode graph on
    every tick after the first and captures nothing after it; its tokens
    are the CPU's, and its page ciphertexts, MACs, VNs, pool MAC and
    Merkle root the eager card run's (floats summed on another device
    give other K/V bytes, so the CPU's pool is compared by its VNs)."""
    params = _smoke_params()
    cpu = _tenant_graph_run("cpu", params)
    eager = _tenant_graph_run(card, params, graphs=False)
    got = _tenant_graph_run(card, params)
    assert got["tokens"] == eager["tokens"] == cpu["tokens"]
    assert len(got["ticks"]) >= 40 and got["rotations"] >= 13
    first, last = got["ticks"][0], got["ticks"][-1]
    assert first["graph_captures"] == 4 + 6 > 0
    for t in got["ticks"]:
        assert t["decode_graph_replays"] == t["decode_steps"]
        assert t["prefill_graph_replays"] == t["admitted"]
        assert t["graph_captures"] == first["graph_captures"]
    assert last["decode_steps"] == len(got["ticks"])
    assert all(t["graph_captures"] == t["decode_graph_replays"] == 0
               for t in eager["ticks"] + cpu["ticks"])
    assert all(torch.equal(a, b) for a, b in zip(got["pool"], eager["pool"]))
    assert got["root"] == eager["root"]
    assert torch.equal(got["pool"][-2], cpu["pool"][-2])      # page VNs
    assert got["ok"] and eager["ok"] and cpu["ok"]
