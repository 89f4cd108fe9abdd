"""Port core crypto (``repro_torch.core``) against the JAX reference.

Same numpy inputs through both packages; every output must be equal byte
for byte.  Also holds the port to its import boundary: no module under
``src/repro_torch/`` and no line of ``chip_smoke.py`` imports JAX or the
JAX package.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aes as j_aes
from repro.core import baes as j_baes
from repro.core import ctr as j_ctr
from repro.core import mac as j_mac
from repro.core import multilevel as j_ml
from repro.core import secure_exec as j_se
from repro.core import vn as j_vn
from repro.core.secure_memory import SecureKeys as JKeys
from repro_torch import resolve_device
from repro_torch.core import aes, baes, ctr, mac, multilevel, secure_exec, vn
from repro_torch.core.bytesutil import bytes_to_u32, i64, u32, u32_to_bytes
from repro_torch.core.secure_memory import SecureKeys

ROOT = Path(__file__).resolve().parents[1]


def _u32(a: np.ndarray) -> torch.Tensor:
    """numpy uint32 -> the port's int32 storage."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np_u32(t: torch.Tensor) -> np.ndarray:
    return i64(t).numpy().astype(np.uint32)


@pytest.fixture(scope="module")
def keys():
    return JKeys.derive(1234), SecureKeys.derive(1234, device="cpu")


def test_fips197_appendix_c1():
    key = np.arange(16, dtype=np.uint8)
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)
    rk = aes.key_expansion_np(key)
    assert (rk == j_aes.key_expansion_np(key)).all()
    assert (aes.key_expansion(torch.from_numpy(key)).numpy() == rk).all()
    out = aes.aes128_encrypt_block(torch.from_numpy(pt.copy())[None],
                                   torch.from_numpy(rk))
    assert bytes(out[0].numpy()).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    assert (aes.SBOX_NP == j_aes._SBOX_NP).all()


def test_aes_random_blocks(keys):
    jk, tk = keys
    blocks = np.random.default_rng(1).integers(0, 256, (33, 16), np.uint8)
    want = np.asarray(j_aes.aes128_encrypt(jnp.asarray(blocks),
                                           jk.round_keys))
    got = aes.aes128_encrypt_block(torch.from_numpy(blocks), tk.round_keys)
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_secure_keys_derive(seed):
    jk, tk = JKeys.derive(seed), SecureKeys.derive(seed, device="cpu")
    assert (tk.key.numpy() == np.asarray(jk.key)).all()
    assert (tk.round_keys.numpy() == np.asarray(jk.round_keys)).all()
    assert (_np_u32(tk.hash_key) == np.asarray(jk.hash_key)).all()


def test_counter_blocks_and_keystream(keys):
    jk, tk = keys
    words = np.random.default_rng(2).integers(0, 2 ** 32, (19, 4), np.uint32)
    assert (ctr.counter_blocks(_u32(words)).numpy()
            == np.asarray(j_ctr.counter_blocks(jnp.asarray(words)))).all()
    want = np.asarray(j_ctr.ctr_keystream(jk.round_keys, jnp.asarray(words)))
    assert (ctr.ctr_keystream(tk.round_keys, _u32(words)).numpy()
            == want).all()


@pytest.mark.parametrize("block_bytes", [16, 64, 176, 192])
def test_baes_encrypt(keys, block_bytes):
    jk, tk = keys
    rng = np.random.default_rng(block_bytes)
    n = 3
    pt = rng.integers(0, 256, n * block_bytes, np.uint8)
    words = rng.integers(0, 2 ** 32, (n, 4), np.uint32)
    want = np.asarray(j_baes.baes_encrypt(
        jnp.asarray(pt), jk.round_keys, jnp.asarray(words),
        block_bytes=block_bytes, key=jk.key))
    got = baes.baes_encrypt(torch.from_numpy(pt), tk.round_keys, _u32(words),
                            block_bytes=block_bytes, key=tk.key)
    assert (got.numpy() == want).all()
    one = np.asarray(j_baes.diversifiers(jk.round_keys, block_bytes // 16,
                                         jnp.asarray(words[0]), jk.key))
    assert (baes.diversifiers(tk.round_keys, block_bytes // 16,
                              _u32(words[0]), tk.key).numpy() == one).all()


def test_nh_hash_extremes_and_random():
    rng = np.random.default_rng(3)
    lanes = rng.integers(0, 2 ** 32, (6, 40), np.uint32)
    lanes[0] = 0xFFFFFFFF                       # every lane sum wraps
    key = rng.integers(0, 2 ** 32, 40, np.uint32)
    key[:] = np.where(np.arange(40) % 3 == 0, 0xFFFFFFFF, key)
    jh, jl = j_mac.nh_hash(jnp.asarray(lanes), jnp.asarray(key))
    th, tl = mac.nh_hash(_u32(lanes), _u32(key))
    assert (th.numpy() == np.asarray(jh)).all()
    assert (tl.numpy() == np.asarray(jl)).all()


def _bindings(rng, n):
    fields = [rng.integers(0, 2 ** 32, n, np.uint32) for _ in range(5)]
    fields[3][0] = 0xFFFFFFFF                   # fmap << 16 must wrap as u32
    return (j_mac.Binding.make(*map(jnp.asarray, fields)),
            mac.Binding.make(*(torch.from_numpy(f.astype(np.int64))
                               for f in fields)))


@pytest.mark.parametrize("block_bytes", [64, 512])
def test_block_macs_and_finalize(keys, block_bytes):
    jk, tk = keys
    rng = np.random.default_rng(block_bytes + 1)
    blocks = rng.integers(0, 256, (5, block_bytes), np.uint8)
    jb, tb = _bindings(rng, 5)
    want = np.asarray(j_mac.block_macs(jnp.asarray(blocks), jb,
                                       hash_key_u32=jk.hash_key,
                                       round_keys=jk.round_keys))
    got = mac.block_macs(torch.from_numpy(blocks), tb,
                         hash_key_u32=tk.hash_key, round_keys=tk.round_keys)
    assert (got.numpy() == want).all()
    hi = rng.integers(0, 2 ** 32, 5, np.uint32)
    lo = rng.integers(0, 2 ** 32, 5, np.uint32)
    fw = np.asarray(j_mac.finalize_words(jnp.asarray(hi), jnp.asarray(lo), jb))
    assert (_np_u32(mac.finalize_words(_u32(hi), _u32(lo), tb)) == fw).all()
    assert (mac.nh_payload(torch.from_numpy(blocks), tb).numpy()
            == np.asarray(j_mac.nh_payload(jnp.asarray(blocks), jb))).all()


@pytest.mark.parametrize("shape,axis", [((7, 8), 0), ((3, 5, 8), 1),
                                        ((4, 0, 8), 1), ((1, 8), 0)])
def test_xor_aggregate(shape, axis):
    macs = np.random.default_rng(4).integers(0, 256, shape, np.uint8)
    want = np.asarray(j_mac.xor_aggregate(jnp.asarray(macs), axis=axis))
    assert (mac.xor_aggregate(torch.from_numpy(macs), axis=axis).numpy()
            == want).all()


def test_bytes_u32_views_and_wrap():
    buf = np.random.default_rng(5).integers(0, 256, 64, np.uint8)
    lanes = bytes_to_u32(torch.from_numpy(buf))
    assert (_np_u32(lanes) == buf.view("<u4")).all()
    assert (u32_to_bytes(lanes).numpy() == buf).all()
    big = torch.tensor([0, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 3, -1])
    assert i64(u32(big)).tolist() == [0, 2 ** 31, 2 ** 32 - 1, 3,
                                      2 ** 32 - 1]


def test_vn_schemes_policies_probe():
    for epoch in (0, 1, 5, (1 << 29) + 3, 2 ** 32 - 1):
        assert vn.kv_page_vn(epoch) == int(j_vn.kv_page_vn(np.uint32(epoch)))
    assert {k: tuple(vars(v).values())
            for k, v in secure_exec.SCHEMES.items()} == {
        k: tuple(vars(v).values()) for k, v in j_se.SCHEMES.items()}
    for name in ("SEDA_DEFAULT", "SGX_LIKE", "MGX_LIKE"):
        assert tuple(getattr(multilevel, name)) == tuple(getattr(j_ml, name))
    for n in (0, 1, 9, 100):
        assert bool(secure_exec.emulated_tree_probe(n)) == bool(
            j_se.emulated_tree_probe(n))


def test_entry_points_need_a_card_unless_cpu_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def _imports(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad
