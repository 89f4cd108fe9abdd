"""The port's weights boundary against the JAX reference.

``repro_torch.core.secure_memory`` (protect / unprotect), the
``SecureExecutor`` of every scheme, the address map, the VN helpers, the
byte views, T-AES and the ``cbc`` / ``naive`` MAC engines, each held
byte for byte against ``repro.core`` on the same numpy inputs.  On the
CPU the kernel wrappers run their plain versions; the CUDA route is held
to the CPU one in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks
from repro.core import bytesutil as j_bytes
from repro.core import ctr as j_ctr
from repro.core import layout as j_layout
from repro.core import mac as j_mac
from repro.core import secure_exec as j_se
from repro.core import secure_memory as j_sm
from repro.core import vn as j_vn
from repro_torch.core import (baes, bytesutil, ctr, layout, mac,
                              secure_exec, vn)
from repro_torch.core import secure_memory as sm
from repro_torch.kernels import LAUNCHES, reset_launches

SEED = 1234


def to_jax(t: torch.Tensor):
    """A port tensor as the reference's array (bf16 by its bits)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def to_np(x) -> np.ndarray:
    """Bytes of a port tensor or a reference array, for comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def make_tree(seed: int = 0) -> dict:
    """bf16 + f32 + int32 leaves, an odd byte count, nested dicts and a
    list, with keys out of sorted order."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {
        "zeta": {"w": f32(8, 12), "b": f32(5)},
        "embed": f32(7, 9).to(torch.bfloat16),
        "segments": [{"wq": f32(2, 16, 8).to(torch.bfloat16),
                      "norm": f32(3)},
                     {"odd": torch.from_numpy(
                         rng.integers(0, 256, 13).astype(np.uint8))}],
        "alpha": torch.from_numpy(
            rng.integers(-100, 100, 31).astype(np.int32)),
    }


def jax_tree(tree):
    return jax.tree_util.tree_map(to_jax, tree,
                                  is_leaf=lambda x: isinstance(x,
                                                               torch.Tensor))


def flat(tree) -> list:
    return layout.tree_flatten(tree)[0]


@pytest.fixture(scope="module")
def keys():
    return (j_sm.SecureKeys.derive(SEED),
            sm.SecureKeys.derive(SEED, device="cpu"))


def assert_state_equal(got: sm.SecureState, want) -> None:
    assert len(got.ciphertexts) == len(want.ciphertexts)
    for a, b in zip(got.ciphertexts, want.ciphertexts):
        assert (a.numpy() == np.asarray(b)).all()
    assert (got.layer_macs.numpy() == np.asarray(want.layer_macs)).all()
    assert (got.model_mac.numpy() == np.asarray(want.model_mac)).all()
    assert got.vn_lo == int(want.vn_lo)


def assert_tree_equal(got, want_torch) -> None:
    for a, b in zip(flat(got), flat(want_torch), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert (to_np(a) == to_np(b)).all()


# -- byte views, layout, VNs -------------------------------------------------


def test_tensor_bytes_match_reference():
    for t in flat(make_tree(1)):
        for multiple in (16, 64):
            buf = bytesutil.tensor_to_bytes(t, multiple=multiple)
            want = j_bytes.tensor_to_bytes(to_jax(t), multiple=multiple)
            assert (buf.numpy() == np.asarray(want)).all()
            spec = bytesutil.TensorSpec.of(t)
            assert spec == j_bytes.TensorSpec.of(to_jax(t))
            back = bytesutil.bytes_to_tensor(buf, spec)
            assert back.dtype == t.dtype and (to_np(back) == to_np(t)).all()
    assert bytesutil.TensorSpec.of(
        bytesutil.TensorSpec((4, 3), "bfloat16", 24)).nbytes == 24


@pytest.mark.parametrize("block_bytes", [64, 512])
def test_address_map_matches_reference(block_bytes):
    tree = make_tree()
    got = layout.build_address_map(tree, block_bytes=block_bytes)
    want = j_layout.build_address_map(jax_tree(tree), block_bytes=block_bytes)
    assert got.total_bytes == want.total_bytes
    assert got.block_bytes == want.block_bytes
    assert [tuple(l) for l in got.leaves] == [tuple(l) for l in want.leaves]
    assert got.leaves[0].path == "['alpha']"
    assert "['segments'][0]['wq']" in got.by_path()
    # a custom layer map and a tree of specs give the same layout
    specs = jax.tree_util.tree_map(
        bytesutil.TensorSpec.of, tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    custom = lambda p: len(p) % 3                         # noqa: E731
    assert (layout.build_address_map(specs, block_bytes=block_bytes,
                                     layer_of=custom)
            == tuple(j_layout.build_address_map(
                jax_tree(tree), block_bytes=block_bytes, layer_of=custom)))


def test_tree_unflatten_restores_structure():
    tree = make_tree()
    leaves, treedef = layout.tree_flatten(tree)
    back = layout.tree_unflatten(treedef, leaves)
    assert list(back) == sorted(tree)
    assert isinstance(back["segments"], list)
    assert back["segments"][1]["odd"] is tree["segments"][1]["odd"]
    pairs, _ = layout.tree_flatten_with_path({"b": None, "a": (1, 2)})
    assert pairs == [("['a'][0]", 1), ("['a'][1]", 2)]


@pytest.mark.parametrize("role", list(vn.Role))
def test_vn_matches_reference(role):
    for layer_id, step, slot in ((0, 0, 0), (3, 4097, 2), (600, 77, 300)):
        want = int(j_vn.vn_for(role, layer_id=layer_id, step=step, slot=slot))
        assert vn.vn_for(role, layer_id=layer_id, step=step,
                         slot=slot) == want
        hi, lo = vn.vn_words(role, layer_id=layer_id, step=step, slot=slot)
        assert (hi, lo) == (0, want)
    steps = np.array([0, 1, 4095, 4096, 70000], np.uint32)
    got = vn.vn_for(role, layer_id=5, step=torch.from_numpy(
        steps.astype(np.int64)))
    want = np.asarray(j_vn.vn_for(role, layer_id=5, step=jnp.asarray(steps)))
    assert (got.numpy().view(np.uint32) == want).all()


def test_t_aes_matches_reference_across_a_pa_carry(keys):
    jk, tk = keys
    buf = np.random.default_rng(2).integers(0, 256, 16 * 9, np.uint8)
    for pa_lo in (0, 2 ** 32 - 4):
        want = j_ctr.ctr_encrypt(jnp.asarray(buf), jk.round_keys, 7, pa_lo,
                                 0, 0xA0000003)
        got = ctr.ctr_encrypt(torch.from_numpy(buf), tk.round_keys, 7, pa_lo,
                              0, 0xA0000003)
        assert (got.numpy() == np.asarray(want)).all()
        assert (ctr.ctr_decrypt(got, tk.round_keys, 7, pa_lo, 0,
                                0xA0000003).numpy() == buf).all()


# -- MAC engines ------------------------------------------------------------


@pytest.mark.parametrize("engine", ["nh", "cbc", "naive"])
@pytest.mark.parametrize("block_bytes", [32, 64])
def test_mac_engines_match_reference(keys, engine, block_bytes):
    jk, tk = keys
    rng = np.random.default_rng(block_bytes)
    n = 9
    blocks = rng.integers(0, 256, (n, block_bytes), np.uint8)
    fields = (np.arange(n) * 4 + 40, 0xA0000001, 2, 1, np.arange(n))
    jb = j_mac.Binding.make(*fields)
    tb = mac.Binding.make(*(torch.as_tensor(np.asarray(f, np.int64))
                            for f in fields))
    kw = dict(engine=engine)
    want = j_mac.block_macs(jnp.asarray(blocks), jb, hash_key_u32=jk.hash_key,
                            round_keys=jk.round_keys, **kw)
    got = mac.block_macs(torch.from_numpy(blocks), tb,
                         hash_key_u32=tk.hash_key, round_keys=tk.round_keys,
                         **kw)
    assert (got.numpy() == np.asarray(want)).all()
    lm = mac.layer_mac(torch.from_numpy(blocks), tb, hash_key_u32=tk.hash_key,
                       round_keys=tk.round_keys, **kw)
    want_lm = j_mac.layer_mac(jnp.asarray(blocks), jb,
                              hash_key_u32=jk.hash_key,
                              round_keys=jk.round_keys, **kw)
    assert (lm.numpy() == np.asarray(want_lm)).all()
    both = torch.stack([lm, got[0]])
    assert (mac.model_mac(both).numpy()
            == np.asarray(j_mac.model_mac(jnp.asarray(both.numpy())))).all()
    assert bool(mac.verify_layer(torch.from_numpy(blocks), tb, lm,
                                 hash_key_u32=tk.hash_key,
                                 round_keys=tk.round_keys, **kw))
    assert not bool(mac.verify_layer(torch.from_numpy(blocks), tb, lm ^ 1,
                                     hash_key_u32=tk.hash_key,
                                     round_keys=tk.round_keys, **kw))
    with pytest.raises(ValueError, match="unknown MAC engine"):
        mac.block_macs(torch.from_numpy(blocks), tb,
                       hash_key_u32=tk.hash_key, round_keys=tk.round_keys,
                       engine="sha")


# -- protect / unprotect ----------------------------------------------------


@pytest.mark.parametrize("scheme", list(secure_exec.SCHEMES))
def test_executor_protect_matches_reference(keys, scheme):
    jk, tk = keys
    tree = make_tree()
    jex = j_se.SecureExecutor(scheme=scheme, keys=jk)
    ex = secure_exec.SecureExecutor(scheme=scheme, keys=tk)
    spec, jspec = ex.region_spec(tree), jex.region_spec(jax_tree(tree))
    assert spec.addr_map == jspec.addr_map
    assert spec.n_layers == jspec.n_layers == 4
    state = ex.protect(tree, spec, step=3)
    if scheme == "off":
        assert state is tree
    else:
        assert_state_equal(state, jex.protect(jax_tree(tree), jspec, step=3))
    out, ok = ex.unprotect(state, spec)
    _, j_ok = jex.unprotect(jex.protect(jax_tree(tree), jspec, step=3), jspec)
    assert bool(ok) and bool(j_ok)
    assert_tree_equal(out, tree)


@pytest.mark.parametrize("mac_engine", ["cbc", "naive"])
def test_protect_other_engines_match_reference(keys, mac_engine):
    jk, tk = keys
    tree = make_tree(2)
    spec = sm.make_region_spec(tree, block_bytes=64, mac_engine=mac_engine)
    jspec = j_sm.make_region_spec(jax_tree(tree), block_bytes=64,
                                  mac_engine=mac_engine)
    state = sm.protect(tree, tk, spec, step=1)
    assert_state_equal(state, j_sm.protect(jax_tree(tree), jk, jspec, step=1))
    out, ok = sm.unprotect(state, tk, spec)
    assert bool(ok)
    assert_tree_equal(out, tree)


@pytest.mark.parametrize("use_baes", [True, False])
def test_plain_ciphers_in_chunks_match_reference(keys, monkeypatch,
                                                  use_baes):
    """Wide B-AES and T-AES run in chunks of blocks: several chunks per
    leaf give the reference's bytes (PAs and counters carry across)."""
    jk, tk = keys
    monkeypatch.setattr(sm, "_PLAIN_AES_CHUNK", 16)
    tree = {"w": torch.from_numpy(np.random.default_rng(3).standard_normal(
        (9, 130)).astype(np.float32)), "v": torch.zeros(70)}
    spec = sm.make_region_spec(tree, block_bytes=512, use_baes=use_baes)
    jspec = j_sm.make_region_spec(jax_tree(tree), block_bytes=512,
                                  use_baes=use_baes)
    state = sm.protect(tree, tk, spec, step=9)
    assert_state_equal(state, j_sm.protect(jax_tree(tree), jk, jspec, step=9))
    out, ok = sm.unprotect(state, tk, spec)
    assert bool(ok)
    assert_tree_equal(out, tree)


def test_narrow_protect_goes_through_the_kernel_wrappers(keys):
    """The kernel-wrapper route (plain versions on the CPU, no launch
    counted) gives core B-AES ciphertexts and core ``nh`` MACs."""
    _, tk = keys
    tree = make_tree(4)
    spec = sm.make_region_spec(tree, block_bytes=64)
    reset_launches()
    state = sm.protect(tree, tk, spec)
    assert all(v == 0 for v in LAUNCHES.values())
    layer_macs = torch.zeros_like(state.layer_macs)
    for leaf, ct, lay in zip(flat(tree), state.ciphertexts,
                             spec.addr_map.leaves):
        n = ct.shape[0] // 64
        pa = (torch.arange(n) * 4 + lay.pa_base) & 0xFFFFFFFF
        counters = torch.stack([torch.zeros_like(pa), pa,
                                torch.zeros_like(pa),
                                torch.full_like(pa, state.vn_lo)], dim=-1)
        want = baes.baes_encrypt(bytesutil.tensor_to_bytes(leaf, multiple=64),
                                 tk.round_keys, counters, block_bytes=64)
        assert torch.equal(ct, want)
        binding = mac.Binding.make(pa, state.vn_lo, lay.layer_id,
                                   lay.fmap_idx, torch.arange(n))
        layer_macs[lay.layer_id] ^= mac.layer_mac(
            ct.reshape(n, 64), binding, hash_key_u32=tk.hash_key,
            round_keys=tk.round_keys)
    assert torch.equal(layer_macs, state.layer_macs)


@pytest.mark.parametrize("verify", ["layer", "model", "none"])
def test_unprotect_verify_levels(keys, verify):
    jk, tk = keys
    tree = make_tree(5)
    spec = sm.make_region_spec(tree)
    state = sm.protect(tree, tk, spec, step=2)
    out, ok = sm.unprotect(state, tk, spec, verify=verify)
    assert bool(ok)
    assert_tree_equal(out, tree)
    cts = list(state.ciphertexts)
    cts[1] = cts[1].clone()
    cts[1][3] ^= 0x40
    _, bad = sm.unprotect(state._replace(ciphertexts=tuple(cts)), tk, spec,
                          verify=verify)
    jspec = j_sm.make_region_spec(jax_tree(tree))
    jstate = j_sm.protect(jax_tree(tree), jk, jspec, step=2)
    jcts = list(jstate.ciphertexts)
    jcts[1] = jcts[1].at[3].set(jcts[1][3] ^ 0x40)
    _, j_bad = j_sm.unprotect(jstate._replace(ciphertexts=tuple(jcts)), jk,
                              jspec, verify=verify)
    assert bool(bad) == bool(j_bad) == (verify == "none")
    with pytest.raises(ValueError, match="verify"):
        sm.unprotect(state, tk, spec, verify="block")


@pytest.mark.parametrize("leaf_idx,byte_idx",
                         [(0, 0), (1, 5), (2, 40), (3, 63), (4, 1), (5, 12),
                          (6, 0)])
def test_tamper_any_leaf_is_detected(keys, leaf_idx, byte_idx):
    _, tk = keys
    tree = make_tree(6)
    spec = sm.make_region_spec(tree)
    state = sm.protect(tree, tk, spec)
    cts = list(state.ciphertexts)
    cts[leaf_idx] = cts[leaf_idx].clone()
    cts[leaf_idx][byte_idx % cts[leaf_idx].shape[0]] ^= 0x5A
    _, ok = sm.unprotect(state._replace(ciphertexts=tuple(cts)), tk, spec)
    assert not bool(ok)


def test_replay_and_stale_vn_are_detected(keys):
    _, tk = keys
    tree = make_tree(7)
    spec = sm.make_region_spec(tree)
    s1 = sm.protect(tree, tk, spec, step=1)
    tree2 = {**tree, "zeta": {k: v + 1 for k, v in tree["zeta"].items()}}
    s2 = sm.protect(tree2, tk, spec, step=2)
    spliced = s2._replace(ciphertexts=(s1.ciphertexts[0],)
                          + s2.ciphertexts[1:])
    assert not bool(sm.unprotect(spliced, tk, spec)[1])
    assert not bool(sm.unprotect(s2._replace(vn_lo=s1.vn_lo), tk, spec)[1])
    assert not torch.equal(s1.ciphertexts[0], s2.ciphertexts[0])


def test_repa_shuffle_is_detected(keys):
    _, tk = keys
    tree = {"w": torch.from_numpy(np.random.default_rng(8).standard_normal(
        (32, 16)).astype(np.float32))}
    spec = sm.make_region_spec(tree, block_bytes=64)
    state = sm.protect(tree, tk, spec)
    ct = state.ciphertexts[0].numpy().reshape(-1, 64)
    shuf = attacks.repa_shuffle(ct, seed=2).reshape(-1)
    _, ok = sm.unprotect(
        state._replace(ciphertexts=(torch.from_numpy(shuf.copy()),)), tk,
        spec)
    assert not bool(ok)
    # The position-free strawman engine lets the same shuffle through.
    naive = sm.make_region_spec(tree, block_bytes=64, mac_engine="naive")
    state = sm.protect(tree, tk, naive)
    shuf = attacks.repa_shuffle(state.ciphertexts[0].numpy().reshape(-1, 64),
                                seed=2).reshape(-1)
    _, ok = sm.unprotect(
        state._replace(ciphertexts=(torch.from_numpy(shuf.copy()),)), tk,
        naive)
    assert bool(ok)


@pytest.mark.parametrize("scheme", ["seda", "off"])
def test_secure_step_matches_reference(keys, scheme):
    jk, tk = keys
    tree = make_tree(9)

    def bump(p, x):
        zeta = {k: v + x for k, v in p["zeta"].items()}
        return {**p, "zeta": zeta}, zeta["b"].sum()

    ex = secure_exec.SecureExecutor(scheme=scheme, keys=tk)
    jex = j_se.SecureExecutor(scheme=scheme, keys=jk)
    spec, jspec = ex.region_spec(tree), jex.region_spec(jax_tree(tree))
    state, aux, ok = ex.make_secure_step(bump, spec)(
        ex.protect(tree, spec, step=0), 0, 2.0)
    jstate, jaux, j_ok = jex.make_secure_step(bump, jspec)(
        jex.protect(jax_tree(tree), jspec, step=0), 0, 2.0)
    assert bool(ok) and bool(j_ok)
    assert float(aux) == pytest.approx(float(jaux))
    if scheme == "off":
        assert_tree_equal(state, bump(tree, 2.0)[0])
        return
    assert_state_equal(state, jstate)
    out, ok = ex.unprotect(state, spec)
    assert bool(ok)
    assert_tree_equal(out, bump(tree, 2.0)[0])


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        secure_exec.SecureExecutor("seda")
    assert secure_exec.SecureExecutor(
        "seda", device="cpu").keys.key.device.type == "cpu"
