"""The port's secure checkpoints against the JAX reference.

Checkpoints cross between the packages in both directions: the
reference's load bit-equal in the port, and the port writes leaf files
and a manifest byte-identical to the reference's for the same tree and
keys.  Torn and stale directories, a wrong key, a shape mismatch, a
tampered leaf or manifest and a tampered audit proof are refused, as in
``tests/test_checkpoint.py``.  The launcher serves a checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import secure_ckpt as j_ckpt
from repro.core.secure_memory import SecureKeys as JKeys
from repro.serve import merkle_pool as j_mkp
from repro_torch.checkpoint.secure_ckpt import (CheckpointError, latest_step,
                                                load_checkpoint,
                                                save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.core.bytesutil import TensorSpec
from repro_torch.core.layout import tree_flatten
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.launch import serve as launch
from repro_torch.models import lm
from repro_torch.models.layers import init_params
from repro_torch.serve import merkle_pool as mkp

SEED = 1234


def _tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {
        "layers": {"w1": f32(16, 16).to(torch.bfloat16),
                   "b": torch.from_numpy(
                       rng.integers(-5, 5, 7).astype(np.int32))},
        "embed": f32(32, 16),
        "blocks": [{"odd": torch.from_numpy(
            rng.integers(0, 256, 13).astype(np.uint8))}, {"w": f32(3, 5)}],
    }


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _jax_tree(tree):
    return jax.tree_util.tree_map(
        _to_jax, tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_same_leaves(got, want) -> None:
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0],
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bytes(a) == _bytes(b)


@pytest.fixture(scope="module")
def keys():
    return JKeys.derive(SEED), SecureKeys.derive(SEED, device="cpu")


def _proofs():
    """One audit proof from each package's Merkle maintainer over the
    same page MACs."""
    macs = np.random.default_rng(5).integers(0, 256, (6, 8), np.uint8)
    out = []
    for pkg in (mkp, j_mkp):
        pool = pkg.MerklePagePool(6, leaf_fn=lambda _: macs,
                                  owners_fn=lambda: np.array([1, 1, 2, 1, 2,
                                                              -1]))
        pool.on_pool_update(None, object())
        out.append(pool.audit_proof([0, 1, 3], tenant=1))
    return out


@pytest.mark.parametrize("block_bytes", [64, 512])
def test_reference_checkpoint_loads_bit_equal(keys, tmp_path, block_bytes):
    jk, tk = keys
    tree = _tree(1)
    path = j_ckpt.save_checkpoint(str(tmp_path), 5, _jax_tree(tree), jk,
                                  block_bytes=block_bytes,
                                  extra_state={"data": {"step": 5}})
    out, manifest = load_checkpoint(path, tree, tk, device="cpu")
    _assert_same_leaves(out, tree)
    assert manifest["extra_state"]["data"]["step"] == 5
    # a template of specs gives the same tree
    specs = jax.tree_util.tree_map(
        TensorSpec.of, tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    out, _ = load_checkpoint(path, specs, tk, device="cpu")
    _assert_same_leaves(out, tree)


@pytest.mark.parametrize("block_bytes", [64, 512])
def test_port_checkpoint_is_byte_identical(keys, tmp_path, block_bytes):
    jk, tk = keys
    tree = _tree(2)
    proof, j_proof = _proofs()
    assert proof.to_dict() == j_proof.to_dict()
    kw = dict(block_bytes=block_bytes, extra_state={"seed": 0},
              mesh_shape=(16, 16))
    ours = save_checkpoint(str(tmp_path / "port"), 7, tree, tk,
                           audit_proofs=[proof], **kw)
    theirs = j_ckpt.save_checkpoint(str(tmp_path / "ref"), 7,
                                    _jax_tree(tree), jk,
                                    audit_proofs=[j_proof], **kw)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in os.listdir(ours):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    out, manifest = j_ckpt.load_checkpoint(ours, _jax_tree(tree), jk)
    assert manifest["mesh_shape"] == [16, 16]
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    tree_flatten(_jax_tree(tree))[0]):
        assert _bytes(a) == _bytes(b)


def test_roundtrip_and_latest_step(keys, tmp_path):
    _, tk = keys
    tree = _tree(3)
    assert latest_step(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 10, tree, tk)
    path = save_checkpoint(str(tmp_path), 20, tree, tk)
    out, manifest = load_checkpoint(path, tree, tk, device="cpu")
    _assert_same_leaves(out, tree)
    assert manifest["step"] == 20 and manifest["mesh_shape"] is None
    # republishing a step replaces it and leaves no debris
    tree2 = {**tree, "embed": tree["embed"] + 1}
    save_checkpoint(str(tmp_path), 20, tree2, tk)
    assert sorted(os.listdir(tmp_path)) == ["step_00000010", "step_00000020"]
    _assert_same_leaves(load_checkpoint(path, tree, tk, device="cpu")[0],
                        tree2)


def test_debris_is_never_offered(keys, tmp_path):
    _, tk = keys
    tree = _tree(4)
    save_checkpoint(str(tmp_path), 20, tree, tk)
    os.makedirs(tmp_path / "step_00000030.tmp")           # crashed writer
    old = tmp_path / "step_00000040.old"                   # crashed publish
    os.makedirs(old)
    (old / "manifest.json").write_text("{}")
    torn = tmp_path / "step_00000050"                      # no manifest
    os.makedirs(torn)
    (torn / "leaf_00000.bin").write_bytes(b"\0" * 64)
    assert latest_step(str(tmp_path)) == 20
    with pytest.raises(CheckpointError, match="manifest"):
        load_checkpoint(str(torn), tree, tk, device="cpu")
    # a save clears its own step's debris before it writes
    os.makedirs(tmp_path / "step_00000060.tmp")
    (tmp_path / "step_00000060.tmp" / "junk").write_bytes(b"x")
    path = save_checkpoint(str(tmp_path), 60, tree, tk)
    assert not os.path.exists(str(tmp_path / "step_00000060.tmp"))
    assert sorted(os.listdir(path))[-1] == "manifest.json"
    assert latest_step(str(tmp_path)) == 60


def test_tampered_leaf_is_rejected(keys, tmp_path):
    _, tk = keys
    tree = _tree(5)
    path = save_checkpoint(str(tmp_path), 2, tree, tk)
    leaf = os.path.join(path, "leaf_00001.bin")
    raw = bytearray(open(leaf, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(leaf, "wb").write(bytes(raw))
    with pytest.raises(CheckpointError, match="integrity"):
        load_checkpoint(path, tree, tk, device="cpu")
    open(leaf, "wb").write(bytes(raw[:-64]))
    with pytest.raises(CheckpointError, match="truncated"):
        load_checkpoint(path, tree, tk, device="cpu")


def test_wrong_key_and_shape_mismatch_are_rejected(keys, tmp_path):
    _, tk = keys
    tree = _tree(6)
    path = save_checkpoint(str(tmp_path), 3, tree, tk)
    with pytest.raises(CheckpointError, match="integrity"):
        load_checkpoint(path, tree, SecureKeys.derive(999, device="cpu"),
                        device="cpu")
    bad = {**tree, "embed": torch.zeros((8, 8))}
    with pytest.raises(CheckpointError, match="mismatch"):
        load_checkpoint(path, bad, tk, device="cpu")
    bad = {**tree, "embed": tree["embed"].to(torch.bfloat16)}
    with pytest.raises(CheckpointError, match="mismatch"):
        load_checkpoint(path, bad, tk, device="cpu")
    with pytest.raises(CheckpointError, match="leaf count"):
        load_checkpoint(path, {"embed": tree["embed"]}, tk, device="cpu")


@pytest.mark.parametrize("field", ["layer_macs", "model_mac", "vn_lo"])
def test_tampered_manifest_is_rejected(keys, tmp_path, field):
    _, tk = keys
    tree = _tree(7)
    path = save_checkpoint(str(tmp_path), 4, tree, tk)
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    if field == "layer_macs":
        manifest[field][0][0] ^= 0xFF
    elif field == "model_mac":
        manifest[field][3] ^= 0x01
    else:
        manifest[field] += 1
    json.dump(manifest, open(mpath, "w"))
    # the model MAC is the deferred level: only verify="model" reads it
    verify = "model" if field == "model_mac" else "layer"
    with pytest.raises(CheckpointError, match="integrity"):
        load_checkpoint(path, tree, tk, verify=verify, device="cpu")


def test_tampered_audit_proof_is_rejected(keys, tmp_path):
    _, tk = keys
    tree = _tree(8)
    proof, _ = _proofs()
    path = save_checkpoint(str(tmp_path), 1, tree, tk, audit_proofs=[proof])
    _, manifest = load_checkpoint(path, tree, tk, device="cpu")
    stored = mkp.proof_from_dict(manifest["audit_proofs"][0])
    assert mkp.verify_proof(stored, expected_root=proof.root)
    mpath = os.path.join(path, "manifest.json")
    doc = json.load(open(mpath))
    doc["audit_proofs"][0]["pages"][0]["mac"] = "00" * mkp.MAC_BYTES
    json.dump(doc, open(mpath, "w"))
    with pytest.raises(CheckpointError, match="audit proof 0"):
        load_checkpoint(path, tree, tk, device="cpu")


def test_load_defaults_to_the_card(keys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tk = keys
    path = save_checkpoint(str(tmp_path), 1, _tree(9), tk)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(path, _tree(9), tk)


def test_launcher_serves_a_checkpoint(tmp_path):
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "5", "--gen-len", "3", "--ckpt-dir", str(tmp_path)]
    cfg = get_arch("minitron-4b").make_smoke_config()
    params = init_params(lm.lm_specs(cfg), 7, device="cpu")
    save_checkpoint(str(tmp_path), 3, params,
                    SecureKeys.derive(0, device="cpu"))
    got = launch.main(argv)
    want = launch._serve_paged(get_arch("minitron-4b"), cfg, params,
                               launch._parser().parse_args(argv),
                               torch.device("cpu"))
    assert (got["tokens"] == want["tokens"]).all()
    assert got["deferred_mac_ok"]
    with pytest.raises(CheckpointError, match="integrity"):
        launch.main(argv + ["--seed", "1"])          # other session keys
    fresh = launch.main(argv[:-1] + [str(tmp_path / "empty")])
    assert fresh["tokens"].shape == (2, 3)
