"""Physical-address assignment for trees crossing the untrusted boundary.

The AES-CTR counter and every MAC binding need a stable *physical
address* per protected block.  Leaves of a tree (nested dicts, lists
and tuples of tensors) are laid out in the reference's ``jax.tree_util``
order, each aligned to the protection block size: dict keys sorted,
lists and tuples in order, ``None`` an empty subtree.  Paths are
``jax.tree_util.keystr`` strings (``['segments'][0]['attn']['wq']``), so
PAs, layer ids and checkpoint manifests equal the reference's.

Addresses are in units of 16 B segments, so a PA advances by
``block_bytes // 16`` between consecutive wide blocks.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.bytesutil import TensorSpec

__all__ = ["SEGMENT_BYTES", "LeafLayout", "AddressMap", "build_address_map",
           "tree_flatten_with_path", "tree_flatten", "tree_unflatten"]

SEGMENT_BYTES = 16


def _is_leaf(x) -> bool:
    """Tensors and specs are leaves; a NamedTuple with ``shape`` and
    ``dtype`` (``TensorSpec``, ``ParamSpec``) is a spec, not a node."""
    if isinstance(x, dict) or x is None:
        return False
    if isinstance(x, (list, tuple)):
        return hasattr(x, "shape") and hasattr(x, "dtype")
    return True


class _Slot(NamedTuple):
    index: int      # the leaf's position in the flat order


def _walk(node, path: str, out: list):
    """Append ``node``'s (path, leaf) pairs to ``out``; return its
    treedef.  Module-level recursion: a recursive closure would form a
    reference cycle that keeps every leaf alive until the next garbage
    collection."""
    if _is_leaf(node):
        out.append((path, node))
        return _Slot(len(out) - 1)
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _walk(node[k], f"{path}[{k!r}]", out)
                for k in sorted(node)}
    return type(node)(_walk(v, f"{path}[{i}]", out)
                      for i, v in enumerate(node))


def _build(node, leaves: list):
    if isinstance(node, _Slot):
        return leaves[node.index]
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _build(v, leaves) for k, v in node.items()}
    return type(node)(_build(v, leaves) for v in node)


def tree_flatten_with_path(tree: Any) -> tuple:
    """``([(path_str, leaf), ...], treedef)`` in the reference's order."""
    out: list = []
    treedef = _walk(tree, "", out)
    return out, treedef


def tree_flatten(tree: Any) -> tuple:
    """``(leaves, treedef)``."""
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_unflatten(treedef: Any, leaves) -> Any:
    """Rebuild the tree of ``treedef`` from its flat leaves."""
    return _build(treedef, list(leaves))


class LeafLayout(NamedTuple):
    path: str
    spec: TensorSpec
    pa_base: int          # in 16 B-segment units
    padded_bytes: int     # layout footprint (aligned to block_bytes)
    layer_id: int         # paper's layer_id binding
    fmap_idx: int         # index of the tensor within its layer


class AddressMap(NamedTuple):
    leaves: tuple
    total_bytes: int
    block_bytes: int

    def by_path(self) -> dict:
        return {l.path: l for l in self.leaves}


def build_address_map(tree: Any, *, block_bytes: int = 64,
                      layer_of=None) -> AddressMap:
    """Assign PAs to every leaf of ``tree`` (tensors or specs).

    ``layer_of`` maps a path string to a layer id; by default each
    top-level key of the tree is a layer (the paper's per-DNN-layer MAC
    grouping).
    """
    pairs, _ = tree_flatten_with_path(tree)
    if layer_of is None:
        top_keys: dict[str, int] = {}

        def layer_of(path_str: str) -> int:  # noqa: F811 - the default
            top = path_str.split("]")[0] + "]" if "]" in path_str else path_str
            return top_keys.setdefault(top, len(top_keys))

    layouts = []
    cursor = 0
    fmap_counters: dict[int, int] = {}
    for path_s, leaf in pairs:
        spec = TensorSpec.of(leaf)
        padded = (spec.nbytes + block_bytes - 1) // block_bytes * block_bytes
        lid = int(layer_of(path_s))
        fmap = fmap_counters.get(lid, 0)
        fmap_counters[lid] = fmap + 1
        layouts.append(LeafLayout(path_s, spec, cursor // SEGMENT_BYTES,
                                  padded, lid, fmap))
        cursor += padded
    return AddressMap(tuple(layouts), cursor, block_bytes)
