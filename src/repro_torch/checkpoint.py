"""Checkpoints of the port's state: NamedTuples, dicts and tensors.

Leaves go into one ``.npz`` keyed by tree path, with the reference's
key names (``repro/checkpoint.py``): a NamedTuple field is ``.name``, a
dict key is ``key`` and a list or tuple index is ``idx``, joined by
``/`` (``.params/w1``, ``.buf/.due``, ``.net/.channel``). So a
checkpoint the reference writes of its ``EngineState`` loads into the
port's, which reads the keys of its own fields and ignores the rest.

Integrity: every leaf is saved beside a CRC32 of its bytes and its
dtype/shape header (``__crc__/<path>``). ``load_checkpoint`` checks
each leaf before restoring it and raises ``CheckpointCorruptionError``
naming the damaged leaf; a damaged container (truncated or overwritten)
raises the same error. A leaf without a stored CRC loads unchecked.
Restored leaves take ``like``'s dtype and device.
"""
from __future__ import annotations

import os
import zipfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_CRC_PREFIX = "__crc__/"
# what a damaged zip container raises while numpy reads it
_CONTAINER_ERRORS = (zipfile.BadZipFile, zlib.error, OSError, EOFError,
                     ValueError)


class CheckpointCorruptionError(ValueError):
    """Checkpoint bytes do not match their stored checksum, or the
    container itself is damaged. The message names the leaf or file."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key part, child) pairs of one node, spelled as the reference
    spells them; None for a leaf."""
    if _is_namedtuple(tree):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {"/".join(prefix): tree}
    out: Dict[str, Any] = {}
    for part, child in kids:
        out.update(_flatten(child, prefix + (part,)))
    return out


def _leaf_crc(arr: np.ndarray) -> np.ndarray:
    # the bytes plus the dtype/shape header: a corruption that rewrites
    # the descriptor but not the payload still trips
    meta = f"{arr.dtype.str}{arr.shape}".encode()
    return np.uint32(zlib.crc32(arr.tobytes() + meta))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Write ``tree`` to ``path`` (numpy adds ``.npz`` when missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {}
    for key, leaf in _flatten(tree).items():
        arr = _to_numpy(leaf)
        flat[key] = arr
        flat[_CRC_PREFIX + key] = _leaf_crc(arr)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)
    return path


def _restore(tree, data, path, prefix=()):
    kids = _children(tree)
    if kids is None:
        return _restore_leaf(tree, data, path, "/".join(prefix))
    vals = [_restore(child, data, path, prefix + (part,))
            for part, child in kids]
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    if isinstance(tree, dict):
        return dict(zip(tree, vals))
    return type(tree)(vals)


def _restore_leaf(like, data, path, key):
    try:
        arr = data[key]
        stored = data[_CRC_PREFIX + key] \
            if _CRC_PREFIX + key in data.files else None
    except _CONTAINER_ERRORS as e:
        raise CheckpointCorruptionError(
            f"checkpoint {path} is damaged at leaf {key}: {e}") from e
    if stored is not None:
        want, got = np.uint32(stored), _leaf_crc(arr)
        if got != want:
            raise CheckpointCorruptionError(
                f"checksum mismatch at {key} in {path}: stored "
                f"{int(want):#010x}, got {int(got):#010x}: the checkpoint "
                f"bytes were corrupted")
    shape = tuple(like.shape)
    if arr.shape != shape:
        raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {shape}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=like.device, dtype=like.dtype)
    return arr.astype(np.asarray(like).dtype)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Optional[int]]:
    """Restore into the structure of ``like`` (shapes must match); each
    leaf in ``like``'s dtype on its device. Returns (tree, step)."""
    if not path.endswith(".npz"):
        path += ".npz"
    try:
        data = np.load(path)
        step = int(data["__step__"]) if "__step__" in data.files else None
    except FileNotFoundError:
        raise
    except _CONTAINER_ERRORS as e:
        raise CheckpointCorruptionError(
            f"checkpoint {path} is damaged: {e}") from e
    with data:
        return _restore(like, data, path), step
