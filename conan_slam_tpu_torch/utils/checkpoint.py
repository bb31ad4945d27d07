"""Checkpoint and restore of the driver's carried state (port of
conan_slam_tpu.utils.checkpoint).

The reference C++ driver serialises nothing (its filter state lives in
``main``'s locals); long runs need restartable state.  The JAX package
writes its trees with orbax; the port writes one file per checkpoint with
``torch.save``: a flat dict of CPU tensors keyed by their path in the tree
("state.p", "outs.x_est"), read back with ``torch.load(weights_only=True)``,
which runs no pickled code.  A tree is a dict or NamedTuple (``EKFState``,
``SimOutputs``) of tensors, nested.
"""

from __future__ import annotations

import os
from typing import Any, Iterator

import torch


def _children(tree):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    raise TypeError(f"a checkpoint tree holds dicts, NamedTuples and tensors, not "
                    f"{type(tree).__name__}")


def _leaves(tree, path: tuple = ()) -> Iterator[tuple[str, torch.Tensor]]:
    if torch.is_tensor(tree):
        yield ".".join(path), tree
        return
    for name, sub in _children(tree):
        yield from _leaves(sub, path + (name,))


def _rebuild(tree, values: Iterator[torch.Tensor]):
    """``tree``'s structure with its leaves taken from ``values`` in
    ``_leaves`` order."""
    if torch.is_tensor(tree):
        return next(values)
    if isinstance(tree, dict):
        return {name: _rebuild(sub, values) for name, sub in tree.items()}
    return type(tree)(*(_rebuild(sub, values) for sub in tree))


def save(path: str, tree: Any) -> None:
    """Write ``tree`` to the file ``path``, replacing any earlier one; a
    reader sees the old file or the new one, never a part."""
    flat = {name: t.detach().cpu() for name, t in _leaves(tree)}
    tmp = f"{path}.tmp"
    torch.save(flat, tmp)
    os.replace(tmp, path)


def restore(path: str, template: Any) -> Any:
    """Read the checkpoint at ``path`` into ``template``'s structure, on
    each template leaf's device and dtype.  Raises ``ValueError`` if the
    file's leaves differ from the template's in name or shape."""
    flat = torch.load(path, map_location="cpu", weights_only=True)
    want = dict(_leaves(template))
    if set(flat) != set(want):
        raise ValueError(f"checkpoint {path} holds {sorted(flat)}, expected {sorted(want)}")
    for name, t in want.items():
        if flat[name].shape != t.shape:
            raise ValueError(f"checkpoint {path}: {name} has shape {tuple(flat[name].shape)}, "
                             f"expected {tuple(t.shape)}")
    return _rebuild(template, (flat[name].to(device=t.device, dtype=t.dtype)
                               for name, t in want.items()))
