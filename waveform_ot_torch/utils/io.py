"""Persistence: named-array bundles and checkpoints (counterpart of
waveform_ot_tpu.utils.io).

Reference: writepickle/readpickle/writejson (ricker_util.py:345-365,
loc_cmt_util.py:657-665), the dict-of-named-arrays snapshots the notebooks
cache results in. The reference's ``readjson`` calls ``pickle.load``
(ricker_util.py:364-365); :func:`read_json` here reads JSON. Pickles and
JSON files of NumPy payloads are the same files the JAX package writes and
reads. Tensors are stored as NumPy arrays.

Checkpoints go through ``torch.save``/``torch.load`` where the JAX package
uses orbax, with the same ``step_{n}`` layout under ``path``.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np
import torch


def _host(v):
    """A tensor as a NumPy array; anything else unchanged."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def write_pickle(filename, names, arrays) -> None:
    """dict(zip(names, arrays)) -> pickle (reference writepickle)."""
    with open(filename, "wb") as fh:
        pickle.dump({k: _host(v) for k, v in zip(names, arrays)}, fh)


def read_pickle(filename):
    with open(filename, "rb") as fh:
        return pickle.load(fh)


def write_json(filename, names, arrays) -> None:
    """JSON variant; arrays, tensors and sequences become nested lists."""
    data = {}
    for k, v in zip(names, arrays):
        v = _host(v)
        data[k] = (np.asarray(v).tolist() if hasattr(v, "__array__")
                   or isinstance(v, (list, tuple)) else v)
    with open(filename, "w", encoding="utf8") as fh:
        json.dump(data, fh)


def read_json(filename):
    """Reads JSON (the reference's readjson reads a pickle,
    ricker_util.py:364-365)."""
    with open(filename, encoding="utf8") as fh:
        return json.load(fh)


def _target(path, step):
    path = Path(path).absolute()
    return path if step is None else path / f"step_{step}"


def save_checkpoint(path, pytree, step: int | None = None) -> None:
    """``pytree`` (tensors, arrays, numbers in dicts/lists/tuples) saved by
    ``torch.save`` into ``path`` or ``path/step_{step}``, overwriting."""
    target = _target(path, step)
    target.mkdir(parents=True, exist_ok=True)
    torch.save(pytree, target / "checkpoint.pt")


def restore_checkpoint(path, template=None, step: int | None = None):
    """The tree :func:`save_checkpoint` wrote, loaded with
    ``weights_only=True``: tensors, NumPy arrays and plain containers only,
    never arbitrary pickled objects. ``template``, as the JAX package's: a
    tree whose leaves the restored ones are cast to (tensors take its dtype
    and device)."""
    with torch.serialization.safe_globals(_numpy_globals()):
        tree = torch.load(_target(path, step) / "checkpoint.pt", weights_only=True)
    return tree if template is None else _like(tree, template)


def _numpy_globals() -> list:
    """What unpickling NumPy arrays and scalars needs: the array and scalar
    reconstructors, ndarray and the dtype classes."""
    dtypes = {type(np.dtype(c)) for c in "?bhilqBHILQefdgFDG"}
    return [np.ndarray, np.dtype, np.ones(1).__reduce__()[0],
            np.float64(0).__reduce__()[0], *dtypes]


def _like(tree, template):
    if isinstance(template, dict):
        return {k: _like(tree[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_like(a, b) for a, b in zip(tree, template)]
        return type(template)(*out) if hasattr(template, "_fields") else type(template)(out)
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(tree).to(dtype=template.dtype, device=template.device)
    if isinstance(template, np.ndarray):
        return np.asarray(tree, dtype=template.dtype)
    return tree
