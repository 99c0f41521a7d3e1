"""Numpy-backed checkpoints in exactly the layout of ``repro.checkpoint.store``.

Layout: ``<dir>/step_<N:08d>/manifest.json`` + one ``.npy`` per leaf of
a (nested) dict, keyed by its ``/``-joined path; the file name replaces
``/`` with ``__``. bfloat16 leaves are stored as their uint16 bits,
since numpy has no bfloat16. Writes are atomic (a temp dir inside
``directory``, then one rename), so a killed save never leaves a half
checkpoint, and ``latest_step`` sweeps the temp dirs such a kill leaves.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out: dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(array as saved, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree: dict) -> str:
    """Write a (nested) dict of arrays or tensors as step ``step``."""
    keyed = _flatten(tree)
    # The temp dir lives INSIDE ``directory`` so the rename stays on one
    # filesystem; mkdtemp does not create parents.
    os.makedirs(directory, exist_ok=True)
    target = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    manifest = {}
    try:
        for key, leaf in keyed.items():
            arr, dtype_name = _to_numpy(leaf)
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": dtype_name}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f, indent=1)
        if os.path.exists(target):
            shutil.rmtree(target)
        os.rename(tmp, target)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    return target


def latest_step(directory: str) -> int | None:
    """Highest completed step under ``directory`` (None if none); also
    removes stale ``.tmp_ckpt_*`` dirs left by a save that was killed."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith(".tmp_ckpt_"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
            continue
        suffix = d[len("step_"):]
        if d.startswith("step_") and suffix.isdigit():
            steps.append(int(suffix))
    return max(steps) if steps else None


def restore(directory: str, step: int) -> dict[str, torch.Tensor]:
    """Every leaf of step ``step`` as a flat {key: CPU tensor} dict.

    Raises ``FileNotFoundError`` for a missing or incomplete step and
    ``ValueError`` when a leaf on disk disagrees with its manifest entry.
    """
    src = os.path.join(directory, f"step_{step:08d}")
    manifest_path = os.path.join(src, "manifest.json")
    if not os.path.isfile(manifest_path):
        raise FileNotFoundError(
            f"no checkpoint manifest under {src!r} (missing or incomplete "
            f"step {step} in {directory!r})"
        )
    with open(manifest_path) as f:
        manifest = json.load(f)["leaves"]
    out = {}
    for key, entry in manifest.items():
        arr = np.load(os.path.join(src, entry["file"]))
        if tuple(arr.shape) != tuple(entry["shape"]):
            raise ValueError(
                f"checkpoint leaf {key!r}: file shape {tuple(arr.shape)} != "
                f"manifest shape {tuple(entry['shape'])}"
            )
        if entry["dtype"] == "bfloat16":
            out[key] = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16
            )
        else:
            if str(arr.dtype) != entry["dtype"]:
                raise ValueError(
                    f"checkpoint leaf {key!r}: file dtype {arr.dtype} != "
                    f"manifest dtype {entry['dtype']}"
                )
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
