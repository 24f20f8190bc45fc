"""Checkpoint manager with consistent-hash placement of the state's leaves
— the counterpart of ``repro.training.checkpoint``, writing the same
files.

Layout on disk:

    <dir>/step_<N>/
        manifest.json      {step, n_nodes, engine, entries: path -> node}
        node_<k>.npz       all leaves placed on storage node k

Each leaf is keyed by its path as ``jax.tree_util.keystr`` writes it
(``['params']['seg0']['sub0']['wq']``; ``repro_torch.tree``), in the
reference's flatten order, and placed on a storage node by BinomialHash
(``binomial_lookup64``) of the key's FNV-1a hash.  So the port and the
reference write the same manifest bytes and put the same arrays in the
same node files for one state.  When the storage fleet is resized,
``plan_resize`` lists exactly the leaves that must move.

A bfloat16 leaf is written as the reference writes one: its 2-byte
patterns under the ``.npy`` descr ``'<V2'`` (what numpy writes for the
``ml_dtypes`` bfloat16 that JAX hands it).  ``restore`` reads them back as
``torch.bfloat16``; the reference cannot restore such a file (numpy has no
cast from ``V2``), a fault of the reference that this port does not copy.

Saves are atomic (a ``.tmp`` directory, then a rename); ``latest_step`` and
``restore`` resume.  ``save_async`` copies the state to host memory, then
writes on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from dataclasses import dataclass

import numpy as np
import torch
from numpy.lib import format as npy_format

from repro_torch.core import bits
from repro_torch.core.binomial import binomial_lookup64
from repro_torch.tree import flatten_with_path, unflatten

#: how a bfloat16 leaf lies in a node file: 2-byte voids
BF16_WIRE = np.dtype("V2")


def _fnv1a(s: str) -> int:
    """Deterministic 64-bit string hash (python hash() is process-salted)."""
    h = 0xCBF29CE484222325
    for b in s.encode():
        h = ((h ^ b) * 0x100000001B3) & bits.MASK64
    return h


def _place(leaf_key: str, n_nodes: int) -> int:
    return binomial_lookup64(bits.mix64(_fnv1a(leaf_key)), n_nodes)


def _host(t: torch.Tensor, copy: bool) -> np.ndarray:
    t = t.detach().to("cpu", copy=copy)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_WIRE)
    return t.numpy()


def _savez(path: str, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez`` of ``arrays``, the bfloat16 ones under descr ``'<V2'``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if arr.dtype == BF16_WIRE:
                    npy_format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
                    fid.write(np.ascontiguousarray(arr).tobytes())
                else:
                    npy_format.write_array(fid, arr, allow_pickle=False)


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == BF16_WIRE:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


@dataclass
class CheckpointManager:
    directory: str
    n_nodes: int = 4  # simulated storage nodes

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state) -> str:
        return self._write(step, [(k, _host(t, copy=False)) for k, t in flatten_with_path(state)])

    def save_async(self, step: int, state) -> threading.Thread:
        """Copy the state to host memory, then write on a background thread."""
        host = [(k, _host(t, copy=True)) for k, t in flatten_with_path(state)]
        t = threading.Thread(target=self._write, args=(step, host), daemon=True)
        t.start()
        return t

    def _write(self, step: int, host_leaves) -> str:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        by_node: dict[int, dict[str, np.ndarray]] = {}
        entries = {}
        for key, arr in host_leaves:
            node = _place(key, self.n_nodes)
            by_node.setdefault(node, {})[key] = arr
            entries[key] = node
        for node, arrays in by_node.items():
            _savez(os.path.join(tmp, f"node_{node}.npz"), arrays)
        manifest = {"step": step, "n_nodes": self.n_nodes, "engine": "binomial", "entries": entries}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> int | None:
        if not os.path.isdir(self.directory):
            return None
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                    steps.append(int(d.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int, like):
        """Restore into the structure of ``like`` (a tree of tensors: each
        leaf comes back with its template's dtype and device)."""
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data: dict[str, np.ndarray] = {}
        for node in set(manifest["entries"].values()):
            with np.load(os.path.join(d, f"node_{node}.npz")) as z:
                for k in z.files:
                    data[k] = z[k]
        return unflatten(like, [_tensor(data[key], tmpl) for key, tmpl in flatten_with_path(like)])

    # -- elastic storage ------------------------------------------------------
    def plan_resize(self, state_like, new_n_nodes: int):
        """Minimal movement plan for a storage-fleet resize:
        [(leaf key, source node, destination node)]."""
        moves = []
        for key, _ in flatten_with_path(state_like):
            src = _place(key, self.n_nodes)
            dst = _place(key, new_n_nodes)
            if src != dst:
                moves.append((key, src, dst))
        return moves
