"""Checkpointing with async write, in the JAX package's on-disk format.

The port of ``repro/checkpoint/checkpoint.py``.  Checkpoints are
Pilot-Data DataUnits in the persistent (file) tier: the trainer's state
tree is flattened to named leaves, each saved as one ``.npy`` file, with a
JSON manifest (step, and each leaf's file, shape and dtype).  The format
and the leaf names are the JAX package's, so a checkpoint written by one
package restores in the other bit for bit:

- a leaf's name is its path, joined by "/": dict keys, named-tuple
  fields, sequence indices, and a QTensor's/LogQTensor's child index
  (``opt_state/m/embed/0`` for an int8 moment's data);
- bf16 (and fp8) leaves are stored as the same-width unsigned integers,
  with the dtype named in the manifest ("bfloat16").  numpy has no bf16 of
  its own; the bits are moved as uint16, so no ``ml_dtypes`` is needed.

A sharded state (DTensor leaves, ``train.steps.shard_train_state``) is
saved whole: ``save`` gathers every leaf, a collective that every rank of
the mesh makes, and only the rank at the mesh's origin (rank 0 of the
mesh) writes, in the same format; the background writer runs no
collective.  A rank outside the state's mesh may not save it
(ValueError).  Another rank returns once the gather is done, so a rank that
reads the checkpoint back meets the writer at a barrier first.
``restore(like, step, shardings=)`` is the elastic re-mesh: each leaf
with a ``NamedSharding`` goes onto its (mesh, placements), each rank
reading only its own shard out of the file, so nothing is broadcast.  An
int8 moment's blocks (a ``NamedSharding`` with a ``shape``,
``train.steps.train_state_shardings``) are laid out by that shape first,
so a checkpoint of one layout restores into another
(``optim.quant.fit_blocks``).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.common import tree_leaves, tree_node, tree_unflatten
from repro_torch.optim.quant import fit_blocks
from repro_torch.parallel.sharding import from_local, local_slice, mesh_device

# dtypes numpy can't hold -> stored as a same-width unsigned integer view
_EXTENDED = {"bfloat16": (torch.bfloat16, np.uint16),
             "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
             "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_BY_TORCH = {t: (name, view) for name, (t, view) in _EXTENDED.items()}


def _encode(t: torch.Tensor):
    """A host copy of `t` as numpy, and the manifest's dtype name."""
    t = t.detach()
    t = (t.clone(memory_format=torch.contiguous_format)
         if t.device.type == "cpu" else t.cpu())
    if t.dtype in _BY_TORCH:
        name, view = _BY_TORCH[t.dtype]
        signed = {np.uint16: torch.int16, np.uint8: torch.int8}[view]
        return t.view(signed).numpy().view(view), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype: str, device: torch.device):
    if dtype in _EXTENDED:
        tdt, view = _EXTENDED[dtype]
        signed = {np.uint16: np.int16, np.uint8: np.int8}[view]
        return torch.from_numpy(arr.view(signed)).to(device).view(tdt)
    return torch.from_numpy(arr).to(device)


def _named(tree, prefix: str = "") -> Dict[str, Any]:
    """{leaf name: leaf} in `tree_leaves` order (see the module doc)."""
    node = tree_node(tree)
    if node is None:
        return {prefix: tree}
    children = node[0]
    if isinstance(tree, dict):
        names = sorted(tree)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        names = tree._fields
    else:
        names = range(len(children))
    out: Dict[str, Any] = {}
    for name, child in zip(names, children):
        out.update(_named(child, f"{prefix}/{name}" if prefix else str(name)))
    return out


class CheckpointManager:
    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async_thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.write_log: list = []

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def save(self, step: int, state, blocking: bool = True) -> Path:
        """Snapshot to host memory synchronously, write to disk (optionally
        in the background so the next train step overlaps the I/O)."""
        from torch.distributed.tensor import DTensor
        self.wait()  # never two writers in flight (same-step dir races)
        t0 = time.time()
        named = _named(state)
        meshes = [v.device_mesh for v in named.values()
                  if isinstance(v, DTensor)]
        if any(m.get_coordinate() is None for m in meshes):
            raise ValueError(
                "save: this rank holds no shard of the state's mesh (a rank "
                "that left the mesh saves nothing)")
        # the writer: the global rank at the mesh's origin
        writer = not meshes or (torch.distributed.get_rank()
                                == int(meshes[0].mesh.flatten()[0]))
        host = {}
        for k, v in named.items():         # one whole leaf at a time
            if isinstance(v, DTensor):
                v = v.full_tensor()
            if writer:
                host[k] = _encode(v)
            del v
        if not writer:
            return self._step_dir(step)
        snap_t = time.time() - t0

        def write():
            tw0 = time.time()
            d = self._step_dir(step)
            tmp = d.with_suffix(".tmp")
            tmp.mkdir(parents=True, exist_ok=True)
            manifest = {"step": step, "leaves": {}}
            nbytes = 0
            for key, (arr, dtype_name) in host.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(tmp / fname, arr)
                nbytes += arr.nbytes
                manifest["leaves"][key] = {"file": fname,
                                           "shape": list(arr.shape),
                                           "dtype": dtype_name}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if d.exists():
                shutil.rmtree(d)
            tmp.rename(d)
            self._gc()
            self.write_log.append({"step": step, "snapshot_s": snap_t,
                                   "write_s": time.time() - tw0,
                                   "bytes": nbytes})

        if blocking:
            write()
        else:
            def run():
                try:
                    write()
                except BaseException as e:        # raised again by wait()
                    self._error = e
            self._async_thread = threading.Thread(target=run, daemon=True)
            self._async_thread.start()
        return self._step_dir(step)

    def wait(self):
        """Join the background writer; re-raise what it raised."""
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def list_steps(self):
        """The steps written whole (not a ``.tmp`` directory a writer,
        maybe another rank's, is still filling)."""
        return [int(p.name.split("_")[1]) for p in self.root.glob("step_*")
                if p.is_dir() and p.name.split("_")[1].isdigit()]

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return max(steps) if steps else None

    # ------------------------------------------------------------------
    def restore(self, like, step: Optional[int] = None,
                device: DeviceLike = None, shardings=None):
        """Restore into the structure of `like` (a tree of tensors; its
        QTensors keep their shapes) -> (state, step).  `shardings` is a
        tree of that structure whose leaves are ``NamedSharding`` (the
        leaf becomes a DTensor on that mesh: this rank's shard, read out
        of the file) or None; a leaf without one goes to `device`, else to
        the device of `like`'s leaf."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        dev = None if device is None else resolve_device(device)
        named = _named(like)
        shs = (tree_leaves(shardings) if shardings is not None
               else [None] * len(named))
        if len(shs) != len(named):
            raise ValueError("restore: shardings and like differ in leaves")

        def load(name, leaf, sh):
            info = manifest["leaves"][name]
            if sh is None:
                return _decode(np.load(d / info["file"]), info["dtype"],
                               dev if dev is not None else leaf.device)
            arr = np.load(d / info["file"], mmap_mode="r")
            if sh.shape is not None:      # an int8 moment's blocks
                arr = fit_blocks(arr, sh.shape)
            # a copy: the rank's shard is read, and the tensor never maps
            # the file (AdamW writes its state in place)
            local = np.array(local_slice(arr, sh.mesh, sh.placements))
            return from_local(_decode(local, info["dtype"],
                                      mesh_device(sh.mesh)),
                              sh.mesh, sh.placements, arr.shape)

        return tree_unflatten(like, [
            load(name, leaf, sh)
            for (name, leaf), sh in zip(named.items(), shs)]), step
