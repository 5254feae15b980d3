"""Atomic, asynchronous, sharded checkpoints (counterpart of
``repro/train/checkpoint.py``).

* Shard-wise: each rank writes the blocks it owns into
  ``step_<N>/shard_<rank>.npz`` and ``manifest_<rank>.json``: every leaf's
  path, global shape and dtype, and each block's key and global index
  (``[[start, stop, step], ...]`` a dimension, ``_index_desc``, or null
  for a whole leaf).  A DTensor leaf contributes its local block from the
  rank that holds replica 0 of it; a plain leaf is written whole, by rank
  0 only.
* Atomic: the files go to ``step_<N>.tmp/``, which is renamed to
  ``step_<N>/`` only after every rank's manifest is fsynced (one rank: at
  once; several: rank 0 renames after a barrier, in ``wait``), so a crash
  mid-write never damages the latest complete checkpoint;
  ``latest_step`` skips partial writes.
* Async: ``save_async`` copies the blocks to host memory on the calling
  thread, then writes them on a background thread; ``wait`` joins it
  (and commits a mesh's step).
* Elastic restore: ``restore`` reads every rank's manifest and shard
  file, assembles each leaf whole and places it on the *current* layout:
  a DTensor leaf of the target takes its own block (on its mesh, which
  may have another shape or device count than the one that saved), a
  plain tensor leaf the whole value, in place; with ``shardings`` and
  ``mesh`` a plain leaf comes back as a DTensor placed by its Sharding.

A tree is a nested dict whose leaves are tensors, DTensors or numbers.
bf16 tensors are stored as their raw 16-bit words (numpy has no bf16).
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import local_index

_SEP = "|"          # path separator inside npz keys ('/' is not npz-safe)


def _path(prefix: str, key) -> str:
    return f"{prefix}{_SEP}{key}" if prefix else str(key)


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flatten(tree[k], _path(prefix, k))]
    return [(prefix, tree)]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), _dtype_name(t)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _dtensor_cls():
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def _replica0(mesh, placements) -> bool:
    """Whether this rank holds replica 0 of a DTensor: its coordinate is 0
    along every mesh dim that does not shard it."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    return all(isinstance(pl, Shard) or coord[m] == 0
               for m, pl in enumerate(placements))


def _index_desc(index) -> Any:
    """Serialize a tuple-of-slices block index to JSON-able form."""
    if index is None:
        return None
    return [[s.start, s.stop, s.step] for s in index]


def _desc_to_index(desc, shape) -> Any:
    if desc is None:
        return tuple(slice(None) for _ in shape)
    return tuple(slice(a, b, c) for a, b, c in desc)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        """The rank and world are the process group's (0 and 1 without
        one); every rank of a world must write the same steps."""
        import torch.distributed as dist
        group = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if group else 0
        self.world = dist.get_world_size() if group else 1
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None

    # ------------------------------ save ------------------------------

    def save(self, step: int, tree: Any) -> None:
        """Copy to host, then write and commit."""
        self.wait()                      # one write in flight at a time
        self._write(step, self._host(tree))
        self._pending = step
        self.wait()

    def save_async(self, step: int, tree: Any) -> None:
        """Copy to host on this thread, then write on a background one;
        ``wait`` (or the next save) commits."""
        self.wait()
        self._pending = step
        self._thread = threading.Thread(
            target=self._write_guard, args=(step, self._host(tree)),
            daemon=True)
        self._thread.start()

    def _host(self, tree: Any) -> list:
        """[(path, global shape, dtype, [(index desc, array), ...])]: the
        blocks this rank writes."""
        DT = _dtensor_cls()
        out = []
        for path, leaf in _flatten(tree):
            if DT is not None and isinstance(leaf, DT):
                blocks = []
                if _replica0(leaf.device_mesh, leaf.placements):
                    idx = local_index(leaf.shape, leaf.device_mesh,
                                      leaf.placements)
                    arr, dtype = _to_host(leaf.to_local())
                    blocks.append((_index_desc(idx), arr))
                else:
                    dtype = _dtype_name(leaf)
                out.append((path, tuple(leaf.shape), dtype, blocks))
                continue
            if isinstance(leaf, torch.Tensor):
                arr, dtype = _to_host(leaf)
            else:
                arr = np.asarray(leaf)
                dtype = str(arr.dtype)
            out.append((path, tuple(arr.shape), dtype,
                        [(None, arr)] if self.rank == 0 else []))
        return out

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self._pending is not None:
            step, self._pending = self._pending, None
            self._commit(step)

    def _write_guard(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _write(self, step: int, host) -> None:
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        os.makedirs(tmp, exist_ok=True)
        arrays = {}
        manifest = {"step": step, "time": time.time(), "world": self.world,
                    "leaves": []}
        for path, shape, dtype, blocks in host:
            # keys name the rank: every rank's file is read into one dict
            keys = [f"{path}{_SEP}{self.rank}#{i}" for i in range(len(blocks))]
            arrays.update((k, arr) for k, (_, arr) in zip(keys, blocks))
            manifest["leaves"].append({
                "path": path, "shape": list(shape), "dtype": dtype,
                "shards": [{"key": k, "index": idx}
                           for k, (idx, _) in zip(keys, blocks)]})
        np.savez(os.path.join(tmp, f"shard_{self.rank:05d}.npz"), **arrays)
        with open(os.path.join(tmp, f"manifest_{self.rank:05d}.json"),
                  "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())

    def _commit(self, step: int) -> None:
        """Rename the step's directory once every rank has written (rank 0
        renames, between two barriers on the default group)."""
        import torch.distributed as dist
        if self.world > 1:
            dist.barrier()
        if self.rank == 0:
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.rename(final + ".tmp", final)
            self._gc()
        if self.world > 1:
            dist.barrier()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----------------------------- restore ----------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: int) -> Dict[str, Tuple[np.ndarray, str]]:
        """{leaf path: (the whole array, dtype name)} of a saved step,
        assembled from every rank's blocks."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        meta: Dict[str, dict] = {}
        arrays: Dict[str, np.ndarray] = {}
        for fn in sorted(os.listdir(d)):
            if fn.startswith("manifest_"):
                with open(os.path.join(d, fn)) as f:
                    for leaf in json.load(f)["leaves"]:
                        m = meta.setdefault(leaf["path"], dict(leaf,
                                                               shards=[]))
                        m["shards"] += leaf["shards"]
            elif fn.startswith("shard_") and fn.endswith(".npz"):
                with np.load(os.path.join(d, fn)) as z:
                    arrays.update({k: z[k] for k in z.files})
        out = {}
        for path, m in meta.items():
            if not m["shards"]:
                raise KeyError(f"checkpoint holds no block of {path!r}")
            first = arrays[m["shards"][0]["key"]]
            full = np.zeros(m["shape"], dtype=first.dtype)
            for sh in m["shards"]:
                full[_desc_to_index(sh["index"], m["shape"])] = \
                    arrays[sh["key"]]
            out[path] = (full, m["dtype"])
        return out

    def restore(self, step: int, target: Any, shardings: Any = None,
                mesh=None) -> Any:
        """The saved tree in ``target``'s structure, placed on the current
        layout.  A DTensor leaf of ``target`` gets its own block of the
        saved value, a tensor leaf the whole of it, each in place (on its
        device) and returned; with ``shardings`` (a tree of
        ``sharding.Sharding`` over ``target``'s paths) and ``mesh``, a
        tensor leaf comes back as a new DTensor placed by its Sharding.
        Number leaves come back as Python numbers."""
        saved = self.load(step)
        DT = _dtensor_cls()

        def sharding_of(prefix):
            node = shardings
            for k in prefix.split(_SEP):
                if not isinstance(node, dict) or k not in node:
                    return None
                node = node[k]
            return node

        def rebuild(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, _path(prefix, k))
                        for k, v in tree.items()}
            if prefix not in saved:
                raise KeyError(f"checkpoint missing leaf {prefix!r}")
            arr, dtype = saved[prefix]
            if DT is not None and isinstance(tree, DT):
                idx = local_index(tree.shape, tree.device_mesh,
                                  tree.placements)
                with torch.no_grad():
                    tree.to_local().copy_(_from_host(arr[idx], dtype))
                return tree
            if isinstance(tree, torch.Tensor):
                sh = sharding_of(prefix) if mesh is not None else None
                if sh is not None and sh.placements is not None:
                    from torch.distributed.tensor import DTensor
                    idx = local_index(arr.shape, mesh, sh.placements)
                    local = _from_host(arr[idx], dtype).to(tree.device)
                    return DTensor.from_local(local, mesh, sh.placements,
                                              run_check=False)
                with torch.no_grad():
                    tree.copy_(_from_host(arr, dtype))
                return tree
            return arr.item() if arr.ndim == 0 else arr

        return rebuild(target)
