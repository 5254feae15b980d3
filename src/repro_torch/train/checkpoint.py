"""Atomic, asynchronous checkpoints on one device (counterpart of
``repro/train/checkpoint.py``).

* Atomic: a write goes to ``step_<N>.tmp/`` (the arrays in ``shard.npz``,
  the paths, shapes and dtypes in ``manifest.json``) and is renamed to
  ``step_<N>/`` only after the manifest is fsynced, so a crash mid-write
  never damages the latest complete checkpoint; ``latest_step`` skips
  partial writes.
* Async: ``save_async`` copies the tensors to host memory on the calling
  thread, then writes them on a background thread; ``wait`` joins it.
* ``restore`` copies the saved values into the target tree's tensors, on
  their device (the model's).

A tree is a nested dict whose leaves are tensors or numbers.  bf16 tensors
are stored as their raw 16-bit words (numpy has no bf16).  One device
only: the elastic reshard across a changed device count waits for
multi-GPU (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "|"          # path separator inside npz keys ('/' is not npz-safe)


def _path(prefix: str, key) -> str:
    return f"{prefix}{_SEP}{key}" if prefix else str(key)


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flatten(tree[k], _path(prefix, k))]
    return [(prefix, tree)]


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------ save ------------------------------

    def save(self, step: int, tree: Any) -> None:
        """Copy to host, then write."""
        self.wait()                      # one write in flight at a time
        self._write(step, self._host(tree))

    def save_async(self, step: int, tree: Any) -> None:
        """Copy to host on this thread, then write on a background one."""
        self.wait()
        self._thread = threading.Thread(
            target=self._write_guard, args=(step, self._host(tree)),
            daemon=True)
        self._thread.start()

    @staticmethod
    def _host(tree: Any) -> list:
        return [(path, *_to_host(leaf)) for path, leaf in _flatten(tree)]

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_guard(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _write(self, step: int, host) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "leaves": [
            {"path": path, "shape": list(arr.shape), "dtype": dtype}
            for path, arr, dtype in host]}
        np.savez(os.path.join(tmp, "shard.npz"),
                 **{path: arr for path, arr, _ in host})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        self._gc()

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

    def restore(self, step: int, target: Any) -> Any:
        """The saved tree in ``target``'s structure: tensor leaves of
        ``target`` are overwritten in place (on their device) and returned;
        number leaves come back as Python numbers."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = {leaf["path"]: leaf for leaf in json.load(f)["leaves"]}
        with np.load(os.path.join(d, "shard.npz")) as z:
            arrays = {k: z[k] for k in z.files}

        def rebuild(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, _path(prefix, k))
                        for k, v in tree.items()}
            if prefix not in meta:
                raise KeyError(f"checkpoint missing leaf {prefix!r}")
            arr, dtype = arrays[prefix], meta[prefix]["dtype"]
            if isinstance(tree, torch.Tensor):
                with torch.no_grad():
                    tree.copy_(_from_host(arr, dtype))
                return tree
            return arr.item() if arr.ndim == 0 else arr

        return rebuild(target)
