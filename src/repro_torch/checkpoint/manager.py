"""Checkpointing: atomic, async, keep-K, restore onto any device.

  * **atomic** — write to step_N.tmp, then rename; a crash mid-save
    never corrupts the latest good checkpoint.
  * **async** — `save()` copies the state to host memory synchronously
    and writes it in a background thread, overlapping the next steps; a
    write error is raised by the next `wait()` or `save()`.
  * **restore onto a new placement** — arrays are stored whole (npz)
    under their tree paths; `restore(..., device=...)` loads them onto
    whatever device the new job names.
  * **keep-K** + a `latest` pointer file for the launcher's auto-resume.
  * the guard state and the optimizer's step count are part of the
    state tree, so resume replays the exact stream (TokenStream is
    step-indexable).

numpy has no bfloat16 (nor float8): such a tensor is stored as its raw
words (int16 / uint8) and its dtype recorded in `meta.json` under
"dtypes", so it comes back bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map, tree_paths

__all__ = ["CheckpointManager"]

SEP = "|"
# dtypes numpy cannot hold, stored as raw words of the same width
_RAW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
        torch.float8_e5m2: torch.uint8}


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host copies of the leaves by path key, and the torch dtype of
    each leaf stored as raw words."""
    flat, raw = {}, {}
    for path, leaf in tree_paths(tree):
        key = SEP.join(path)
        t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
        if t.dtype in _RAW:
            raw[key] = str(t.dtype).removeprefix("torch.")
            flat[key] = t.view(_RAW[t.dtype]).numpy()
        else:
            flat[key] = t.numpy()
    return flat, raw


def _leaf(key: str, arr: np.ndarray, raw: Dict[str, str]) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(getattr(torch, raw[key])) if key in raw else t


def _unflatten(template, flat: Dict[str, np.ndarray], raw: Dict[str, str],
               device):
    leaves = []
    for path, tmpl in tree_paths(template):
        key = SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        tmpl = torch.as_tensor(tmpl)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"template {tuple(tmpl.shape)}")
        dev = tmpl.device if device is None else device
        leaves.append(_leaf(key, arr, raw).to(device=dev,
                                              dtype=tmpl.dtype))
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------- save --
    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        """Snapshot now; write in background (unless async_save=False)."""
        self.wait()  # one in-flight save at a time
        host, raw = _flatten(state)  # device->host copy happens here
        meta = {"step": int(step), "time": time.time(),
                "extra": extra or {}, "dtypes": raw}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: Dict[str, np.ndarray], meta: dict):
        try:
            final = os.path.join(self.dir, f"step_{step:010d}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
                f.write(os.path.basename(final))
            os.replace(os.path.join(self.dir, "latest.tmp"),
                       os.path.join(self.dir, "latest"))
            self._gc()
        except Exception as e:  # surfaced on next wait()/save()
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, template: Any, step: Optional[int] = None,
                device=None):
        """Load into `template`'s structure, each leaf in the template
        leaf's dtype, on `device` (default: the template leaf's)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        tree = _unflatten(template, flat, meta.get("dtypes", {}), device)
        return tree, meta
