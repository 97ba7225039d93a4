"""Sharded checkpointing with manifest + atomic commit + elastic restore.

The counterpart of ``repro.ckpt.checkpoint``, with the same layout on disk,
so a snapshot that one package writes, the other reads::

    <dir>/step_000100/
        manifest.json        # step, leaf names, shapes/dtypes, shard map
        shard_00000.npz      # one npz per host: its slice of every leaf
        _COMMITTED           # written last — restart scans for the newest
                             # committed step and ignores torn writes

A tree is a dict (or list, tuple) of numpy arrays, torch tensors or scalars.
Its leaves are named as ``jax.tree_util.keystr`` names them (``['x_ext']``,
dict keys sorted), so the manifests agree across packages.

* every host writes only its own slice of each leaf (axis 0 where it
  divides), so no bytes cross hosts;
* the manifest stores the *global* layout, so restoring onto another host
  count re-slices automatically (elastic re-shard);
* the commit marker is rename-based (atomic on POSIX): a torn checkpoint is
  invisible;
* writes can stream through a background thread (the solve goes on) —
  ``save(..., block=False)``.  A tensor leaf is copied to the host before
  the call returns, so the caller may go on changing it.
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.ft.inject import fire

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "load_flat", "CheckpointManager"]


def _write_fsync(path: Path, data):
    """Write + flush + fsync so a committed marker implies durable bytes."""
    mode = "wb" if isinstance(data, bytes) else "w"
    with open(path, mode) as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _walk(tree, prefix: str = ""):
    """``(name, leaf)`` pairs in jax's flattening order: dict keys sorted,
    sequences by index, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _walk(sub, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, leaves) for sub in tree)
    if tree is None:
        return None
    return next(leaves)


def _flatten_with_names(tree) -> tuple[list, list]:
    pairs = list(_walk(tree))
    return [n for n, _ in pairs], [leaf for _, leaf in pairs]


def _host(leaf) -> np.ndarray:
    """A leaf as a host array of its own (a CPU tensor's memory is copied)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(
    directory,
    step: int,
    tree,
    host_index: int = 0,
    n_hosts: int = 1,
    block: bool = True,
):
    """Save ``tree``; each host writes leaves sliced on axis 0 where possible.

    Returns the writer thread when ``block=False`` (None otherwise)."""
    directory = Path(directory)
    step_dir = directory / f"step_{step:09d}"
    # pid + thread in the staging name: concurrent savers (two managers, or a
    # restarted process racing a stale background writer) never share tmps
    tmp_dir = directory / (
        f".tmp_step_{step:09d}_{host_index}_{os.getpid()}_{threading.get_ident()}"
    )
    tmp_dir.mkdir(parents=True, exist_ok=True)
    step_dir.mkdir(parents=True, exist_ok=True)

    names, leaves = _flatten_with_names(tree)
    arrays = [_host(leaf) for leaf in leaves]
    host_arrays = {}
    shard_info = {}
    for name, arr in zip(names, arrays):
        if arr.ndim >= 1 and arr.shape[0] >= n_hosts and arr.shape[0] % n_hosts == 0:
            per = arr.shape[0] // n_hosts
            sl = arr[host_index * per : (host_index + 1) * per]
            shard_info[name] = {"axis": 0, "per_host": per}
        else:
            sl = arr if host_index == 0 else np.zeros((0,), arr.dtype)
            shard_info[name] = {"axis": None, "per_host": None}
        host_arrays[name] = sl

    def _write():
        kind = fire("ckpt.write", step=step)
        if kind == "eio":
            raise OSError(errno.EIO, f"injected EIO writing checkpoint step {step}")
        fn = tmp_dir / f"shard_{host_index:05d}.npz"
        np.savez(fn, **{n.replace("/", "|"): a for n, a in host_arrays.items()})
        with open(fn, "rb+") as f:
            os.fsync(f.fileno())
        fn.rename(step_dir / f"shard_{host_index:05d}.npz")
        if host_index == 0:
            manifest = {
                "step": step,
                "n_hosts": n_hosts,
                "time": time.time(),
                "leaves": {
                    n: {"shape": list(a.shape), "dtype": str(a.dtype), **shard_info[n]}
                    for n, a in zip(names, arrays)
                },
            }
            mf = tmp_dir / "manifest.json"
            _write_fsync(mf, json.dumps(manifest, indent=1))
            mf.rename(step_dir / "manifest.json")
            if kind == "torn":
                # emulate a kill between data and commit: shards + manifest
                # are on disk but _COMMITTED never lands, so restart skips it
                _cleanup(tmp_dir)
                return
            marker = tmp_dir / "_COMMITTED"
            _write_fsync(marker, "ok")
            marker.rename(step_dir / "_COMMITTED")
        _cleanup(tmp_dir)

    def _cleanup(d):
        for leftover in d.iterdir():
            leftover.unlink()
        d.rmdir()

    if block:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(directory) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in directory.iterdir()
        if p.name.startswith("step_") and (p / "_COMMITTED").exists()
    ]
    return max(steps) if steps else None


def load_flat(directory, step: int) -> dict:
    """``{name: ndarray}`` of every leaf of step ``step``, each host's shard
    joined (elastic: any host count); names, shapes and dtypes come from the
    manifest, so no like-tree is needed."""
    step_dir = Path(directory) / f"step_{step:09d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    shards = [np.load(step_dir / f"shard_{h:05d}.npz") for h in range(manifest["n_hosts"])]
    flat = {}
    for name, info in manifest["leaves"].items():
        key = name.replace("/", "|")
        if info["axis"] == 0:
            arr = np.concatenate([s[key] for s in shards], axis=0)
        else:
            arr = shards[0][key]
        flat[name] = np.asarray(arr).reshape(info["shape"]).astype(info["dtype"])
    return flat


def restore_checkpoint(directory, step: int, like_tree):
    """Restore into the structure of ``like_tree`` (elastic: any host count).

    The leaves come back as numpy arrays, as the reference returns them."""
    flat = load_flat(directory, step)
    names, leaves = _flatten_with_names(like_tree)
    out = []
    for name, leaf in zip(names, leaves):
        arr = flat[name]
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"{name}: {arr.shape} != {expect}")
        out.append(arr)
    return _rebuild(like_tree, iter(out))


class CheckpointManager:
    """Keep-last-k manager with async save and restart discovery."""

    def __init__(self, directory, keep: int = 3, host_index: int = 0, n_hosts: int = 1):
        self.directory = Path(directory)
        self.keep = keep
        self.host_index = host_index
        self.n_hosts = n_hosts
        self._pending: threading.Thread | None = None

    def save(self, step: int, tree, block: bool = False):
        self.wait()
        self._pending = save_checkpoint(
            self.directory, step, tree, self.host_index, self.n_hosts, block=block
        )
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, like_tree):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like_tree)

    def _gc(self):
        if self.host_index != 0:
            return
        steps = sorted(
            p
            for p in self.directory.iterdir()
            if p.name.startswith("step_") and (p / "_COMMITTED").exists()
        )
        for p in steps[: -self.keep]:
            for f in p.iterdir():
                f.unlink()
            p.rmdir()
