"""Checkpoint/restart: atomic manifest + per-array storage (port of
`repro.ckpt.checkpoint`).

Fault-tolerance contract, as in the reference:
  * a checkpoint is VALID iff its manifest exists — arrays are written to a
    tmp dir first, manifest last, then an atomic rename; a crash mid-write
    leaves the previous checkpoint untouched;
  * `latest_step` scans for the newest valid checkpoint (restart after
    preemption / node failure) and reclaims abandoned `.tmp` dirs;
  * eigensolver restart state (locked Ritz pairs + H + current block) is a
    few MB even for billion-vertex problems — the Krylov-restart
    compression IS the checkpoint compression (paper §3.4 observation).

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other: leaves are named and ordered as JAX's
`tree_flatten_with_path` names them (dict keys sorted, list and tuple
items by index, a NamedTuple's fields as ".field" (JAX's `GetAttrKey`;
`AdamWState` leaves are "1/.step", "1/.m/...", …), `None` subtrees
dropped, path parts joined with "/"),
stored as `a<i>` in one `arrays.npz`, with numpy's dtype name and the
shape of each leaf in the manifest. A bf16 leaf is stored as its raw
16-bit words (`uint16`) under the dtype name "bfloat16" and decoded
from those words on restore, with no numpy extension type for bf16.
Leaves may be torch tensors (on any device; copied to the host), numpy
arrays or Python scalars; `restore` returns torch tensors.

`restore(shardings=...)` is the reference's elastic reshard onto a
training mesh; it raises until the mesh side of training is ported
(ROADMAP.md queue 1 item 7).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import urllib.parse
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"


class CorruptSnapshotError(RuntimeError):
    """A committed page snapshot failed content verification (bit-rot or
    a torn copy in the checkpoint itself). The resume path treats it like
    an orphan: fall back to the next-older valid step."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ----------------------------------------------------------------- trees
def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _flatten_with_paths(tree: Any) -> Tuple[List[str], List[Any], Any]:
    """(names, leaves, treedef) in JAX's `tree_flatten_with_path` order.
    `treedef` is the tree itself, the template `_unflatten` refills."""
    names: List[str] = []
    leaves: List[Any] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif _is_namedtuple(node):
            for f, child in zip(node._fields, node):
                walk(child, path + ("." + f,))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
        else:
            names.append("/".join(path))
            leaves.append(node)

    walk(tree, ())
    return names, leaves, tree


def _unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(treedef)


def _map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    _, leaves, treedef = _flatten_with_paths(tree)
    return _unflatten(treedef, [fn(leaf) for leaf in leaves])


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array as stored in the npz, numpy's dtype name) of one leaf. bf16
    (a torch tensor, or numpy's bf16 extension type by its name) becomes
    its raw 16-bit words; other 1-byte extension types their bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    name = str(a.dtype)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), name
    if a.dtype.itemsize == 1 and a.dtype.kind == "V":
        return a.view(np.uint8), name
    return a, name


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored npz array as a CPU tensor of the manifest's type (0-d
    arrays stay 0-d)."""
    arr = np.require(arr, requirements="C")
    if dtype_name == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ------------------------------------------------------------ save / load
def save(root: str, step: int, tree: Any, *, extra: dict | None = None) -> str:
    """Write checkpoint atomically; returns final path."""
    final = os.path.join(root, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    names, leaves, _ = _flatten_with_paths(tree)
    host = [_host(leaf) for leaf in leaves]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, (a, _) in enumerate(host)})
    manifest = {
        "step": step,
        "names": names,
        "dtypes": [name for _, name in host],
        "shapes": [list(a.shape) for a, _ in host],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def valid_steps(root: str) -> list[int]:
    """All committed checkpoint steps under root, ascending. A step is
    committed iff its final dir exists with a manifest; `.tmp` dirs (a
    crash mid-save) are never valid."""
    if not os.path.isdir(root):
        return []
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(root, d, MANIFEST)):
                steps.append(int(d.split("_")[1]))
    return sorted(steps)


def latest_step(root: str, *, gc_stale_tmp: bool = True,
                tmp_grace_seconds: float = 3600.0) -> int | None:
    """Newest committed checkpoint step (None if no valid checkpoint).

    `step_*.tmp` dirs are a crash mid-`save` — never valid, and left
    behind forever by a killed writer. Any tmp older than
    `tmp_grace_seconds` is removed here (the grace keeps a *live*
    writer's in-flight tmp safe, e.g. an AsyncWriter elsewhere)."""
    if not os.path.isdir(root):
        return None
    if gc_stale_tmp:
        now = time.time()
        for d in os.listdir(root):
            if not (d.startswith("step_") and d.endswith(".tmp")):
                continue
            p = os.path.join(root, d)
            try:
                age = now - os.path.getmtime(p)
            except OSError:
                continue        # raced with its writer's rename/cleanup
            if age >= tmp_grace_seconds:
                shutil.rmtree(p, ignore_errors=True)
    steps = valid_steps(root)
    return max(steps) if steps else None


def restore(root: str, step: int, like: Any, *, shardings: Any = None
            ) -> tuple[Any, dict]:
    """Restore into the structure of `like`: every leaf a torch tensor of
    the stored type, on the device of `like`'s leaf where that is a
    tensor, else on the CPU. Returns (tree, extra)."""
    if shardings is not None:
        raise NotImplementedError(
            "restore(shardings=...) is the elastic reshard of training, "
            "not ported yet: ROADMAP.md queue 1 item 7")
    path = os.path.join(root, f"step_{step:010d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    names, leaves, treedef = _flatten_with_paths(like)
    if names != manifest["names"]:
        raise ValueError("checkpoint structure mismatch: "
                         f"{set(names) ^ set(manifest['names'])}")
    new_leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, leaf in enumerate(leaves):
            t = _decode(z[f"a{i}"], manifest["dtypes"][i])
            if isinstance(leaf, torch.Tensor):
                t = t.to(leaf.device)
            new_leaves.append(t)
    return _unflatten(treedef, new_leaves), manifest["extra"]


def gc_old(root: str, keep: int = 3) -> None:
    """Keep the newest `keep` valid checkpoints."""
    for s in valid_steps(root)[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:010d}"), ignore_errors=True)


# -------------------------------------------------------- SAFS page snapshots
def save_safs(root: str, step: int, store, *, extra: dict | None = None
              ) -> str:
    """Snapshot a safs-backed TieredStore's page files — no RAM round-trip.

    The subspace already lives on disk as SAFS page files (§3.4.1), so the
    checkpoint is a flush (journaled write-back of dirty pages) plus a
    kernel-side file copy of each page file and its sidecars (shape
    metadata AND the checksum block — the snapshot stays self-verifying)
    into the checkpoint dir. The manifest records a sha256 content hash
    per page file, so `verify_safs_snapshot` can prove a snapshot clean
    before it is trusted as a resume or repair source. Same atomic-
    manifest contract as `save`; use a separate checkpoint root from tree
    checkpoints — `restore` and `restore_safs` are not interchangeable.
    With write-behind on, a failed retire surfaces here as
    `WriteBehindError` at the flush barrier.
    """
    from repro_torch.core.tiered import DEVICE
    from repro_torch.safs.backend import SafsBackend
    backend = getattr(store, "backend", store)
    if not isinstance(backend, SafsBackend):
        raise TypeError("save_safs needs a safs-backed store; got "
                        f"{type(backend).__name__}")
    # Device-tier entries with no current host copy (the newest subspace
    # block is pinned on device per §3.4.4) are written through first, or
    # the snapshot would miss them; residency is unchanged
    sync = getattr(store, "sync_device_entries", None)
    if sync is not None:
        sync()
    else:       # a bare backend passed as `store` has no device tier
        for e in getattr(store, "_entries", {}).values():
            if e.tier == DEVICE and (e.dirty or not e.has_host):
                backend.store(e.data_id, e.device_val)
                e.has_host, e.dirty = True, False
    backend.flush()
    final = os.path.join(root, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    # the store's OWN ids, not backend.data_ids(): on a shared backend a
    # store's checkpoint must not capture other stores' page files
    own_ids = getattr(store, "data_ids", None)
    data_ids = own_ids() if own_ids is not None else backend.data_ids()
    hashes = {}
    for data_id in data_ids:
        pf = backend.pagefile(data_id)
        for src in (pf.path, pf.path + ".meta", pf.path + ".sums"):
            if os.path.exists(src):
                shutil.copyfile(src,
                                os.path.join(tmp, os.path.basename(src)))
        # content hash of the COPY — what a later resume must verify
        hashes[data_id] = _sha256_file(
            os.path.join(tmp, os.path.basename(pf.path)))
    manifest = {"step": step, "kind": "safs_pages", "data_ids": data_ids,
                "page_size": backend.page_size, "hashes": hashes,
                "extra": extra or {}}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def verify_safs_snapshot(path: str) -> list[str]:
    """Content-verify a committed page snapshot against its manifest:
    every data_id's page file present (with metadata) and matching its
    recorded sha256. Returns the list of problems (empty == verified).
    Manifests without hashes verify on presence alone."""
    problems: list[str] = []
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable manifest: {e}"]
    if manifest.get("kind") != "safs_pages":
        return [f"not a safs page snapshot: {path}"]
    hashes = manifest.get("hashes") or {}
    for data_id in manifest.get("data_ids", []):
        fp = os.path.join(path,
                          urllib.parse.quote(data_id, safe="") + ".pages")
        if not (os.path.exists(fp) and os.path.exists(fp + ".meta")):
            problems.append(f"missing page file for {data_id!r}")
            continue
        want = hashes.get(data_id)
        if want is not None and _sha256_file(fp) != want:
            problems.append(f"content hash mismatch for {data_id!r}")
    return problems


def restore_safs(root: str, step: int, dest_root: str, *,
                 verify: bool = True):
    """Rehydrate a page snapshot into a fresh SafsBackend at dest_root.

    Copies the page files back (kernel-side) and reopens them; returns
    (backend, extra). Pages are faulted in lazily through the page cache
    on first access. With `verify` (default) the snapshot's content
    hashes are checked first and a mismatch raises
    `CorruptSnapshotError` instead of rehydrating rot.
    """
    from repro_torch.safs.backend import SafsBackend
    path = os.path.join(root, f"step_{step:010d}")
    if verify:
        problems = verify_safs_snapshot(path)
        if problems:
            raise CorruptSnapshotError("; ".join(problems))
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("kind") != "safs_pages":
        raise ValueError(f"not a safs page snapshot: {path}")
    os.makedirs(dest_root, exist_ok=True)
    for fname in os.listdir(path):
        if (fname.endswith(".pages") or fname.endswith(".pages.meta")
                or fname.endswith(".pages.sums")):
            shutil.copyfile(os.path.join(path, fname),
                            os.path.join(dest_root, fname))
    backend = SafsBackend(dest_root, page_size=manifest["page_size"])
    return backend, manifest["extra"]


def _snapshot_leaf(leaf: Any) -> Any:
    """A host copy of one leaf that later writes to the original cannot
    change (torch tensors are mutable, unlike JAX arrays)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncWriter:
    """Overlap checkpoint writes with compute (one in flight at a time)."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None

    def submit(self, root: str, step: int, tree: Any,
               extra: dict | None = None) -> None:
        self.wait()
        host_tree = _map_leaves(_snapshot_leaf, tree)

        def _run():
            self.last_path = save(root, step, host_tree, extra=extra)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
