"""Simulated durable storage and the detectable checkpoint manager.

Copies of ``SimFS``, ``FaultInjector``, ``CrashNow`` and
``DFCCheckpointManager`` of the JAX package's
``checkpoint/dfc_checkpoint.py`` (that module imports JAX, so the port keeps
its own).  ``SimFS`` buffers writes in memory and puts them on disk only at
``fsync`` (pwb = write, pfence = fsync); a crash drops the unsynced buffers.
Every persistence op runs its hooks in the reference's order -- ``stats``,
then ``pstats``, then ``injector.tick``, then the durable work, then the
observer -- so a ``FaultInjector(crash_at=k)`` stops both packages at the
same op of the same schedule.

``DFCCheckpointManager`` is the paper's protocol as a checkpoint manager:
per-worker double-buffered announcements (``tAnn/worker_{w}/ann{0,1}.json``
+ ``valid``), two alternating slots (``top/slot{0,1}``) picked by the parity
of a two-increment ``cEpoch``, one slot persist for every ready
announcement, and recovery that rounds an odd epoch up, collects the slot
pool and reports per worker whether its step committed.  A state tree
flattens as the JAX pytree does (a structure state in field order, dict
entries in sorted key order, lists and tuples in order), and each leaf is
saved with ``np.save``'s bytes in its own dtype (a bf16 tensor as the
reference's bf16 leaf: raw 16 bits under a ``<V2`` header, ``"bfloat16"`` in
the manifest), so both packages write the same bytes.  A tensor leaf's file
is built in one buffer, copied once from the tensor wherever it lies, and a
leaf is read back into one writable buffer that its array views.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.torch_dfc import STRUCTS, struct_kind
from repro_torch.nvm.memory import PersistStats
from repro_torch.obs import NULL_OBS
from repro_torch.tree import tree_flatten


class CrashNow(Exception):
    """Raised by FaultInjector at the scheduled persistence op."""


@dataclasses.dataclass
class FaultInjector:
    """Crash at the k-th persistence operation (pwb or pfence)."""

    crash_at: Optional[int] = None
    count: int = 0

    def tick(self):
        self.count += 1
        if self.crash_at is not None and self.count >= self.crash_at:
            raise CrashNow(f"injected crash at persistence op {self.count}")


class SimFS:
    """Buffered filesystem: content reaches disk only at fsync (pwb=write,
    pfence=fsync).  Crash drops unsynced buffers.

    Persistence ops carry an optional attribution ``tag`` (announce, slot,
    resp, epoch, ...) counted into ``pstats``, a :class:`PersistStats`
    partitioning the ``stats`` totals by protocol step.
    """

    def __init__(self, root: Path, injector: Optional[FaultInjector] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.pending: Dict[str, bytes] = {}
        self.injector = injector or FaultInjector()
        self.stats = {"pwb": 0, "pfence": 0}
        self.pstats = PersistStats()
        self.obs = NULL_OBS

    def _p(self, rel: str) -> Path:
        return self.root / rel

    def write(self, rel: str, data: bytes, tag: Optional[str] = None) -> None:
        """pwb: buffered write — NOT durable until fsync."""
        self.stats["pwb"] += 1
        self.pstats.count_pwb(tag)
        self.injector.tick()
        self.pending[rel] = data
        self.obs.on_pwb(rel, tag)

    def fsync(self, rels: Optional[List[str]] = None, tag: Optional[str] = None) -> None:
        """pfence: flush pending writes to the real filesystem."""
        self.stats["pfence"] += 1
        self.pstats.count_pfence(tag)
        self.injector.tick()
        items = (
            list(self.pending.items())
            if rels is None
            else [(r, self.pending[r]) for r in rels if r in self.pending]
        )
        for rel, data in items:
            p = self._p(rel)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)
            self.pending.pop(rel, None)
        self.obs.on_pfence(rels, tag)

    def read(self, rel: str) -> Optional[bytes]:
        """Reads see the buffered (volatile) view, like a CPU cache."""
        if rel in self.pending:
            return self.pending[rel]
        p = self._p(rel)
        return p.read_bytes() if p.exists() else None

    def read_durable(self, rel: str) -> Optional[bytes]:
        p = self._p(rel)
        return p.read_bytes() if p.exists() else None

    def read_durable_buffer(self, rel: str) -> Optional[bytearray]:
        """:meth:`read_durable`'s bytes in a writable buffer, read into it
        directly (a leaf's array can then view them)."""
        p = self._p(rel)
        if not p.exists():
            return None
        with open(p, "rb", buffering=0) as f:
            buf = bytearray(os.fstat(f.fileno()).st_size)
            view, n = memoryview(buf), 0
            while n < len(buf):
                got = f.readinto(view[n:])
                if not got:
                    raise OSError(f"{p}: short read ({n} of {len(buf)} bytes)")
                n += got
        return buf

    def exists(self, rel: str) -> bool:
        return rel in self.pending or self._p(rel).exists()

    def listdir(self, rel: str) -> List[str]:
        p = self._p(rel)
        disk = [f"{rel}/{x}" for x in os.listdir(p)] if p.exists() else []
        buf = [k for k in self.pending if k.startswith(rel + "/")]
        return sorted(set(disk) | set(buf))

    def delete(self, rel: str) -> None:
        self.pending.pop(rel, None)
        p = self._p(rel)
        if p.exists():
            p.unlink()

    def crash(self) -> "SimFS":
        """Lose all unsynced writes; return a fresh post-crash view."""
        return SimFS(self.root, FaultInjector())


BOT = None  # the paper's ⊥: an announcement whose response is not yet written


def tree_leaves(tree) -> List[Any]:
    """The leaves of a state tree in the JAX pytree's flatten order (a
    structure state's fields in order, a dict's entries by sorted key, lists
    and tuples in order, ``None`` no leaf): tensors detached where they lie,
    anything else as a numpy array."""
    if hasattr(tree, "leaves") and dataclasses.is_dataclass(tree):
        return [_leaf(x) for x in tree.leaves()]
    return [_leaf(x) for x in tree_flatten(tree)]


def _leaf(x):
    if torch.is_tensor(x):
        return x.detach()
    return np.asarray(x)


def _npy(leaf) -> Tuple[bytes, List[int], str]:
    """``np.save``'s bytes of one leaf, its shape and its dtype's name, as
    the reference writes them.  A bf16 tensor is written as JAX hands numpy
    its bf16 leaves: the raw 16 bits under the header ``'descr': '<V2'``,
    named ``"bfloat16"`` in the manifest (numpy has no bf16 type of its
    own; the reference's ``ml_dtypes`` bf16 saves so).  A tensor's bytes
    are np.save's header (numpy's own version 1.0 header, which np.save
    writes for these) and the tensor's C-order bytes, copied once into one
    buffer from wherever the tensor lies."""
    if not torch.is_tensor(leaf):
        buf = io.BytesIO()
        np.save(buf, leaf)
        return buf.getvalue(), list(leaf.shape), str(leaf.dtype)
    t = leaf.contiguous()
    if t.dtype == torch.bfloat16:
        descr, name = "<V2", "bfloat16"
    else:
        npd = np.dtype(str(t.dtype).removeprefix("torch."))
        descr, name = np.lib.format.dtype_to_descr(npd), str(npd)
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, {"descr": descr, "fortran_order": False, "shape": tuple(t.shape)})
    h = head.getvalue()  # a multiple of 64 bytes: the data stays aligned
    out = bytearray(len(h) + t.numel() * t.element_size())
    out[:len(h)] = h
    if t.numel():
        torch.frombuffer(out, dtype=torch.uint8, offset=len(h)).view(t.dtype).view(
            t.shape).copy_(t)
    return out, list(t.shape), name


def leaf_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A leaf that ``load_active`` read, as a tensor on ``device``, typed by
    its manifest ``dtype``: a ``"bfloat16"`` leaf (numpy reads its ``<V2``
    header as raw 2-byte voids) is viewed as bf16, bit for bit."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        if str(arr.dtype) != dtype:
            raise ValueError(f"leaf of dtype {arr.dtype}, the manifest says {dtype}")
        # the loader's writable view needs no copy
        t = torch.from_numpy(arr if arr.flags.writeable and arr.flags.c_contiguous
                             else np.array(arr))
    return t.to(device)


def _load(data) -> np.ndarray:
    """The array of an ``.npy`` file's bytes, as ``np.load`` reads it: a
    view of ``data`` (writable where ``data`` is, as the buffers of
    ``read_durable_buffer`` are), with no copy.  Only the header goes
    through a file object (``io.BytesIO`` copies a bytearray it is given:
    a second copy of every leaf)."""
    view = memoryview(data)
    version = np.lib.format.read_magic(io.BytesIO(view[:8]))
    width = 2 if version == (1, 0) else 4  # the header length's bytes
    start = 8 + width + int.from_bytes(view[8:8 + width], "little")
    f = io.BytesIO(view[:start])
    np.lib.format.read_magic(f)
    shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f) if version == (1, 0)
                             else np.lib.format.read_array_header_2_0(f))
    count = int(np.prod(shape))
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=start)
    return arr.reshape(shape, order="F" if fortran else "C")


def _read_leaves(fs: SimFS, slot: str, entries) -> List[np.ndarray]:
    """The durable leaves a manifest lists."""
    return [_load(fs.read_durable_buffer(f"{slot}/{e['file']}")) for e in entries]


class DFCCheckpointManager:
    """Detectable flat-combining checkpoint manager (one per job).

    Workers call ``announce(worker, payload)``; the coordinator calls
    ``combine(state)``, which persists one combined checkpoint for every
    ready announcement and publishes it with the two-increment epoch
    commit.  ``recover()`` fixes the epoch, garbage-collects the slot pool,
    re-commits pending announcements (with the caller's state getter) and
    returns each worker's detectability verdict.
    """

    def __init__(self, fs: SimFS, n_workers: int, prefix: str = ""):
        """``prefix`` roots every durable path of this manager under a
        subdirectory of ``fs``, so several managers (a sharded fabric and
        its reshard donor snapshots) share one SimFS and one fault sweep."""
        self.fs = fs
        self.n = n_workers
        self.prefix = prefix if (not prefix or prefix.endswith("/")) else prefix + "/"

    def _rel(self, rel: str) -> str:
        return self.prefix + rel

    # ------------------------------------------------------------- epoch I/O
    def _read_epoch(self) -> int:
        raw = self.fs.read(self._rel("cEpoch"))
        return int(raw.decode()) if raw else 0

    def _write_epoch(self, v: int, sync: bool) -> None:
        self.fs.write(self._rel("cEpoch"), str(v).encode())
        if sync:
            self.fs.fsync([self._rel("cEpoch")])

    # ---------------------------------------------------------- announcements
    def _ann_path(self, w: int, slot: int) -> str:
        return self._rel(f"tAnn/worker_{w}/ann{slot}.json")

    def _valid_path(self, w: int) -> str:
        return self._rel(f"tAnn/worker_{w}/valid")

    def _read_valid(self, w: int) -> int:
        raw = self.fs.read(self._valid_path(w))
        return int(raw.decode()) if raw else 0

    def _read_ann(self, w: int, slot: int) -> Dict[str, Any]:
        raw = self.fs.read(self._ann_path(w, slot))
        return json.loads(raw.decode()) if raw else {"val": BOT, "epoch": -1}

    def announce(self, worker: int, payload: Dict[str, Any]) -> None:
        """Worker-side announcement (paper lines 2-12), parallel pwb/pfence."""
        epoch = self._read_epoch()
        if epoch % 2 == 1:
            epoch += 1
        valid = self._read_valid(worker)
        n_op = 1 - (valid & 1)
        ann = dict(payload, val=BOT, epoch=epoch)
        self.fs.write(self._ann_path(worker, n_op), json.dumps(ann).encode())
        self.fs.fsync([self._ann_path(worker, n_op)])  # L9
        self.fs.write(self._valid_path(worker), str(n_op).encode())
        self.fs.fsync([self._valid_path(worker)])  # L11
        self.fs.write(self._valid_path(worker), str(2 | n_op).encode())  # L12 MSB

    def ready_announcements(self) -> List[int]:
        out = []
        for w in range(self.n):
            v = self._read_valid(w)
            if (v >> 1) & 1:
                ann = self._read_ann(w, v & 1)
                if ann.get("val") is BOT and ann.get("step") is not None:
                    out.append(w)
        return out

    # ---------------------------------------------------------------- combine
    def _slot_dir(self, epoch: int, nxt: bool) -> str:
        idx = (epoch // 2 + (1 if nxt else 0)) % 2
        return self._rel(f"top/slot{idx}")

    def combine(self, state_tree, extra_meta: Optional[Dict] = None) -> List[int]:
        """One combining phase: persist ``state_tree`` into the inactive slot
        for ALL ready announcements (K requests -> one persist), write their
        responses, ONE pfence, two-increment commit.  Returns the combined
        workers."""
        epoch = self._read_epoch()
        assert epoch % 2 == 0, "combine under an uncommitted epoch"
        ready = self.ready_announcements()
        if not ready:
            return []

        slot = self._slot_dir(epoch, nxt=True)
        manifest = {"leaves": [], "epoch": epoch + 2, "meta": extra_meta or {}}
        files = []
        for i, leaf in enumerate(tree_leaves(state_tree)):
            rel = f"{slot}/leaf_{i}.npy"
            data, shape, dtype = _npy(leaf)
            self.fs.write(rel, data)  # pwb per tensor
            files.append(rel)
            manifest["leaves"].append({"file": f"leaf_{i}.npy", "shape": shape,
                                       "dtype": dtype})
        self.fs.write(f"{slot}/manifest.json", json.dumps(manifest).encode())
        files.append(f"{slot}/manifest.json")

        # responses into the combined announcements (paper L92/L61)
        for w in ready:
            v = self._read_valid(w)
            ann = self._read_ann(w, v & 1)
            ann["epoch"] = epoch
            ann["val"] = "ACK"
            self.fs.write(self._ann_path(w, v & 1), json.dumps(ann).encode())
            files.append(self._ann_path(w, v & 1))

        self.fs.fsync(files)  # single pfence for slot + responses (L80)
        self._write_epoch(epoch + 1, sync=True)  # two-increment commit (L81-83)
        self._write_epoch(epoch + 2, sync=False)
        return ready

    # ---------------------------------------------------------------- recover
    def recover(self, state_getter: Optional[Callable[[], Any]] = None):
        """Recovery combiner (paper lines 26-43) + detectability report.

        Returns ``(leaves or None, report)``: the committed slot's leaves as
        numpy arrays, and ``report[w] = {"committed": bool, "step": int or
        None}`` for each worker's latest announcement."""
        fs = self.fs
        epoch = self._read_epoch()
        if epoch % 2 == 1:  # L28-30
            epoch += 1
            self._write_epoch(epoch, sync=True)

        # garbage-collect the slot pool (paper §4): keep only what the
        # active slot's manifest reaches
        active = self._slot_dir(epoch, nxt=False)
        inactive = self._slot_dir(epoch, nxt=True)
        man_raw = fs.read_durable(f"{active}/manifest.json")
        live = set()
        if man_raw:
            man = json.loads(man_raw.decode())
            live = {f"{active}/{e['file']}" for e in man["leaves"]}
            live.add(f"{active}/manifest.json")
        for rel in list(fs.listdir(active)) + list(fs.listdir(inactive)):
            if rel not in live:
                fs.delete(rel)

        # announcements scan (L32-38)
        pending = []
        for w in range(self.n):
            v = self._read_valid(w)
            lsb = v & 1
            if (v >> 1) & 1 == 0:
                fs.write(self._valid_path(w), str(2 | lsb).encode())  # L36
            ann = self._read_ann(w, lsb)
            if ann.get("epoch") == epoch and ann.get("val") is not BOT:
                ann["val"] = BOT  # L38: re-commit ops of the crashed phase
                fs.write(self._ann_path(w, lsb), json.dumps(ann).encode())
            if ann.get("val") is BOT and ann.get("step") is not None:
                pending.append(w)

        state = None
        if man_raw:
            man = json.loads(man_raw.decode())
            state = _read_leaves(fs, active, man["leaves"])

        # recovery combine (L39): a checkpoint announcement's payload died
        # with the crash, so roll forward only when the caller can still
        # produce the state; otherwise the definite negative verdict LOST
        if pending:
            if state_getter is not None:
                self.combine(state_getter())
            else:
                files = []
                for w in pending:
                    v = self._read_valid(w)
                    ann = self._read_ann(w, v & 1)
                    ann["val"] = "LOST"
                    fs.write(self._ann_path(w, v & 1), json.dumps(ann).encode())
                    files.append(self._ann_path(w, v & 1))
                fs.fsync(files)

        report = {}
        for w in range(self.n):
            v = self._read_valid(w)
            ann = self._read_ann(w, v & 1)
            report[w] = {
                "committed": ann.get("val") == "ACK" and ann.get("step") is not None,
                "step": ann.get("step"),
            }
        return state, report

    def _active(self):
        """The committed slot and its manifest (None where there is none)."""
        epoch = self._read_epoch()
        if epoch % 2 == 1:
            epoch += 1
        active = self._slot_dir(epoch, nxt=False)
        man_raw = self.fs.read_durable(f"{active}/manifest.json")
        return active, (json.loads(man_raw.decode()) if man_raw else None)

    def active_manifest(self):
        """The committed checkpoint's manifest, or None: what
        :meth:`load_active` returns beside the leaves, without reading them."""
        return self._active()[1]

    def load_active(self):
        """The committed checkpoint: ``(leaves, manifest)`` or ``(None, None)``."""
        active, man = self._active()
        if man is None:
            return None, None
        leaves = _read_leaves(self.fs, active, man["leaves"])
        return leaves, man

    # ------------------------------------------------- DFC structure states
    def combine_structure(self, state, extra_meta: Optional[Dict] = None) -> List[int]:
        """Persist a stack / queue / deque / map state for every ready
        announcement (as ``combine``), its kind and committed root counters
        recorded in the manifest for ``load_structure``."""
        kind = struct_kind(state)
        meta = dict(extra_meta or {})
        meta["struct"] = kind
        meta["struct_epoch"] = int(state.epoch)
        if kind == "stack":
            meta["committed_size"] = int(state.active_size())
        elif kind == "map":
            meta["committed_count"] = int(state.active_count())
        else:
            ends = state.active_ends()
            meta["committed_ends"] = [int(ends[0]), int(ends[1])]
        return self.combine(state, extra_meta=meta)

    def load_structure(self, device="cuda"):
        """The committed structure state, typed, on ``device``: ``(state,
        manifest)`` or ``(None, None)``."""
        leaves, man = self.load_active()
        if leaves is None:
            return None, None
        kind = man["meta"].get("struct")
        if kind is None:
            raise ValueError("active checkpoint was not written by combine_structure")
        return (STRUCTS[kind].state_cls(*[torch.from_numpy(leaf).to(device)
                                          for leaf in leaves]), man)
