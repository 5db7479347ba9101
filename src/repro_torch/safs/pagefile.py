"""PageFile — one on-disk file per TAS matrix, split into fixed-size pages.

Port of `repro.safs.pagefile`, byte for byte the same on disk: the pages,
the `.meta` JSON (with numpy's name of the element type), the `.sums`
checksum block and the journal. A file written by either package reads
back and scrubs clean in the other. Only the array view differs: `split`
takes a CPU tensor or a numpy array and `assemble` returns a CPU tensor
(pinned on request). Element types are mapped by numpy's name, so a bf16
file (`"dtype": "bfloat16"`) is read as `torch.bfloat16` without the
package that defines numpy's bf16 type.

The paper stores the vector subspace on SSDs behind SAFS, one file per
dense (TAS) matrix (§3.4.1); SAFS moves data in pages and the eigensolver
never overwrites a page it could instead avoid writing (write endurance,
Table 3). This module is the byte level of our reproduction of that layer:

  * a file is an array of PAGE_SIZE-byte pages, page i at offset
    i * page_size; reads go through pread (positional, thread-safe — the
    prefetcher reads concurrently with the consumer) or an optional mmap;
  * batched reads coalesce the requested pages into maximal contiguous
    *runs* and issue one vectored `os.preadv` per run (§3.4.2's request
    merging): at SAFS's native 4 KiB grain this turns ~16 python syscalls
    per 64 KiB of subspace into one, which is where the fast-path
    throughput comes from (see `read_pages_batch` / BENCH_safs.json);
    in-place journal patches likewise go out as one `os.pwritev` per run;
  * dirty-page write-back is crash consistent via a per-file journal:
    a flush first writes every dirty page plus a checksum to
    `<file>.journal`, fsyncs, appends a commit trailer, and only then
    patches the main file in place. Reopening after a crash replays a
    committed journal (redo) or discards an uncommitted one, so every
    page is always either entirely-old or entirely-new — never torn;
  * shape/dtype metadata lives in a `<file>.meta` JSON sidecar so a page
    store can be reopened cold (checkpoint restore path).

Tests inject crashes with the `crash_after_pages` / `crash_in_journal`
hooks instead of killing the process; the on-disk states they produce are
exactly the ones a mid-flush kill leaves behind. `safs.faults`
generalizes those hooks into seeded schedules (`PageFile(faults=plan)`):
the plan is consulted at every preadv/pwritev chunk and at the journal
pre-commit/commit boundaries, and transient errors at those sites are
absorbed by bounded retry with backoff (`retry=RetryPolicy(...)`,
counted via `on_retry` and emitted as `safs.retry` trace events).

Integrity: every page carries a CRC32C-style checksum in a `<file>.sums`
sidecar block, journaled with the same crash-consistency as the data —
the sidecar is rewritten (durably) *before* the batch's journal is
unlinked, so any crash window in which data and checksums could disagree
is exactly the window the journal replay already covers. `read_run` (and
therefore every fill/miss path) verifies payloads against the block; a
persistent mismatch raises a typed `CorruptPageError(site, file, page)`
and emits a `safs.corrupt` trace event — silent bit-rot is detected at
the read boundary, never served upward into Ritz vectors. A transient
mismatch (a read racing an in-place patch, or an injected single-shot
`bitflip` in the transfer) is healed by re-reading the page and counted
as a `crc_retries` integrity event.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import trace
from repro_torch.safs.faults import (CorruptPageError, CrashPoint, DEFAULT_RETRY,
                               FaultPlan, IntegrityCounters, OnRetry,
                               RetryPolicy, with_retries)

PAGE_SIZE = 4096                       # SAFS default page size (§3.4.1)

# Max iovecs per preadv/pwritev syscall (POSIX IOV_MAX is >= 1024 on Linux);
# longer runs are split — still one syscall per IOV_MAX pages, not per page.
_IOV_MAX = 1024


def coalesce_runs(indices: Sequence[int]) -> List[Tuple[int, int]]:
    """Merge page indices into maximal contiguous (start, count) runs.

    The batched I/O engine's request merging: sorted, de-duplicated, and
    adjacency-coalesced so each run becomes a single vectored syscall.
    """
    runs: List[Tuple[int, int]] = []
    for i in sorted(set(int(i) for i in indices)):
        if runs and i == runs[-1][0] + runs[-1][1]:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((i, 1))
    return runs

_JOURNAL_MAGIC = b"SAFSJRNL"
_COMMIT = b"COMMITTD"
_HDR = struct.Struct("<qII")           # page_index, crc32, payload_len

# Checksum sidecar block: magic | algo | page_size | n_pages | u32 CRC per
# page | crc32-of-table trailer. Rewritten atomically (tmp + rename) before
# each batch's journal unlink, so it shares the journal's crash window.
_SUMS_MAGIC = b"SAFSSUMS"
_SUMS_HDR = struct.Struct("<BIQ")      # algo_id, page_size, n_pages

try:                    # hardware CRC32C (Castagnoli) when the wheel exists
    from crc32c import crc32c as _crc32c        # type: ignore
    _CRC_ALGO = 1
except ImportError:     # stdlib fallback — same 32-bit contract, no new dep
    _crc32c = None
    _CRC_ALGO = 0


def page_crc(data) -> int:
    """Per-page content checksum: CRC32C if the accelerated wheel is
    importable, zlib.crc32 otherwise. The sidecar records which algorithm
    produced it and is rebuilt (adopt-current-content) on mismatch."""
    if _crc32c is not None:
        return _crc32c(data)
    return zlib.crc32(data)


_ZERO_CRC: Dict[int, int] = {}          # page_size -> crc of an all-zero page


def _zero_crc(page_size: int) -> int:
    c = _ZERO_CRC.get(page_size)
    if c is None:
        c = _ZERO_CRC[page_size] = page_crc(b"\0" * page_size)
    return c


def flip_bit(path: str, page: int, *, page_size: int = PAGE_SIZE,
             bit: int = 0) -> None:
    """Flip one bit of one page directly on the medium — the test/smoke
    hook for at-rest silent corruption (what a FaultRule cannot model:
    the bytes rotted while nobody was reading or writing them)."""
    fd = os.open(path, os.O_RDWR)
    try:
        off = page * page_size + bit // 8
        b = os.pread(fd, 1, off)
        os.pwrite(fd, bytes([b[0] ^ (1 << (bit % 8))]), off)
        os.fsync(fd)
    finally:
        os.close(fd)


def _flip_payload(data: bytes) -> bytes:
    """The injected `bitflip` action: corrupt the lowest bit of byte 0."""
    b = bytearray(data)
    b[0] ^= 1
    return bytes(b)


# CrashPoint lives in safs.faults (the fault-injection layer owns the
# error taxonomy); re-exported here as the reference does.
__all__ = ["PAGE_SIZE", "CorruptPageError", "CrashPoint", "PageFile",
           "coalesce_runs", "dtype_name", "flip_bit", "page_crc"]

# numpy's name of each element type a page file may hold -> torch's type
TORCH_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}


def dtype_name(dtype) -> str:
    """numpy's name of an element type given as a torch dtype, a numpy
    dtype (numpy's bf16 extension type included) or a name. It is what
    the `.meta` sidecar records."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str) and dtype in TORCH_DTYPES:
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in TORCH_DTYPES:
        raise TypeError(f"page files hold {sorted(TORCH_DTYPES)}, not "
                        f"{name!r}")
    return name


def _raw(arr, name: str) -> np.ndarray:
    """The bytes of a CPU tensor or numpy array, cast to the element type
    `name` where they differ, as a flat uint8 array (a view when no copy
    is needed)."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError("PageFile.split takes a CPU tensor; copy a "
                             "device tensor to the host first")
        t = arr.detach().to(TORCH_DTYPES[name]).contiguous().reshape(-1)
        return t.view(torch.uint8).numpy()
    a = np.asarray(arr)
    if a.dtype.name != name:
        a = a.astype(name)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _meta_path(path: str) -> str:
    return path + ".meta"


def _journal_path(path: str) -> str:
    return path + ".journal"


def _sums_path(path: str) -> str:
    return path + ".sums"


class PageFile:
    """Fixed-size-page file with journaled, crash-consistent write-back.

    `shape`/`dtype` describe the logical array the pages back; they are
    persisted to the sidecar on create and recovered on reopen. `dtype`
    may be a name, a numpy dtype or a torch dtype; the file keeps numpy's
    name (`dtype_name`) and the torch type (`dtype`).
    """

    def __init__(self, path: str, *, page_size: int = PAGE_SIZE,
                 shape: tuple | None = None, dtype="float32",
                 use_mmap: bool = False,
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = DEFAULT_RETRY,
                 on_retry: Optional[OnRetry] = None,
                 verify: bool = True,
                 integrity: Optional[IntegrityCounters] = None,
                 on_corrupt: Optional[OnRetry] = None):
        self.path = path
        self.page_size = int(page_size)
        self.use_mmap = use_mmap
        self.faults = faults
        self.retry = retry
        self.on_retry = on_retry
        # verify: CRC-check every payload `read_run` returns against the
        # sidecar block; a persistent mismatch raises CorruptPageError.
        # integrity/on_corrupt: shared counter block + detection hook (the
        # backend quarantines the page and splits counters per store).
        self.verify = bool(verify)
        self.integrity = integrity
        self.on_corrupt = on_corrupt
        self._mmap = None
        self._close_lock = threading.Lock()   # sync() against close()
        meta = _meta_path(path)
        if os.path.exists(meta):
            with open(meta) as f:
                m = json.load(f)
            self.page_size = int(m["page_size"])
            self.shape = tuple(m["shape"])
            self.dtype_name = dtype_name(m["dtype"])
        else:
            if shape is None:
                raise FileNotFoundError(f"no page file metadata at {meta}")
            self.shape = tuple(int(s) for s in shape)
            self.dtype_name = dtype_name(dtype)
            with open(meta, "w") as f:
                json.dump({"page_size": self.page_size,
                           "shape": list(self.shape),
                           "dtype": self.dtype_name}, f)
        self.dtype = TORCH_DTYPES[self.dtype_name]
        self.nbytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self.n_pages = max(1, -(-self.nbytes // self.page_size))
        flags = os.O_RDWR | os.O_CREAT
        self._fd = os.open(path, flags, 0o644)
        fresh = os.fstat(self._fd).st_size == 0
        size = self.n_pages * self.page_size
        if os.fstat(self._fd).st_size < size:
            os.ftruncate(self._fd, size)
        self._sums_lock = threading.Lock()
        self._sums = self._load_sums(fresh)
        self._recover()

    # -------------------------------------------------------- checksum block
    def _load_sums(self, fresh: bool) -> List[int]:
        """Load the sidecar checksum block; a fresh file gets zero-page
        CRCs, a missing/invalid/foreign-algo sidecar is rebuilt from the
        current file content (adopt — legacy stores verify from now on)."""
        sp = _sums_path(self.path)
        if os.path.exists(sp):
            try:
                with open(sp, "rb") as f:
                    blob = f.read()
                if (blob.startswith(_SUMS_MAGIC)
                        and len(blob) >= len(_SUMS_MAGIC) + _SUMS_HDR.size + 4):
                    algo, ps, n = _SUMS_HDR.unpack_from(blob,
                                                        len(_SUMS_MAGIC))
                    body = blob[len(_SUMS_MAGIC) + _SUMS_HDR.size:-4]
                    (tcrc,) = struct.unpack("<I", blob[-4:])
                    if (algo == _CRC_ALGO and ps == self.page_size
                            and n == self.n_pages and len(body) == 4 * n
                            and zlib.crc32(body) == tcrc):
                        return list(np.frombuffer(body, dtype="<u4"))
            except OSError:
                pass
        if fresh:
            sums = [_zero_crc(self.page_size)] * self.n_pages
        else:
            sums = []
            for i in range(self.n_pages):
                sums.append(page_crc(
                    os.pread(self._fd, self.page_size, i * self.page_size)))
        self._sums = sums
        self._store_sums()
        return sums

    def _store_sums(self) -> None:
        """Durably rewrite the sidecar (tmp + fsync + rename). Called with
        current in-memory sums; crash windows are covered by the journal
        (the batch's journal is only unlinked after this persists)."""
        sp = _sums_path(self.path)
        body = np.asarray(self._sums, dtype="<u4").tobytes()
        blob = (_SUMS_MAGIC
                + _SUMS_HDR.pack(_CRC_ALGO, self.page_size, self.n_pages)
                + body + struct.pack("<I", zlib.crc32(body)))
        tmp = sp + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, sp)

    def _sum(self, i: int) -> int:
        with self._sums_lock:
            return self._sums[i]

    def _set_sums(self, pages: Dict[int, bytes], *, persist: bool) -> None:
        with self._sums_lock:
            for i, data in pages.items():
                self._sums[i] = page_crc(data)
        if persist:
            self._store_sums()

    # ------------------------------------------------------------- raw I/O
    def read_page(self, i: int) -> bytes:
        """Positional page read (pread — safe from the prefetch thread)."""
        assert 0 <= i < self.n_pages, (i, self.n_pages)
        if self.use_mmap:
            if self._mmap is None:
                import mmap
                self._mmap = mmap.mmap(self._fd, self.n_pages * self.page_size)
            off = i * self.page_size
            return bytes(self._mmap[off:off + self.page_size])
        return os.pread(self._fd, self.page_size, i * self.page_size)

    def read_run(self, start: int, count: int) -> List[bytes]:
        """Read `count` consecutive pages with one vectored syscall per
        _IOV_MAX pages: a single preadv into per-page buffers replaces
        `count` python pread calls (the 4 KiB-grain fast path). Each
        chunk is a retry unit: transient errors (injected or real EIO)
        are retried with backoff per `self.retry`; exhaustion raises
        `SafsIOError` with file/page context."""
        assert 0 <= start and start + count <= self.n_pages, \
            (start, count, self.n_pages)
        if self.use_mmap:
            out = [self.read_page(start + k) for k in range(count)]
        else:
            out = []
            done = 0
            while done < count:
                nv = min(count - done, _IOV_MAX)  # bounds the staging buffer
                out.extend(self._read_chunk(start + done, nv))
                done += nv
        if self.verify:
            for k in range(count):
                out[k] = self._verify_payload(start + k, out[k])
            if self.integrity is not None:
                self.integrity.add(pages_verified=count)
        return out

    # ------------------------------------------------------- verification
    def _reread_page(self, i: int) -> bytes:
        """Single-page raw re-read for checksum arbitration. Consults the
        fault plan (a persistent transfer fault keeps corrupting the
        re-read and is therefore *detected*; a single-shot one heals)."""
        if self.use_mmap:
            return self.read_page(i)
        action = None
        if self.faults is not None:
            action = self.faults.check("pread", file=self.path,
                                       page=i, pages=1)
        data = os.pread(self._fd, self.page_size, i * self.page_size)
        return _flip_payload(data) if action == "bitflip" else data

    def _verify_payload(self, i: int, data: bytes, *,
                        site: str = "pread") -> bytes:
        """CRC-check one payload. A mismatch is re-arbitrated by re-reading
        the page (it may be a benign torn read racing an in-place patch,
        or a transient transfer flip — both heal and count as
        `crc_retries`); a persistent mismatch is silent corruption: emit
        `safs.corrupt`, count `crc_failures`, raise typed."""
        if page_crc(data) == self._sum(i):
            return data
        pause = 0.001
        for _ in range(5):
            time.sleep(pause)
            pause *= 2
            data = self._reread_page(i)
            if page_crc(data) == self._sum(i):
                if self.integrity is not None:
                    self.integrity.add(crc_retries=1)
                return data
        trace.event("safs.corrupt", site=site, file=self.path, page=i)
        if self.integrity is not None:
            self.integrity.add(crc_failures=1)
        if self.on_corrupt is not None:
            self.on_corrupt(site=site, file=self.path, page=i)
        raise CorruptPageError(site=site, file=self.path, page=i)

    def verify_pages(self, indices: Optional[Sequence[int]] = None,
                     *, reread: int = 2) -> List[int]:
        """Scrub primitive: raw medium check of `indices` (default: every
        page) against the checksum block. Never raises and never serves
        bytes — returns the indices whose mismatch survived `reread`
        arbitration re-reads (racing write-back heals; bit-rot persists).
        The caller (the scrubber / backend) does the counting,
        quarantining and event emission."""
        bad: List[int] = []
        for i in (range(self.n_pages) if indices is None else indices):
            data = os.pread(self._fd, self.page_size, i * self.page_size)
            ok = page_crc(data) == self._sum(i)
            for _ in range(reread):
                if ok:
                    break
                time.sleep(0.002)
                data = os.pread(self._fd, self.page_size, i * self.page_size)
                ok = page_crc(data) == self._sum(i)
            if not ok:
                bad.append(i)
        return bad

    def _read_chunk(self, start: int, nv: int) -> List[bytes]:
        ps = self.page_size

        def attempt() -> List[bytes]:
            action = None
            if self.faults is not None:
                action = self.faults.check("pread", file=self.path,
                                           page=start, pages=nv)
            mv = memoryview(bytearray(nv * ps))
            off = start * ps
            want = nv * ps
            # an injected short read truncates the FIRST preadv to one
            # page; the continuation loop below must complete the chunk
            first = ps if (action == "short_read" and want > ps) else want
            got = os.preadv(self._fd, [mv[:first]], off)
            while got < want:          # short read (signal/EOF-adjacent)
                n = os.preadv(self._fd, [mv[got:]], off + got)
                if n <= 0:
                    raise IOError(
                        f"short preadv at page {start + got // ps}")
                got += n
            out = [bytes(mv[k * ps:(k + 1) * ps]) for k in range(nv)]
            if action == "bitflip":    # corruption in the transfer: the
                out[0] = _flip_payload(out[0])   # checksum layer's problem
            return out

        return with_retries(attempt, self.retry, site="pread",
                            file=self.path, page=start,
                            on_retry=self.on_retry)

    def read_pages_batch(self, indices: Sequence[int]) -> Dict[int, bytes]:
        """Batched page read: coalesce `indices` into contiguous runs and
        issue one vectored preadv per run (§3.4.2 request merging)."""
        pages: Dict[int, bytes] = {}
        for start, count in coalesce_runs(indices):
            for k, payload in enumerate(self.read_run(start, count)):
                pages[start + k] = payload
        return pages

    def _write_page_raw(self, i: int, data: bytes) -> None:
        assert len(data) == self.page_size
        if self._mmap is not None:
            off = i * self.page_size
            self._mmap[off:off + self.page_size] = data
        else:
            os.pwrite(self._fd, data, i * self.page_size)

    # --------------------------------------------------- journaled flush
    def write_pages(self, pages: Dict[int, bytes], *,
                    crash_after_pages: Optional[int] = None,
                    crash_in_journal: bool = False) -> int:
        """Crash-consistent write-back of a batch of dirty pages.

        Returns the number of bytes written to the main file (the
        endurance-relevant count; journal bytes are transient). The two
        crash hooks abort, respectively, after `crash_after_pages` in-place
        page writes (journal already committed → redo on reopen) and
        mid-journal before the commit trailer (→ discard on reopen).
        """
        if not pages:
            return 0
        jp = _journal_path(self.path)
        with open(jp, "wb") as j:
            j.write(_JOURNAL_MAGIC)
            for k, (i, data) in enumerate(sorted(pages.items())):
                assert len(data) == self.page_size
                j.write(_HDR.pack(i, zlib.crc32(data), len(data)))
                j.write(data)
                if crash_in_journal and k + 1 == len(pages):
                    j.flush()
                    os.fsync(j.fileno())
                    raise CrashPoint("crash before journal commit")
            j.flush()
            os.fsync(j.fileno())
            # journal durable, commit trailer not: a crash here discards
            self._fault("journal.precommit", pages=len(pages))
            j.write(_COMMIT)
            j.flush()
            os.fsync(j.fileno())
        # journal committed, in-place patch not started: a crash from
        # here on is redone on reopen (the batch is already durable)
        self._fault("journal.commit", pages=len(pages))
        written = 0
        if crash_after_pages is not None or self._mmap is not None:
            # crash-hook path keeps the per-page write granularity the
            # hooks are defined against (k counts in-place page writes)
            for k, (i, data) in enumerate(sorted(pages.items())):
                if crash_after_pages is not None and k >= crash_after_pages:
                    raise CrashPoint(f"crash after {k} in-place page writes")
                self._write_page_raw(i, data)
                written += len(data)
        else:
            written = self._pwritev_runs(pages)
        self.sync()
        # checksum block BEFORE the journal unlink: a crash anywhere in
        # between replays the journal on reopen, which re-derives exactly
        # these sums — data and checksums can never durably disagree
        self._set_sums(pages, persist=True)
        try:
            os.unlink(jp)
        except FileNotFoundError:
            pass      # a concurrent reopen already recovered + unlinked it
        return written

    def _fault(self, site: str, **ctx) -> Optional[str]:
        if self.faults is not None:
            return self.faults.check(site, file=self.path, **ctx)
        return None

    def _pwritev_runs(self, pages: Dict[int, bytes]) -> int:
        """In-place patch as one vectored pwritev per contiguous run.
        Each chunk is a retry unit (idempotent: same bytes, same
        offsets), so a transient mid-patch error costs a re-write of the
        chunk, never a torn page — the journal is already committed."""
        written = 0
        for start, count in coalesce_runs(pages.keys()):
            done = 0
            while done < count:
                nv = min(count - done, _IOV_MAX)
                written += self._write_chunk(pages, start + done, nv)
                done += nv
        return written

    def _write_chunk(self, pages: Dict[int, bytes], start: int,
                     nv: int) -> int:
        def attempt() -> int:
            action = self._fault("pwritev", page=start, pages=nv)
            bufs = [pages[start + k] for k in range(nv)]
            for b in bufs:             # offsets assume full pages
                assert len(b) == self.page_size, len(b)
            off = start * self.page_size
            want = nv * self.page_size
            if action == "bitflip":
                # silent media corruption: flipped bits land on disk while
                # the checksum block keeps the intended CRC — every later
                # read/scrub of this page detects the mismatch
                bufs = [_flip_payload(bufs[0])] + bufs[1:]
            elif action == "torn_page":
                # power-cut torn write: only the first half of the first
                # page persists; the rest of the chunk lands normally
                os.pwrite(self._fd, bufs[0][:self.page_size // 2], off)
                if nv > 1:
                    os.pwritev(self._fd, bufs[1:], off + self.page_size)
                return want
            got = os.pwritev(self._fd, bufs, off)
            while got < want:          # short write: retry the remainder
                flat = b"".join(bufs)
                n = os.pwrite(self._fd, flat[got:], off + got)
                if n <= 0:
                    raise IOError(
                        f"short pwrite at page "
                        f"{start + got // self.page_size}")
                got += n
            return want

        return with_retries(attempt, self.retry, site="pwritev",
                            file=self.path, page=start,
                            on_retry=self.on_retry)

    def _recover(self) -> None:
        """Replay a committed journal; discard an uncommitted one."""
        jp = _journal_path(self.path)
        if not os.path.exists(jp):
            return
        with open(jp, "rb") as j:
            blob = j.read()
        ok = blob.startswith(_JOURNAL_MAGIC) and blob.endswith(_COMMIT)
        if ok:
            off = len(_JOURNAL_MAGIC)
            end = len(blob) - len(_COMMIT)
            replayed: Dict[int, bytes] = {}
            while off < end:
                i, crc, n = _HDR.unpack_from(blob, off)
                off += _HDR.size
                data = blob[off:off + n]
                off += n
                if zlib.crc32(data) != crc:   # torn journal: abort replay
                    ok = False
                    break
                self._write_page_raw(i, data)
                replayed[i] = data
            self.sync()
            if replayed:   # re-derive the sums the interrupted batch meant
                self._set_sums(replayed, persist=True)
        try:
            os.unlink(jp)
        except FileNotFoundError:
            pass
        return

    def sync(self) -> None:
        # a barrier over every file of a shared store (backend.flush) can
        # reach a file that another session's delete has just closed;
        # such a file has nothing left to make durable
        with self._close_lock:
            if self._fd is None:
                return
            if self._mmap is not None:
                self._mmap.flush()
            os.fsync(self._fd)

    # --------------------------------------------------------- array view
    def page_indices(self) -> Iterable[int]:
        return range(self.n_pages)

    def pages_of_slice(self, byte_lo: int, byte_hi: int) -> range:
        """Pages overlapping the byte range [lo, hi) of the logical array."""
        return range(byte_lo // self.page_size,
                     -(-byte_hi // self.page_size))

    def assemble(self, pages: Dict[int, bytes], *,
                 pin_memory: bool = False) -> torch.Tensor:
        """Rebuild the logical array from a full set of page payloads, as
        a new CPU tensor, page-locked when `pin_memory` (a CUDA store
        copies it to the card without waiting)."""
        raw = b"".join(pages[i] for i in range(self.n_pages))
        buf = torch.empty(len(raw), dtype=torch.uint8, pin_memory=pin_memory)
        buf.numpy()[:] = np.frombuffer(raw, dtype=np.uint8)
        return buf[:self.nbytes].view(self.dtype).reshape(self.shape)

    def split(self, arr) -> Dict[int, bytes]:
        """Split the logical array (a CPU tensor or a numpy array of the
        file's shape) into zero-padded page payloads."""
        raw = _raw(arr, self.dtype_name)
        if raw.size != self.nbytes:
            raise ValueError(f"PageFile.split: {raw.size} bytes for a "
                             f"{self.shape} {self.dtype_name} file")
        ps = self.page_size
        pages = {i: raw[i * ps:(i + 1) * ps].tobytes()
                 for i in range(self.n_pages)}
        last = self.n_pages - 1
        pages[last] += b"\0" * (ps - len(pages[last]))
        return pages

    def close(self) -> None:
        with self._close_lock:
            if self._mmap is not None:
                self._mmap.close()
                self._mmap = None
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def delete(self) -> None:
        self.close()
        for p in (self.path, _meta_path(self.path), _journal_path(self.path),
                  _sums_path(self.path), _sums_path(self.path) + ".tmp"):
            if os.path.exists(p):
                os.unlink(p)
