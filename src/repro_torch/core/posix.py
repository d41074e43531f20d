"""Errno-faithful POSIX VFS over the transactional client (paper Fig 2).

This is the layer ported POSIX applications touch: open/close with real
access modes, positioned / sequential / vectored read+write, lseek,
ftruncate, fsync, dup/dup2, rename (including directories and
replace-over-existing), unlink, mkdir / rmdir / readdir over **real
directory entries**, full stat (size + kind + mtime/ctime derived from
commit timestamps), and flock. Calls are routed by path prefix (default
``/mnt/tsfs``), mirroring the paper's syscall-intercept routing;
operations outside the prefix raise (in the real system they fall
through to the kernel).

**Errors are OSError subclasses with correct errno** (FileNotFoundError/
ENOENT, FileExistsError/EEXIST, IsADirectoryError/EISDIR,
NotADirectoryError/ENOTDIR, OSError/ENOTEMPTY·EBADF·EINVAL), so POSIX
code ported onto this VFS — `except FileNotFoundError`, `e.errno ==
errno.ENOTEMPTY` — works unmodified. The legacy ``NotFound``/``Exists``
exceptions remain as bases of the ENOENT/EEXIST errors for older
callers. The contract, errno table and paper mapping live in
docs/posix.md.

**Directories are real.** ``mkdir`` creates a directory inode (a file id
whose meta kind is ``"d"``); link/unlink under it bumps its namespace
generation, and ``readdir``/``rmdir`` record its meta version — so a
concurrent create in a directory aborts a committing remover or lister
(full phantom protection, which the paper's prototype skips). Two
concurrent creators in one directory do NOT conflict: they pin the
parent with an existence predicate instead of a meta read.

**Path semantics** have two modes. ``strict=True`` is full POSIX: every
intermediate component must exist and be a directory (ENOENT/ENOTDIR
otherwise). The default ``strict=False`` keeps the serverless-friendly
behavior existing workloads rely on: missing ancestors are materialized
as real directories at create time (an implicit ``mkdir -p``); all other
checks (ENOTDIR through a file, EISDIR, ENOTEMPTY, access modes) are
enforced identically in both modes.

Locks (flock) are *elided optimistically* (paper §3.1): acquisition
always succeeds locally and is recorded through the transaction's lock
API (``Transaction.lock_file``), so commit validation enforces the
serialization the lock would have provided.
"""
from __future__ import annotations

import errno as _errno
import os
import stat as _stat
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.blockstore import SnapshotTooOld
from repro_torch.core.client import Transaction
from repro_torch.core.types import KIND_DIR, KIND_FILE, Exists, NotFound

O_RDONLY = os.O_RDONLY
O_WRONLY = os.O_WRONLY
O_RDWR = os.O_RDWR
O_ACCMODE = os.O_ACCMODE
O_CREAT = os.O_CREAT
O_TRUNC = os.O_TRUNC
O_APPEND = os.O_APPEND
O_EXCL = os.O_EXCL
O_DIRECTORY = os.O_DIRECTORY

SEEK_SET, SEEK_CUR, SEEK_END = 0, 1, 2

LOCK_SH, LOCK_EX, LOCK_NB, LOCK_UN = 1, 2, 4, 8


class FSNotFound(NotFound, FileNotFoundError):
    """ENOENT — also a ``repro.core.types.NotFound`` for legacy callers."""


class FSExists(Exists, FileExistsError):
    """EEXIST — also a ``repro.core.types.Exists`` for legacy callers."""


_ERRNO_CLASS = {
    _errno.ENOENT: FSNotFound,
    _errno.EEXIST: FSExists,
    _errno.EISDIR: IsADirectoryError,
    _errno.ENOTDIR: NotADirectoryError,
}


def _err(code: int, path: object = None) -> OSError:
    cls = _ERRNO_CLASS.get(code, OSError)
    if path is None:
        return cls(code, os.strerror(code))
    return cls(code, os.strerror(code), path)


@dataclass
class _FD:
    """Open-file description. ``dup`` fds share ONE of these, so the file
    offset is shared across duplicates exactly as POSIX specifies."""

    fid: int
    path: str
    mode: int              # O_RDONLY / O_WRONLY / O_RDWR
    kind: str = KIND_FILE
    pos: int = 0
    append: bool = False


class FaaSFS:
    """POSIX facade bound to one transaction (one function invocation)."""

    def __init__(self, txn: Transaction, mount: str = "/mnt/tsfs",
                 strict: bool = False):
        self.txn = txn
        self.mount = mount.rstrip("/")
        self.strict = strict
        self._fds: Dict[int, _FD] = {}
        self._next_fd = 3
        self._dircache: Dict[str, int] = {}  # resolved directory fids

    # ------------------------------------------------------------------ #
    # path plumbing
    # ------------------------------------------------------------------ #
    def _norm(self, path: str) -> str:
        p = os.path.normpath(path)
        if not p.startswith(self.mount + "/") and p != self.mount:
            raise ValueError(f"path {path!r} outside FaaSFS mount {self.mount}")
        return p

    def _ancestors(self, p: str) -> List[str]:
        """Intermediate directory paths strictly between mount and ``p``."""
        out = []
        parent = os.path.dirname(p)
        while parent != self.mount:
            out.append(parent)
            parent = os.path.dirname(parent)
        out.reverse()
        return out

    def _prefetch_path(self, p: str) -> None:
        """Warm a whole path walk in two batched round trips: ONE
        ``lookup_many`` covering every not-yet-resolved component
        (ancestors + ``p``) and ONE ``fetch_metas`` probe for the fids
        it found. ``_resolve_dir`` and the kind checks then run against
        txn-local caches, so resolving a depth-d path costs O(1) backend
        round trips instead of O(d) — the dominant win once every RPC
        crosses a socket."""
        if p == self.mount:
            return  # the root is implicit; it has no components to walk
        comps = [
            c for c in self._ancestors(p) + [p] if c not in self._dircache
        ]
        if not comps:
            return
        fids = self.txn.lookup_many(comps)
        found = [fid for fid in fids if fid is not None]
        if found:
            self.txn.probe_metas(found)

    def _resolve_dir(self, p: str, create_missing: bool) -> Optional[int]:
        """File id of directory path ``p`` (None for the mount root).

        Raises ENOENT when a component is missing (strict mode, or
        ``create_missing=False``), ENOTDIR when one is a regular file. In
        lenient mode with ``create_missing``, missing components are
        materialized as real directories (their parents get the
        namespace-generation touch any link gets).
        """
        if p == self.mount:
            return None
        cached = self._dircache.get(p)
        if cached is not None:
            return cached
        parent_fid: Optional[int] = None
        for comp in self._ancestors(p) + [p]:
            fid = self._dircache.get(comp)
            if fid is None:
                fid = self.txn.lookup(comp)
                if fid is None:
                    if not create_missing:
                        raise _err(_errno.ENOENT, comp)
                    fid = self.txn.create(comp, kind=KIND_DIR)
                    self._link_under(parent_fid)
                elif self.txn.file_kind(fid) != KIND_DIR:
                    raise _err(_errno.ENOTDIR, comp)
                self._dircache[comp] = fid
            parent_fid = fid
        return parent_fid

    def _parent_of(self, p: str, create_missing: bool) -> Optional[int]:
        parent = os.path.dirname(p)
        return self._resolve_dir(parent, create_missing)

    def _enoent(self, p: str) -> OSError:
        """ENOENT for a missing target — but POSIX resolves the parent
        chain first, so in strict mode a component that is a regular
        file yields ENOTDIR (and a missing component ITS ENOENT)
        instead."""
        if self.strict:
            self._parent_of(p, create_missing=False)
        return _err(_errno.ENOENT, p)

    def _parent_for_unlink(self, p: str) -> Optional[int]:
        """Parent fid for an unlink-side touch. In lenient mode a missing
        parent binding (a path created through the raw Transaction API
        before real directories existed) degrades to "no parent to
        touch" instead of ENOENT."""
        try:
            return self._parent_of(p, create_missing=False)
        except FSNotFound:
            if self.strict:
                raise
            return None

    def _link_under(self, parent_fid: Optional[int]) -> None:
        """Record a link/unlink under ``parent_fid``: pin its existence
        (predicate — concurrent creators don't conflict with each other)
        and bump its namespace generation (meta set — so a concurrent
        rmdir/readdir of the parent conflicts with us)."""
        if parent_fid is None:
            return  # the mount root is implicit and indestructible
        self.txn.assert_exists(parent_fid)
        self.txn.touch_dir(parent_fid)

    def _kind_of_path(self, p: str) -> Tuple[Optional[int], Optional[str]]:
        fid = self.txn.lookup(p)
        if fid is None:
            return None, None
        return fid, self.txn.file_kind(fid)

    # ------------------------------------------------------------------ #
    # fd table
    # ------------------------------------------------------------------ #
    def _fd(self, fd: int) -> _FD:
        try:
            return self._fds[fd]
        except KeyError:
            raise _err(_errno.EBADF) from None

    def _alloc_fd(self, f: _FD) -> int:
        fd = self._next_fd
        self._next_fd += 1
        self._fds[fd] = f
        return fd

    # ------------------------------------------------------------------ #
    # open / close / dup
    # ------------------------------------------------------------------ #
    def open(self, path: str, flags: int = 0, mode: int = 0o644) -> int:
        p = self._norm(path)
        if flags & O_DIRECTORY and flags & O_CREAT:
            # Linux rejects the combination up front, before path
            # resolution: it fails EINVAL even for paths that exist (or
            # whose parents don't)
            raise _err(_errno.EINVAL, p)
        self._prefetch_path(p)
        acc = flags & O_ACCMODE
        fid = self.txn.lookup(p)
        kind = KIND_FILE
        if fid is None:
            if not flags & O_CREAT:
                raise self._enoent(p)
            parent = self._parent_of(p, create_missing=not self.strict)
            fid = self.txn.create(p)
            self._link_under(parent)
        else:
            if flags & O_CREAT and flags & O_EXCL:
                raise _err(_errno.EEXIST, p)
            kind = self.txn.file_kind(fid) or KIND_FILE
            if flags & O_DIRECTORY and kind != KIND_DIR:
                # Linux: O_DIRECTORY on a non-directory fails ENOTDIR
                # (checked at resolution, before any O_TRUNC side effect)
                raise _err(_errno.ENOTDIR, p)
            if kind == KIND_DIR and (
                acc != O_RDONLY or flags & (O_CREAT | O_TRUNC)
            ):
                # Linux: opening a directory for writing, with O_CREAT,
                # or with O_TRUNC all fail EISDIR
                raise _err(_errno.EISDIR, p)
        if flags & O_TRUNC and kind == KIND_FILE:
            # Linux truncates even on O_RDONLY|O_TRUNC
            self.txn.truncate(fid, 0)
        mode = acc
        if kind == KIND_DIR:
            mode = O_RDONLY
        elif not self.strict and acc == O_RDONLY:
            # O_RDONLY is 0, so legacy callers that pass bare O_CREAT (or
            # no flags) and then write cannot be told apart from true
            # read-only opens; lenient mode keeps them writable. strict
            # mode enforces the declared access mode faithfully.
            mode = O_RDWR
        return self._alloc_fd(
            _FD(fid, p, mode, kind, append=bool(flags & O_APPEND))
        )

    def close(self, fd: int) -> None:
        self._fd(fd)  # EBADF on unknown fd / double close
        del self._fds[fd]

    def dup(self, fd: int) -> int:
        return self._alloc_fd(self._fd(fd))  # shared offset, per POSIX

    def dup2(self, fd: int, fd2: int) -> int:
        f = self._fd(fd)
        if fd2 < 0:
            raise _err(_errno.EBADF)
        if fd == fd2:
            return fd2
        self._fds[fd2] = f  # silently closes a previously open fd2
        self._next_fd = max(self._next_fd, fd2 + 1)
        return fd2

    # ------------------------------------------------------------------ #
    # byte I/O
    # ------------------------------------------------------------------ #
    def _readable(self, f: _FD) -> None:
        if f.kind == KIND_DIR:
            raise _err(_errno.EISDIR, f.path)
        if f.mode == O_WRONLY:
            raise _err(_errno.EBADF, f.path)

    def _writable(self, f: _FD) -> None:
        if f.kind == KIND_DIR or f.mode == O_RDONLY:
            raise _err(_errno.EBADF, f.path)

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        # Linux precedence (ksys_pread64): negative offset (EINVAL) is
        # rejected before the fd is even looked at, then fd mode
        # (EBADF), then directory (EISDIR)
        if offset < 0 or size < 0:
            raise _err(_errno.EINVAL)
        f = self._fd(fd)
        if f.mode == O_WRONLY:
            raise _err(_errno.EBADF, f.path)
        if f.kind == KIND_DIR:
            raise _err(_errno.EISDIR, f.path)
        return self.txn.read(f.fid, offset, size)

    def pread_into(self, fd: int, size: int, offset: int, out) -> int:
        """``pread`` into a caller-owned writable buffer (the zero-copy
        tensor path; see ``Transaction.read_into`` for the alignment
        rules that make the fill copy-free). Returns the byte count."""
        if offset < 0 or size < 0:
            raise _err(_errno.EINVAL)
        f = self._fd(fd)
        if f.mode == O_WRONLY:
            raise _err(_errno.EBADF, f.path)
        if f.kind == KIND_DIR:
            raise _err(_errno.EISDIR, f.path)
        return self.txn.read_into(f.fid, offset, size, out)

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        if offset < 0:  # like pread: EINVAL precedes even the fd lookup
            raise _err(_errno.EINVAL)
        f = self._fd(fd)
        self._writable(f)
        if f.append:
            # Linux (documented BUGS divergence from POSIX): pwrite on an
            # O_APPEND fd appends, ignoring the offset
            return self.txn.write(f.fid, self.txn.length(f.fid), data)
        return self.txn.write(f.fid, offset, data)

    def read(self, fd: int, size: int) -> bytes:
        f = self._fd(fd)
        self._readable(f)
        if size < 0:
            raise _err(_errno.EINVAL, f.path)
        out = self.txn.read(f.fid, f.pos, size)
        f.pos += len(out)
        return out

    def write(self, fd: int, data: bytes) -> int:
        f = self._fd(fd)
        self._writable(f)
        if f.append:
            f.pos = self.txn.length(f.fid)
        n = self.txn.write(f.fid, f.pos, data)
        f.pos += n
        return n

    # -- vectored I/O: a whole iovec is ONE batched fetch_blocks -------- #
    def preadv(self, fd: int, sizes: Sequence[int], offset: int) -> List[bytes]:
        """Read ``len(sizes)`` consecutive extents starting at ``offset``.
        The whole span is one ``Transaction.read``, whose cache misses
        travel in a single batched ``fetch_blocks`` round trip."""
        if offset < 0 or any(s < 0 for s in sizes):
            raise _err(_errno.EINVAL)
        f = self._fd(fd)
        if f.mode == O_WRONLY:
            raise _err(_errno.EBADF, f.path)
        if f.kind == KIND_DIR:
            raise _err(_errno.EISDIR, f.path)
        data = self.txn.read(f.fid, offset, sum(sizes))
        out, pos = [], 0
        for s in sizes:
            out.append(data[pos:pos + s])
            pos += s
        return out

    def pwritev(self, fd: int, bufs: Sequence[bytes], offset: int) -> int:
        if offset < 0:
            raise _err(_errno.EINVAL)
        f = self._fd(fd)
        self._writable(f)
        if f.append:  # Linux: pwritev on O_APPEND appends (see pwrite)
            return self.txn.write(f.fid, self.txn.length(f.fid), b"".join(bufs))
        return self.txn.write(f.fid, offset, b"".join(bufs))

    def readv(self, fd: int, sizes: Sequence[int]) -> List[bytes]:
        f = self._fd(fd)
        out = self.preadv(fd, sizes, f.pos)
        f.pos += sum(len(b) for b in out)
        return out

    def writev(self, fd: int, bufs: Sequence[bytes]) -> int:
        f = self._fd(fd)
        self._writable(f)
        if f.append:
            f.pos = self.txn.length(f.fid)
        n = self.txn.write(f.fid, f.pos, b"".join(bufs))
        f.pos += n
        return n

    # ------------------------------------------------------------------ #
    def lseek(self, fd: int, offset: int, whence: int = SEEK_SET) -> int:
        f = self._fd(fd)
        if whence == SEEK_SET:
            new = offset
        elif whence == SEEK_CUR:
            new = f.pos + offset
        elif whence == SEEK_END:
            if f.kind == KIND_DIR:
                # Linux dcache_dir_lseek: directories reject SEEK_END
                raise _err(_errno.EINVAL, f.path)
            new = self.txn.length(f.fid) + offset
        else:
            raise _err(_errno.EINVAL, f.path)
        if new < 0:
            raise _err(_errno.EINVAL, f.path)
        f.pos = new
        return new

    def ftruncate(self, fd: int, length: int) -> None:
        f = self._fd(fd)
        if length < 0 or f.kind == KIND_DIR or f.mode == O_RDONLY:
            raise _err(_errno.EINVAL, f.path)
        self.txn.truncate(f.fid, length)

    def fsync(self, fd: int) -> None:
        # durability is provided by atomic commit at function boundary;
        # fsync is a no-op that still validates the fd (paper: sync time
        # largely disappears into commit)
        self._fd(fd)

    fdatasync = fsync

    # ------------------------------------------------------------------ #
    # stat
    # ------------------------------------------------------------------ #
    def _stat_of(self, fid: int) -> Dict[str, int]:
        tf = self.txn.file_info(fid)
        is_dir = tf.kind == KIND_DIR
        return {
            "st_size": self.txn.length(fid),
            "st_mode": (_stat.S_IFDIR | 0o755) if is_dir
                       else (_stat.S_IFREG | 0o644),
            "st_ino": fid,
            "st_nlink": 2 if is_dir else 1,
            # logical clocks: commit timestamps, not wall time. mtime is
            # the last data modification (in-place writes advance it
            # without a meta version), ctime the last inode change.
            "st_mtime": tf.mtime,
            "st_ctime": tf.ctime,
        }

    def fstat(self, fd: int) -> Dict[str, int]:
        return self._stat_of(self._fd(fd).fid)

    def stat(self, path: str) -> Dict[str, int]:
        p = self._norm(path)
        if p == self.mount:
            return {"st_size": 0, "st_mode": _stat.S_IFDIR | 0o755,
                    "st_ino": 0, "st_nlink": 2, "st_mtime": 0, "st_ctime": 0}
        self._prefetch_path(p)
        fid = self.txn.lookup(p)
        if fid is None:
            raise self._enoent(p)
        return self._stat_of(fid)

    # ------------------------------------------------------------------ #
    # namespace ops
    # ------------------------------------------------------------------ #
    def unlink(self, path: str) -> None:
        p = self._norm(path)
        self._prefetch_path(p)
        fid, kind = self._kind_of_path(p)
        if fid is None:
            raise self._enoent(p)
        if kind == KIND_DIR:
            raise _err(_errno.EISDIR, p)
        parent = self._parent_for_unlink(p)
        self.txn.unlink(p)
        self._link_under(parent)

    def mkdir(self, path: str, mode: int = 0o755) -> None:
        p = self._norm(path)
        self._prefetch_path(p)
        if p == self.mount or self.txn.lookup(p) is not None:
            raise _err(_errno.EEXIST, p)
        parent = self._parent_of(p, create_missing=not self.strict)
        self._dircache[p] = self.txn.create(p, kind=KIND_DIR)
        self._link_under(parent)

    def makedirs(self, path: str, exist_ok: bool = False) -> None:
        """``mkdir -p``: create missing ancestors too (even in strict
        mode — this is the explicit form of what lenient mode does
        implicitly). Like ``os.makedirs``, an existing non-directory
        terminal raises EEXIST even with ``exist_ok``."""
        p = self._norm(path)
        if p == self.mount:
            if not exist_ok:
                raise _err(_errno.EEXIST, p)
            return
        self._prefetch_path(p)
        fid, kind = self._kind_of_path(p)
        if fid is not None:
            if not exist_ok or kind != KIND_DIR:
                raise _err(_errno.EEXIST, p)
            return
        parent = self._parent_of(p, create_missing=True)
        self._dircache[p] = self.txn.create(p, kind=KIND_DIR)
        self._link_under(parent)

    def rmdir(self, path: str) -> None:
        p = self._norm(path)
        if p == self.mount:
            raise _err(_errno.EBUSY, p)
        self._prefetch_path(p)
        fid, kind = self._kind_of_path(p)
        if fid is None:
            raise self._enoent(p)
        if kind != KIND_DIR:
            raise _err(_errno.ENOTDIR, p)
        # Record the directory's meta version (a concurrent link/unlink
        # in it bumps the namespace generation -> we abort at commit) and
        # every visible entry; only then decide emptiness.
        self.txn.file_info(fid)
        if self.txn.readdir(p):
            raise _err(_errno.ENOTEMPTY, p)
        parent = self._parent_for_unlink(p)
        self.txn.unlink(p)
        self._link_under(parent)
        self._dircache.pop(p, None)

    def readdir(self, path: str) -> List[str]:
        """Transactionally list direct children. For a real directory the
        listing records the dir's meta version, so a concurrent create of
        a brand-new name (a phantom) aborts this transaction at commit;
        observed entries are name-read-validated as before."""
        p = self._norm(path)
        if p != self.mount:
            self._prefetch_path(p)
            fid, kind = self._kind_of_path(p)
            if fid is not None:
                if kind != KIND_DIR:
                    raise _err(_errno.ENOTDIR, p)
                self.txn.file_info(fid)  # meta read: phantom protection
                return [n for n in self.txn.readdir(p) if n != ".dir"]
            # legacy prefix-only "directory" (entries created through the
            # raw Transaction API): list it if it has children
            names = [n for n in self.txn.readdir(p) if n != ".dir"]
            if not names:
                raise self._enoent(p)
            return names
        return [n for n in self.txn.readdir(p) if n != ".dir"]

    def rename(self, src: str, dst: str) -> None:
        """POSIX rename: atomic, replaces an existing destination (file
        over file; empty directory over empty directory), moves whole
        directory subtrees, refuses a destination inside the source
        (EINVAL)."""
        s, d = self._norm(src), self._norm(dst)
        if s == self.mount or d == self.mount:
            raise _err(_errno.EBUSY, s if s == self.mount else d)
        self._prefetch_path(s)
        self._prefetch_path(d)
        inside = d.startswith(s + "/")
        if self.strict:
            # kernel ordering: BOTH parent chains resolve before the
            # final src component is looked up, before the ancestor
            # EINVAL check, before any replace check
            sparent = self._parent_of(s, create_missing=False)
            dparent = self._parent_of(d, create_missing=False)
            sfid, skind = self._kind_of_path(s)
            if sfid is None:
                raise _err(_errno.ENOENT, s)
            if s == d:
                return
        else:
            sfid, skind = self._kind_of_path(s)
            if sfid is None:
                raise self._enoent(s)
            if s == d:
                return
            if inside:
                # fail before implicit dir creation can mutate the
                # moving subtree
                raise _err(_errno.EINVAL, d)
            sparent = self._parent_for_unlink(s)
            dparent = self._parent_of(d, create_missing=True)
        if inside:
            raise _err(_errno.EINVAL, d)
        dfid, dkind = self._kind_of_path(d)
        if dfid is not None:
            if skind == KIND_FILE and dkind == KIND_DIR:
                raise _err(_errno.EISDIR, d)
            if skind == KIND_DIR and dkind == KIND_FILE:
                raise _err(_errno.ENOTDIR, d)
            if skind == KIND_DIR and dkind == KIND_DIR:
                self.txn.file_info(dfid)
                if self.txn.readdir(d):
                    raise _err(_errno.ENOTEMPTY, d)
            self.txn.delete_fid(dfid)
        if skind == KIND_DIR:
            # moving a subtree rebinds every descendant path; entries are
            # read transactionally (name reads + namespace generation),
            # so a concurrent create inside the moving tree conflicts
            self.txn.file_info(sfid)
            for rel, child_fid in self._walk(s):
                self.txn.bind(s + rel, None)
                self.txn.bind(d + rel, child_fid)
            self._dircache = {}
        self.txn.bind(s, None)
        self.txn.bind(d, sfid)
        self._link_under(sparent)
        if dparent != sparent:
            self._link_under(dparent)

    def _walk(self, root: str) -> List[Tuple[str, Optional[int]]]:
        """All descendants of directory ``root`` (depth-first) as
        ``("/name[/...]", fid)`` pairs — fids resolved once here and
        reused by the rename rebind loop."""
        out: List[Tuple[str, Optional[int]]] = []
        for name in self.txn.readdir(root):
            child = root + "/" + name
            fid = self.txn.lookup(child)
            out.append(("/" + name, fid))
            if fid is not None and self.txn.file_kind(fid) == KIND_DIR:
                self.txn.file_info(fid)
                out.extend(
                    ("/" + name + rel, f) for rel, f in self._walk(child)
                )
        return out

    def exists(self, path: str) -> bool:
        try:
            return self.txn.lookup(self._norm(path)) is not None
        except (ValueError, SnapshotTooOld):
            # SnapshotTooOld must surface: a GC'd undo entry means "cannot
            # answer at this snapshot", not "file absent" — swallowing it
            # would report a phantom deletion to snapshot readers
            raise
        except Exception:
            return False

    # ------------------------------------------------------------------ #
    # optimistic lock elision (paper §3.1): flock always succeeds; the
    # lock word is recorded through the transaction's lock API so
    # conflicting lockers fail validation at commit.
    # ------------------------------------------------------------------ #
    def flock(self, fd: int, op: int = LOCK_EX, *,
              exclusive: Optional[bool] = None) -> None:
        f = self._fd(fd)
        if isinstance(op, bool):  # legacy positional form: flock(fd, exclusive)
            op = LOCK_EX if op else LOCK_SH
        if exclusive is not None:  # legacy keyword form
            op = LOCK_EX if exclusive else LOCK_SH
        op &= ~LOCK_NB  # always non-blocking: acquisition succeeds locally
        if op == LOCK_UN:
            return  # locks release at the function boundary (commit/abort)
        if op not in (LOCK_SH, LOCK_EX):
            raise _err(_errno.EINVAL, f.path)
        self.txn.lock_file(f.fid, exclusive=op == LOCK_EX)

    def funlock(self, fd: int) -> None:
        self._fd(fd)
