"""Crash-safe file writes: the port's own copy of
``namazu_tpu/utils/atomic.py``.

The data goes to a sibling temp file (``<name>.<random>.tmp``), which is
``fsync``ed and renamed onto the destination (atomic on POSIX within one
filesystem); then the directory is ``fsync``ed, best effort, so the
rename itself survives a crash. At every instant the destination holds
either its complete previous content or the complete new content. A
hard kill can leave a stray ``.tmp``; pool checks (``pool_fsck``) sweep
those.

A write consults the chaos seam (``namazu_tpu_torch/chaos.py``) where the
reference's does: ``storage.tear`` before any byte is written (half the
payload lands, nothing is cleaned up and the stray temp is left, as
after a hard kill), ``storage.fsync`` after the write and
``storage.rename`` after the close; each raises ``OSError`` and leaves
the destination untouched.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

from namazu_tpu_torch import chaos

#: suffix every in-flight atomic write carries
TMP_SUFFIX = ".tmp"


def _write_all(fd: int, data) -> None:
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


def atomic_write(path: str, data: bytes, seams: bool = True) -> None:
    """Atomically replace ``path``'s content with ``data``. ``seams=False``
    skips the chaos seam (the failure pool's writes, which the
    reference's pool makes without one)."""
    path = os.path.abspath(path)
    dir_path = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=dir_path,
                               prefix=os.path.basename(path) + ".",
                               suffix=TMP_SUFFIX)
    if seams and chaos.decide("storage.tear") is not None:
        try:
            _write_all(fd, data[: max(1, len(data) // 2)])
        finally:
            os.close(fd)
        raise OSError(f"chaos: write torn mid-flight (left {tmp})")
    try:
        try:
            _write_all(fd, data)
            if seams and chaos.decide("storage.fsync") is not None:
                raise OSError("chaos: injected fsync failure")
            os.fsync(fd)
        finally:
            os.close(fd)
        if seams and chaos.decide("storage.rename") is not None:
            raise OSError("chaos: injected rename failure")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(dir_path)


def atomic_write_json(path: str, obj: Any, **dump_kw) -> None:
    atomic_write(path, json.dumps(obj, **dump_kw).encode())


def _fsync_dir(dir_path: str) -> None:
    """Persist a directory entry (the rename); some filesystems refuse
    a directory fsync, which is then skipped."""
    try:
        fd = os.open(dir_path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
