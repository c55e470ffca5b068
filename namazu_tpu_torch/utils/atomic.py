"""Crash-safe file writes: the port's own copy of
``namazu_tpu/utils/atomic.py``.

The data goes to a sibling temp file (``<name>.<random>.tmp``), which is
``fsync``ed and renamed onto the destination (atomic on POSIX within one
filesystem); then the directory is ``fsync``ed, best effort, so the
rename itself survives a crash. At every instant the destination holds
either its complete previous content or the complete new content. A
hard kill can leave a stray ``.tmp``; pool checks (``pool_fsck``) sweep
those.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

#: suffix every in-flight atomic write carries
TMP_SUFFIX = ".tmp"


def atomic_write(path: str, data: bytes) -> None:
    """Atomically replace ``path``'s content with ``data``."""
    path = os.path.abspath(path)
    dir_path = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=dir_path,
                               prefix=os.path.basename(path) + ".",
                               suffix=TMP_SUFFIX)
    try:
        try:
            view = memoryview(data)
            while view:
                view = view[os.write(fd, view):]
            os.fsync(fd)
        finally:
            os.close(fd)
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
