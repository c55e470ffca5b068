"""Pair distance: the scorer's epilogue, counterpart of
``namazu_tpu/ops/pallas_score.py:157-246``.

``min_sq_distance_pair`` returns, for feature rows ``feats [N, K]``, the
smallest squared distance to the archive rows (novelty) and to the
failure rows (bug affinity) in one pass. On CUDA tensors it launches the
hand-written kernel ``csrc/min_sq_pair.cu`` or raises; on CPU tensors it
runs :func:`min_sq_distance_pair_reference`, the plain PyTorch version
(matmul expansion, one ``amin`` per segment, the same masking).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from namazu_tpu_torch.ops import _build

# min-identity that masks rows out of a distance min (rows past a ring's
# occupancy); features live in (0,1)^K, so real d2 <= K
MASK_BIG = 3.4e38

#: kernel launches made by :func:`min_sq_distance_pair` on CUDA tensors
LAUNCHES = 0

Occupancy = Optional[Union[int, torch.Tensor]]

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("min_sq_pair")
        fn = lib.nmz_min_sq_pair_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.nmz_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nmz_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.nmz_cuda_error_string)
    return _fn


def _min_sq_segment(feats: torch.Tensor, rows: torch.Tensor,
                    n: Occupancy) -> torch.Tensor:
    cross = feats @ rows.T
    f2 = (feats * feats).sum(-1, keepdim=True)
    r2 = (rows * rows).sum(-1)
    if n is not None:
        n = torch.as_tensor(n, device=rows.device)
        live = torch.arange(rows.shape[0], device=rows.device) < n
        r2 = torch.where(live, r2, MASK_BIG)
    return (f2 + r2 - 2.0 * cross).amin(-1).clamp_min(0.0)


def min_sq_distance_pair_reference(
    feats: torch.Tensor, archive: torch.Tensor, failures: torch.Tensor,
    archive_n: Occupancy = None, failure_n: Occupancy = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(min d2 vs archive [N], min d2 vs failures
    [N])``, rows at or past ``archive_n``/``failure_n`` masked."""
    return (_min_sq_segment(feats, archive, archive_n),
            _min_sq_segment(feats, failures, failure_n))


def _occupancy(n: Occupancy, cap: int, device) -> torch.Tensor:
    if n is None:
        return torch.full((1,), cap, dtype=torch.int32, device=device)
    if isinstance(n, torch.Tensor):
        return n.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), int(n), dtype=torch.int32, device=device)


def _check(name: str, t: torch.Tensor, device, K: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, feats on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != K:
        raise ValueError(f"{name} must be [rows, {K}], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(feats, archive, failures, archive_n, failure_n):
    global LAUNCHES
    N, K = feats.shape
    A, F = archive.shape[0], failures.shape[0]
    dev = feats.device
    for name, t in (("feats", feats), ("archive", archive),
                    ("failures", failures)):
        _check(name, t, dev, K)
    if K % 4:
        raise ValueError(f"feature width K={K} must be a multiple of 4")
    if max(N, A, F) * K >= 2 ** 31:
        raise ValueError("min_sq_distance_pair: shapes exceed int32 range")
    nov = torch.empty((N,), dtype=torch.float32, device=dev)
    bug = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return nov, bug
    fn, err_str = _kernel()
    occ = torch.cat([_occupancy(archive_n, A, dev),
                     _occupancy(failure_n, F, dev)])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(feats.data_ptr(), archive.data_ptr(), failures.data_ptr(),
                occ.data_ptr(), nov.data_ptr(), bug.data_ptr(),
                N, A, F, K, stream)
    if rc != 0:
        raise RuntimeError(
            f"min_sq_pair kernel launch failed: {err_str(rc).decode()} "
            f"(cudaError {rc})")
    LAUNCHES += 1
    return nov, bug


def min_sq_distance_pair(
    feats: torch.Tensor, archive: torch.Tensor, failures: torch.Tensor,
    archive_n: Occupancy = None, failure_n: Occupancy = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(nov [N], bug [N])``: min squared distance of each feature row to
    the archive rows and to the failure rows, clamped at >= 0. Rows at or
    past ``archive_n``/``failure_n`` (int or int tensor; ``None`` = all
    rows live) never win a min. An empty archive or failure buffer raises
    ``ValueError``: callers hold fixed-capacity buffers and mask with the
    occupancies instead."""
    if archive.shape[0] == 0 or failures.shape[0] == 0:
        raise ValueError(
            "min_sq_distance_pair: empty archive/failures; use "
            "fixed-capacity buffers with archive_n/failure_n occupancy "
            "masking")
    if feats.device.type == "cpu":
        return min_sq_distance_pair_reference(feats, archive, failures,
                                              archive_n, failure_n)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    return _launch(feats, archive, failures, archive_n, failure_n)
