"""Min squared distances: the scorer's epilogue, counterpart of
``namazu_tpu/ops/pallas_score.py``.

``min_sq_distance_pair`` (B1, ``pallas_score.py:157-246``) returns, for
feature rows ``feats [N, K]``, the smallest squared distance to the
archive rows (novelty) and to the failure rows (bug affinity) in one
pass. ``min_sq_distance`` (B2, ``pallas_score.py:54-103``) is the
one-archive case, masked by ``valid_n``. On CUDA tensors both launch the
hand-written Hopper kernels of ``csrc/min_sq_pair.cu`` (TMA loads, the
cross term in split TF32 on the tensor cores, f32 accuracy) or raise; on
CPU tensors they run the plain PyTorch versions
:func:`min_sq_distance_pair_reference` and
:func:`min_sq_distance_reference` (matmul expansion, one ``amin`` per
segment, the same masking).
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
#: kernel launches made by :func:`min_sq_distance` on CUDA tensors
SINGLE_LAUNCHES = 0

Occupancy = Optional[Union[int, torch.Tensor]]

_fns = None


def _kernels():
    """``(pair entry, single entry, error string, widest K)`` of the built
    library."""
    global _fns
    if _fns is None:
        lib = _build.load("min_sq_pair")
        pair = lib.nmz_min_sq_pair_f32
        pair.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        pair.restype = ctypes.c_int
        single = lib.nmz_min_sq_f32
        single.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        single.restype = ctypes.c_int
        lib.nmz_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nmz_cuda_error_string.restype = ctypes.c_char_p
        lib.nmz_min_sq_max_k.argtypes = []
        lib.nmz_min_sq_max_k.restype = ctypes.c_int
        _fns = (pair, single, lib.nmz_cuda_error_string,
                lib.nmz_min_sq_max_k())
    return _fns


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


def min_sq_distance_reference(feats: torch.Tensor, archive: torch.Tensor,
                              valid_n: Occupancy = None) -> torch.Tensor:
    """Plain PyTorch version of B2: min d2 of each row of ``feats [N, K]``
    to the rows of ``archive [A, K]`` below ``valid_n``."""
    return _min_sq_segment(feats, archive, valid_n)


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


def _check_all(what: str, feats: torch.Tensor, *rows: torch.Tensor
               ) -> None:
    N, K = feats.shape
    dev = feats.device
    _check("feats", feats, dev, K)
    for i, t in enumerate(rows):
        _check(("archive", "failures")[i], t, dev, K)
    if K % 4:
        # TMA rows: a 16-byte aligned base (checked above) and a row
        # stride of 4*K bytes, a multiple of 16
        raise ValueError(f"feature width K={K} must be a multiple of 4")
    max_k = _kernels()[3]
    if K > max_k:
        raise ValueError(f"feature width K={K} exceeds {max_k}, the widest "
                         f"feature tile the kernel keeps resident")
    if max(N, *(t.shape[0] for t in rows)) * K >= 2 ** 31:
        raise ValueError(f"{what}: shapes exceed int32 range")


def _raise_if_failed(rc: int, what: str) -> None:
    if rc != 0:
        err_str = _kernels()[2]
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{err_str(rc).decode()} (code {rc})")


def _launch(feats, archive, failures, archive_n, failure_n):
    global LAUNCHES
    _check_all("min_sq_distance_pair", feats, archive, failures)
    (N, K), A, F = feats.shape, archive.shape[0], failures.shape[0]
    dev = feats.device
    nov = torch.empty((N,), dtype=torch.float32, device=dev)
    bug = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return nov, bug
    pair = _kernels()[0]
    occ = torch.cat([_occupancy(archive_n, A, dev),
                     _occupancy(failure_n, F, dev)])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = pair(feats.data_ptr(), archive.data_ptr(), failures.data_ptr(),
                  occ.data_ptr(), nov.data_ptr(), bug.data_ptr(),
                  N, A, F, K, stream)
    _raise_if_failed(rc, "min_sq_pair")
    LAUNCHES += 1
    return nov, bug


def _launch_single(feats, archive, valid_n):
    global SINGLE_LAUNCHES
    _check_all("min_sq_distance", feats, archive)
    (N, K), A = feats.shape, archive.shape[0]
    dev = feats.device
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    single = _kernels()[1]
    occ = _occupancy(valid_n, A, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = single(feats.data_ptr(), archive.data_ptr(), occ.data_ptr(),
                    out.data_ptr(), N, A, K, stream)
    _raise_if_failed(rc, "min_sq")
    SINGLE_LAUNCHES += 1
    return out


def _device_route(feats: torch.Tensor) -> str:
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")
    return feats.device.type


def min_sq_distance(feats: torch.Tensor, archive: torch.Tensor,
                    valid_n: Occupancy = None) -> torch.Tensor:
    """``[N]``: min squared distance of each feature row to the archive
    rows, clamped at >= 0; rows at or past ``valid_n`` (int or int
    tensor; ``None`` = all live) never win the min, and with none live
    the result is the mask identity 3.4e38. An empty archive raises
    ``ValueError``, as the reference's Pallas kernel does."""
    if archive.shape[0] == 0:
        raise ValueError(
            "min_sq_distance: empty archive; use a fixed-capacity buffer "
            "with valid_n occupancy masking")
    if _device_route(feats) == "cpu":
        return min_sq_distance_reference(feats, archive, valid_n)
    return _launch_single(feats, archive, valid_n)


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
    if _device_route(feats) == "cpu":
        return min_sq_distance_pair_reference(feats, archive, failures,
                                              archive_n, failure_n)
    return _launch(feats, archive, failures, archive_n, failure_n)
