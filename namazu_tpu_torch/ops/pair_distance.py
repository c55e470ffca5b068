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

A launch is planned on the host by :func:`grid_plan` from the shapes and
the card's SM count and cluster capacity, read once per device: the
feature rows a block owns, and how many blocks of a thread-block cluster
split the walk over the column rows where the feature tiles alone would
leave SMs idle. Occupancies that are
``None``, ints or CPU tensors go to the kernel by value, int32 tensors on
the card by pointer, so a call launches the kernel and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from namazu_tpu_torch.ops import _build

# min-identity that masks rows out of a distance min (rows past a ring's
# occupancy); features live in (0,1)^K, so real d2 <= K
MASK_BIG = 3.4e38

# the kernel's tiling and shared-memory budget (csrc/min_sq_pair.cu)
BK = 32  # k per TMA box
BN = 64  # column rows per tile
WG_ROWS = 64  # feature rows per consumer warpgroup
STAGES = 4
BOX_BYTES = BN * BK * 4
SMEM_LIMIT = 232448  # per block on an H100
MAX_SPLIT = 8  # ranks of a split: the portable cluster size

#: kernel launches made by :func:`min_sq_distance_pair` on CUDA tensors
LAUNCHES = 0
#: kernel launches made by :func:`min_sq_distance` on CUDA tensors
SINGLE_LAUNCHES = 0
# the calling thread's share of both counts, ``n = [pair, single]``
_by_thread = threading.local()

Occupancy = Optional[Union[int, torch.Tensor]]

_fns = None
_cards: Dict[Tuple[int, int], Tuple[int, Tuple[Tuple[int, int, int], ...]]] \
    = {}


def _kernels():
    """``(pair entry, single entry, error string, widest K)`` of the built
    library."""
    global _fns
    if _fns is None:
        lib = _build.load("min_sq_pair")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        pair = lib.nmz_min_sq_pair_f32
        pair.argtypes = [ptr] * 3 + [ptr, i, ptr, i] + [ptr] * 2 + [i] * 6 \
            + [ptr]
        pair.restype = i
        single = lib.nmz_min_sq_f32
        single.argtypes = [ptr] * 2 + [ptr, i] + [ptr] + [i] * 5 + [ptr]
        single.restype = i
        lib.nmz_cuda_error_string.argtypes = [i]
        lib.nmz_cuda_error_string.restype = ctypes.c_char_p
        lib.nmz_min_sq_max_k.argtypes = []
        lib.nmz_min_sq_max_k.restype = i
        _fns = (pair, single, lib.nmz_cuda_error_string,
                lib.nmz_min_sq_max_k())
    return _fns


def max_active_clusters(K: int, consumers: int, split: int) -> int:
    """How many clusters of ``split`` pair-kernel blocks (``consumers``
    warpgroups, width ``K``) the current card holds at once, as its
    occupancy calculator says; raises on an error code."""
    fn = _build.load("min_sq_pair").nmz_min_sq_max_active_clusters
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    n = fn(K, consumers, split)
    if n < 0:
        _raise_if_failed(n, "cudaOccupancyMaxActiveClusters")
    return n


def _smem_bytes(kb: int, consumers: int) -> int:
    """A block's dynamic shared memory, as ``smem_bytes`` in the kernel."""
    return (1024 + kb * consumers * WG_ROWS * BK * 4 + STAGES * 2 * BOX_BYTES
            + STAGES * BN * 4 + (1 + 3 * STAGES) * 8
            + 2 * consumers * WG_ROWS * 4)


class GridPlan(NamedTuple):
    """One launch of B1 or B2: ``row_tiles`` feature tiles of ``bm`` rows,
    each walked by ``split`` blocks (one cluster), rank r over the column
    tiles ``ranges[r]`` (archive tiles first, then failure tiles);
    ``steps`` (column tile, k box) steps for the busiest rank, in
    ``waves`` rounds of the blocks the card runs at once."""

    row_tiles: int
    split: int
    ranges: Tuple[Tuple[int, int], ...]
    bm: int
    steps: int
    waves: int

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.split

    @property
    def consumers(self) -> int:
        return self.bm // WG_ROWS


def _plan(N: int, A: int, F: int, K: int, sms: int, consumers: int,
          clusters: Tuple[Tuple[int, int, int], ...] = ()) -> GridPlan:
    kb = -(-K // BK)
    tiles = -(-A // BN) + -(-F // BN)
    row_tiles = -(-N // (consumers * WG_ROWS))
    known = {(c, s): n for c, s, n in clusters}

    def at_once(split):  # clusters of `split` blocks the card runs at once
        return sms if split == 1 else max(
            1, known.get((consumers, split), sms // split))

    # the fewest tiles a rank among splits that stay one wave, then the
    # fewest ranks; clusters of a power of two
    split, best = 1, tiles
    s = 2
    while s <= min(tiles, MAX_SPLIT):
        if row_tiles <= at_once(s) and -(-tiles // s) < best:
            split, best = s, -(-tiles // s)
        s *= 2
    ranges = tuple((r * tiles // split, (r + 1) * tiles // split)
                   for r in range(split))
    return GridPlan(row_tiles, split, ranges, consumers * WG_ROWS,
                    best * kb, -(-row_tiles // at_once(split)))


@functools.lru_cache(maxsize=256)
def grid_plan(N: int, A: int, F: int, K: int, sms: int,
              clusters: Tuple[Tuple[int, int, int], ...] = ()) -> GridPlan:
    """The launch of B1 (``F`` failure rows; B2: ``F = 0``) for ``N``
    feature rows of width ``K`` against ``A`` archive rows on a card of
    ``sms`` SMs that runs ``n`` clusters of ``split`` blocks of
    ``consumers`` warpgroups at once for each ``(consumers, split, n)`` in
    ``clusters`` (``sms // split`` where none is given; one block an
    SM). Where the row tiles leave SMs idle, the column tiles are split
    over a cluster of ranks: the split with the fewest tiles a rank among
    those whose clusters all run at once, and of those the fewest ranks;
    at most 8 ranks (the portable cluster) and at most the column tiles.
    A block holds 128 feature rows (two consumer warpgroups) or 64 (one),
    whichever plan has fewer steps on its critical path (waves times
    steps a block), 64 on a tie (a step of one warpgroup is shorter); 64
    alone where 128 rows' tile does not fit the shared memory. At the
    main path's shape (16384 rows) that is 128 rows and no split."""
    kb = -(-K // BK)
    plans = [_plan(N, A, F, K, sms, c, clusters) for c in (2, 1)
             if _smem_bytes(kb, c) <= SMEM_LIMIT]
    if not plans:
        raise ValueError(f"feature width K={K} does not fit the kernel's "
                         f"resident tile")
    return min(plans, key=lambda p: (p.waves * p.steps, p.bm))


def card_limits(dev: torch.device, K: int
                ) -> Tuple[int, Tuple[Tuple[int, int, int], ...]]:
    """``(sms, clusters)`` of :func:`grid_plan` for the card ``dev`` at
    width ``K``: its SM count, and how many clusters of 2, 4 and 8 blocks
    of one and of two warpgroups it runs at once (the occupancy
    calculator's answer); read once per device and width."""
    idx = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    card = _cards.get((idx, K))
    if card is None:
        kb = -(-K // BK)
        with torch.cuda.device(idx):
            clusters = tuple(
                (c, s, max_active_clusters(K, c, s)) for c in (1, 2)
                if _smem_bytes(kb, c) <= SMEM_LIMIT for s in (2, 4, 8))
        card = _cards[(idx, K)] = (
            torch.cuda.get_device_properties(idx).multi_processor_count,
            clusters)
    return card


def card_plan(dev: torch.device, N: int, A: int, F: int,
              K: int) -> GridPlan:
    """:func:`grid_plan` on the card ``dev``."""
    return grid_plan(N, A, F, K, *card_limits(dev, K))


def _sq_distances(feats: torch.Tensor, rows: torch.Tensor,
                  n: Occupancy) -> torch.Tensor:
    """``[N, R]`` squared distances by the matmul expansion, the columns
    of rows at or past ``n`` pushed to the mask identity."""
    cross = feats @ rows.T
    f2 = (feats * feats).sum(-1, keepdim=True)
    r2 = (rows * rows).sum(-1)
    if n is not None:
        n = torch.as_tensor(n, device=rows.device)
        live = torch.arange(rows.shape[0], device=rows.device) < n
        r2 = torch.where(live, r2, MASK_BIG)
    return f2 + r2 - 2.0 * cross


def _min_sq_segment(feats: torch.Tensor, rows: torch.Tensor,
                    n: Occupancy) -> torch.Tensor:
    return _sq_distances(feats, rows, n).amin(-1).clamp_min(0.0)


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


def _occupancy(n: Occupancy, cap: int, device
               ) -> Tuple[Optional[torch.Tensor], int]:
    """``(device int32 tensor or None, value)`` for the kernel: an int32
    tensor on ``device`` is read there by the kernel (so a graph capture
    never bakes it in); ``None`` (every row live: ``cap``), an int or a
    CPU tensor go by value; any other tensor is copied to an int32 on
    ``device`` first, one more launch."""
    if n is None:
        return None, cap
    if not isinstance(n, torch.Tensor):
        return None, int(n)
    if n.numel() != 1:
        raise ValueError(f"an occupancy is one int, got shape "
                         f"{tuple(n.shape)}")
    if n.device.type == "cpu":
        return None, int(n)
    if n.device != device or n.dtype != torch.int32:
        n = n.to(device=device, dtype=torch.int32)
    return n, 0


def thread_launches() -> Tuple[int, int]:
    """``(pair, single)``: the launches the calling thread has counted in
    :data:`LAUNCHES` and :data:`SINGLE_LAUNCHES`."""
    return tuple(getattr(_by_thread, "n", (0, 0)))


def _count(which: int) -> None:
    """Count one launch of B1 (``which`` 0) or B2 (1)."""
    global LAUNCHES, SINGLE_LAUNCHES
    n = getattr(_by_thread, "n", None)
    if n is None:
        n = _by_thread.n = [0, 0]
    n[which] += 1
    if which == 0:
        LAUNCHES += 1
    else:
        SINGLE_LAUNCHES += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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


def _launch(feats, archive, failures, archive_n, failure_n,
            plan: Optional[GridPlan] = None):
    """B1 on the card: one launch of the kernel under ``plan`` (default:
    :func:`grid_plan`'s)."""
    _check_all("min_sq_distance_pair", feats, archive, failures)
    (N, K), A, F = feats.shape, archive.shape[0], failures.shape[0]
    dev = feats.device
    nov = torch.empty((N,), dtype=torch.float32, device=dev)
    bug = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return nov, bug
    pair = _kernels()[0]
    plan = plan or card_plan(dev, N, A, F, K)
    an, an_value = _occupancy(archive_n, A, dev)
    fn, fn_value = _occupancy(failure_n, F, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = pair(feats.data_ptr(), archive.data_ptr(), failures.data_ptr(),
                  _ptr(an), an_value, _ptr(fn), fn_value, nov.data_ptr(),
                  bug.data_ptr(), N, A, F, K, plan.consumers, plan.split,
                  stream)
    _raise_if_failed(rc, "min_sq_pair")
    _count(0)
    return nov, bug


def _launch_single(feats, archive, valid_n):
    _check_all("min_sq_distance", feats, archive)
    (N, K), A = feats.shape, archive.shape[0]
    dev = feats.device
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    single = _kernels()[1]
    plan = card_plan(dev, N, A, 0, K)
    vn, vn_value = _occupancy(valid_n, A, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = single(feats.data_ptr(), archive.data_ptr(), _ptr(vn),
                    vn_value, out.data_ptr(), N, A, K, plan.consumers,
                    plan.split, stream)
    _raise_if_failed(rc, "min_sq")
    _count(1)
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
