"""Triangle binning: the CUDA kernels of csrc/binning.cu on the card.

Replaces the eager binners of ops/binning.py on every pass's path (the port
of ash_tpu/ops/binning.py:57 and :142, jax.numpy that XLA fuses; not TPU
kernels), which build a dense (tiles, T) overlap matrix and compact each
row with torch.topk. Two entries, with the plain functions' signatures and
their `TileBins` (int32 contiguous (tiles, max_per_tile) ids, ascending and
-1 padded; int32 counts clamped to max_per_tile; a 0-dim int32 overflow):

- `bin_triangles(...)`: one level, three kernel launches;
- `bin_triangles_two_level(...)`: the coarse level into coarse lists, then
  the fine level over each coarse tile's list, six launches.

- CUDA tensors launch the hand-written kernels (built by ops/_build.py at
  first use) or raise; nothing falls back.
- CPU tensors run the plain version (ops/binning.py) unchanged;
  `check_inputs` says what the card takes and runs on CPU tensors too.
- A keep score ("nearest") goes to the kernels as it is: they rank by a
  64-bit key of the score and the id, in `_keep_rank`'s order (a stable
  argsort, which the plain binner takes on either device), with no sort.
- No host sync: every output and scratch buffer is sized from Python ints,
  and the overflow is zeroed on the stream, so a frame can be captured.

`launches["dense"]` and `launches["two_level"]` count the entries' calls on
the card (and nothing else), so a run can show that its frames went through
the kernels. Each callable in `observers` is handed every call's input and
output tensors (render/cost_analysis.py counts their bytes).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, binning
from .binning import TileBins, grid_shape

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

launches = {"dense": 0, "two_level": 0}
observers = []

# Items a chunk of the count and write kernels (csrc/binning.cu kMaxChunk),
# halved down to MIN_CHUNK while a level has fewer than two blocks an SM.
CHUNK = 256
MIN_CHUNK = 64
# The most tiles a side of a dense level's grid (the kernels keep a tile
# range in 16 bits a bound).
MAX_GRID_SIDE = 65535
# The largest value of a 32-bit index or count.
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("binning")
    lib.ash_bin_level.argtypes = (
        [_I, _I, _P, _P, _P, _I, _I, _I] + [_F] * 5 + [_P, _P] + [_I] * 11
        + [_P] * 6 + [_P])
    lib.ash_bin_level.restype = _I
    return lib


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"binning kernel: {name} is not a tensor")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"binning kernel: {name} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device}; expected {dtype} {shape} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"binning kernel: {name} must be contiguous")


def check_inputs(bbox, valid, height, width, tile_h, tile_w, max_per_tile,
                 y0=0, keep_score=None, coarse_tiles=None,
                 coarse_cap=None) -> None:
    """Raise ValueError unless a binner's inputs are what the kernels take:
    f32 `bbox` (T, 4) and bool `valid` (T,), contiguous, on one device;
    `keep_score` None or a contiguous f32 (T,); ints `height`, `width`,
    `tile_h`, `tile_w`, `max_per_tile` above 0 and `y0`; for the two-level
    binner (`coarse_tiles` given) two ints above 0 and `coarse_cap` above
    0; every list, count and index within 32 bits; a dense grid (the
    dense binner's, or the two-level binner's coarse one) of at most
    MAX_GRID_SIDE tiles a side. Both devices check, so a CPU run shows what
    the card would refuse."""
    if not isinstance(bbox, torch.Tensor) or bbox.dim() != 2:
        raise ValueError("binning kernel: bbox must be a (T, 4) tensor")
    device = bbox.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"binning kernel: unsupported device {device}")
    t = int(bbox.shape[0])
    _check("bbox", bbox, torch.float32, (t, 4), device)
    _check("valid", valid, torch.bool, (t,), device)
    if keep_score is not None:
        _check("keep_score", keep_score, torch.float32, (t,), device)
    for name, v in (("height", height), ("width", width), ("tile_h", tile_h),
                    ("tile_w", tile_w), ("max_per_tile", max_per_tile)):
        if not (_is_int(v) and 0 < int(v) <= _INT_MAX):
            raise ValueError(f"binning kernel: {name} {v!r} is not an int "
                             "above 0")
    if not _is_int(y0) or abs(int(y0)) > _INT_MAX:
        raise ValueError(f"binning kernel: y0 {y0!r} is not a 32-bit int")
    if t == 0:
        raise ValueError("binning kernel: no triangles; the kernels take 1 "
                         "to 2^29")
    ty, tx = grid_shape(int(height), int(width), int(tile_h), int(tile_w))
    # (tiles of a level, its chunks, its largest pixel coordinate)
    levels = [(ty * tx, -(-t // CHUNK), 0)]
    if coarse_tiles is not None:
        if not (isinstance(coarse_tiles, (tuple, list))
                and len(coarse_tiles) == 2
                and all(_is_int(c) and 0 < int(c) <= _INT_MAX
                        for c in coarse_tiles)):
            raise ValueError(f"binning kernel: coarse_tiles {coarse_tiles!r} "
                             "is not two ints above 0")
        if not (_is_int(coarse_cap) and 0 < int(coarse_cap) <= _INT_MAX):
            raise ValueError(f"binning kernel: coarse_cap {coarse_cap!r} is "
                             "not an int above 0")
        cy_f, cx_f = map(int, coarse_tiles)
        ty_p, tx_p = -(-ty // cy_f) * cy_f, -(-tx // cx_f) * cx_f
        kc = min(int(coarse_cap), t)
        levels = [((ty_p // cy_f) * (tx_p // cx_f), -(-t // CHUNK), 0),
                  (ty_p * tx_p, -(-kc // CHUNK),
                   max(tx_p * int(tile_w), ty_p * int(tile_h) + abs(int(y0))))]
    if (t * 4 > _INT_MAX or ty * tx * int(max_per_tile) > _INT_MAX
            or any(max(tiles * chunks, pixels) > _INT_MAX
                   for tiles, chunks, pixels in levels)):
        raise ValueError("binning kernel: 32-bit index range exceeded")
    dense = (ty, tx) if coarse_tiles is None else (ty_p // cy_f, tx_p // cx_f)
    if max(dense) > MAX_GRID_SIDE:
        raise ValueError(f"binning kernel: a dense grid of {dense[0]} x "
                         f"{dense[1]} tiles; the kernels take at most "
                         f"{MAX_GRID_SIDE} a side")


def _f32(x) -> float:
    """A host int as PyTorch's CUDA kernels take a CPU scalar operand: as
    an f32."""
    return float(np.float32(x))


def _reciprocal(n: int) -> float:
    """1.0f / f32(n), as PyTorch divides a CUDA tensor by a host scalar
    (the product with its f32 reciprocal)."""
    return float(np.float32(1.0) / np.float32(n))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _int32(n, device):
    return torch.empty(n, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _fill_blocks(index) -> int:
    """Two blocks an SM of CUDA device `index`."""
    return 2 * torch.cuda.get_device_properties(index).multi_processor_count


def chunk_size(groups: int, items: int, fill: int) -> int:
    """Items a chunk of a level with `groups` groups of `items` items:
    CHUNK, halved down to MIN_CHUNK while the level has fewer than `fill`
    chunks."""
    chunk = CHUNK
    while chunk > MIN_CHUNK and groups * -(-items // chunk) < fill:
        chunk //= 2
    return chunk


def _dense_args(bbox, valid, score, height, width, tile_h, tile_w, K, y0,
                zero_overflow, ids, counts, overflow):
    """ash_bin_level's arguments for a dense level, with its scratch."""
    t = int(bbox.shape[0])
    ty, tx = grid_shape(height, width, tile_h, tile_w)
    chunk = chunk_size(1, t, _fill_blocks(bbox.device.index))
    chunks = -(-t // chunk)
    cnt = _int32(ty * tx * chunks, bbox.device)
    total = _int32(ty * tx, bbox.device)
    memo = _int32(2 * t, bbox.device)  # each triangle's tile range
    return (0, zero_overflow, bbox.data_ptr(), valid.data_ptr(), _ptr(score),
            t, ty, tx, _reciprocal(tile_h), _reciprocal(tile_w), _f32(y0),
            _f32(y0 + height), _f32(width), None, None, 0, 1, 1, 1, 1, 1, 1,
            0, K, chunk, chunks, cnt.data_ptr(), total.data_ptr(),
            memo.data_ptr(), ids.data_ptr(), counts.data_ptr(),
            overflow.data_ptr()), (cnt, total, memo)


def launcher(bbox, valid, height, width, tile_h, tile_w, max_per_tile, y0=0,
             keep_score=None, coarse_tiles=None, coarse_cap=None):
    """Check a binner's inputs on a CUDA device and return (launch,
    TileBins): `launch()` runs the dense binner (`coarse_tiles` None) or
    the two-level one once on the current stream, writing the TileBins'
    tensors, and counts nothing. The entry points count; this split lets a
    timing loop replay the bare launches."""
    check_inputs(bbox, valid, height, width, tile_h, tile_w, max_per_tile,
                 y0, keep_score, coarse_tiles, coarse_cap)
    device = bbox.device
    if device.type != "cuda":
        raise ValueError(f"binning kernel: unsupported device {device}")
    height, width, tile_h, tile_w, K, y0 = map(
        int, (height, width, tile_h, tile_w, max_per_tile, y0))
    t = int(bbox.shape[0])
    ty, tx = grid_shape(height, width, tile_h, tile_w)
    ids = _int32((ty * tx, K), device)
    counts = _int32(ty * tx, device)
    overflow = _int32((), device)
    entry = _library().ash_bin_level
    if coarse_tiles is None:
        args, scratch = _dense_args(bbox, valid, keep_score, height, width,
                                    tile_h, tile_w, K, y0, 1, ids, counts,
                                    overflow)
        levels = [args]
    else:
        cy_f, cx_f = map(int, coarse_tiles)
        ty_p, tx_p = -(-ty // cy_f) * cy_f, -(-tx // cx_f) * cx_f
        cy, cx = ty_p // cy_f, tx_p // cx_f
        kc = min(int(coarse_cap), t)
        cand = _int32((cy * cx, kc), device)
        ccount = _int32(cy * cx, device)
        coarse, scratch = _dense_args(
            bbox, valid, keep_score, ty_p * tile_h, tx_p * tile_w,
            tile_h * cy_f, tile_w * cx_f, kc, y0, 1, cand, ccount, overflow)
        chunk = chunk_size(cy * cx, kc, _fill_blocks(device.index))
        chunks = -(-kc // chunk)
        cnt = _int32(cy * cx * chunks * cy_f * cx_f, device)
        total = _int32(cy * cx * cy_f * cx_f, device)
        # Each warp's hit mask a fine tile.
        memo = _int32(cy * cx * chunks * cy_f * cx_f * (chunk // 32), device)
        fine = (1, 0, bbox.data_ptr(), None, _ptr(keep_score), t, cy, cx,
                0.0, 0.0, 0.0, 0.0, 0.0, cand.data_ptr(), ccount.data_ptr(),
                kc, cy_f, cx_f, ty, tx, tile_h, tile_w, y0, K, chunk, chunks,
                cnt.data_ptr(), total.data_ptr(), memo.data_ptr(),
                ids.data_ptr(), counts.data_ptr(), overflow.data_ptr())
        levels = [coarse, fine]
        scratch += (cand, ccount, cnt, total, memo)
    launch = functools.partial(_launch, device, entry, levels,
                               scratch + (bbox, valid, keep_score))
    return launch, TileBins(tri_ids=ids, counts=counts, overflow=overflow)


def _launch(device, entry, levels, buffers) -> None:
    """One ash_bin_level call a level; `buffers` (the tensors the calls
    point into) stay alive as long as the launch."""
    for args in levels:
        err = _build.launch(device, entry, *args)
        if err != 0:
            raise RuntimeError(f"binning kernel launch failed: CUDA error "
                               f"{err}")


def _run(kind, bbox, valid, height, width, tile_h, tile_w, max_per_tile, y0,
         keep_score, coarse_tiles=None, coarse_cap=None) -> TileBins:
    launch, bins = launcher(bbox, valid, height, width, tile_h, tile_w,
                            max_per_tile, y0, keep_score, coarse_tiles,
                            coarse_cap)
    launch()
    launches[kind] += 1
    if observers:
        inputs = (bbox, valid) + (() if keep_score is None else (keep_score,))
        for fn in observers:
            fn(inputs, tuple(bins))
    return bins


def bin_triangles(
    bbox: torch.Tensor,  # (T, 4) fb-space [x0, y0, x1, y1]
    valid: torch.Tensor,  # (T,) bool
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    max_per_tile: int,
    y0: int = 0,
    keep_score: torch.Tensor | None = None,  # (T,) f32: keep HIGHEST
) -> TileBins:
    """ops/binning.py's bin_triangles (same arguments, same TileBins). On
    the card three launches, array for array the plain version; on the CPU
    the plain version itself."""
    if bbox.device.type == "cpu":
        return binning.bin_triangles(bbox, valid, height, width, tile_h,
                                     tile_w, max_per_tile, y0=y0,
                                     keep_score=keep_score)
    return _run("dense", bbox, valid, height, width, tile_h, tile_w,
                max_per_tile, y0, keep_score)


def bin_triangles_two_level(
    bbox: torch.Tensor,  # (T, 4) fb-space [x0, y0, x1, y1]
    valid: torch.Tensor,  # (T,) bool
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    max_per_tile: int,
    y0: int = 0,
    coarse_tiles: tuple = (4, 2),  # fine tiles per coarse tile (y, x)
    coarse_cap: int = 16384,
    keep_score: torch.Tensor | None = None,  # (T,) f32: keep HIGHEST
) -> TileBins:
    """ops/binning.py's bin_triangles_two_level (same arguments, same
    TileBins). On the card six launches, array for array the plain
    version; on the CPU the plain version itself."""
    if bbox.device.type == "cpu":
        return binning.bin_triangles_two_level(
            bbox, valid, height, width, tile_h, tile_w, max_per_tile, y0=y0,
            coarse_tiles=coarse_tiles, coarse_cap=coarse_cap,
            keep_score=keep_score)
    return _run("two_level", bbox, valid, height, width, tile_h, tile_w,
                max_per_tile, y0, keep_score, coarse_tiles, coarse_cap)
