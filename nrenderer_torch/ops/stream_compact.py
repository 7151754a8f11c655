"""The streaming compactor: a dense, stable pack of the live lanes of a
wavefront (B3a) and its inverse (B3b), with CUDA launch wrappers, plain
torch versions and launch counters.

Counterpart of `nrenderer_tpu/ops/stream_compact.py`.  It serves the
hybrid mesh route twice: the mesh pipe packs the rays that can reach the
mesh before the sweep and unpacks the sweep's results
(`mesh_cuda.intersect_triangles_mesh`), and the staged wavefront packs the
whole ray state into smaller buffers as paths die and banks radiance back
through the chain of packs (`renderers/_wavefront.py`).

The contract, from the JAX package's tests (`tests/test_stream_compact.py`):
the live slots hold exactly the masked lanes (mask channel > 0), here in
lane order; the mask channel reads 0 in every slot past the count (here
every channel does); and `unpack(f(pack(x)))` equals the masked elementwise
`f(x)`, with the given fill per channel on dead lanes.  The TPU layout
(per-tile column packs, 8-row claims, `stream_rows_needed`'s row
arithmetic, the VMEM ring and its flushes) is not ported: the pack is
dense, so its overflow guard is the plain count of live lanes: the
pack's own count, or `stream_lanes_needed` before a pack.  A live lane
whose slot would pass `cap` is dropped; the count still reports it.

Channels are (n,) float32 or int32 tensors and move as raw 32-bit words,
so int32 channels survive bit for bit.  On a CUDA device the wrappers
launch `stream_pack_kernel` / `stream_unpack_kernel`
(`csrc/stream_compact.cu`); on the CPU they run the plain versions;
another device raises."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

KERNEL_SOURCE = "nrenderer_torch/csrc/stream_compact.cu"
PACK = "stream_pack_kernel"
UNPACK = "stream_unpack_kernel"
REPLACES = {
    PACK: "nrenderer_tpu/ops/stream_compact.py:198 _pack_kernel",
    UNPACK: "nrenderer_tpu/ops/stream_compact.py:383 _unpack_kernel",
}

# Calls of the pack (one kernel launch, after a memset of its look-back
# scratch: count, scan, scatter and the clear of the slots past the count
# in one grid) and of the unpack (one launch) that went to the card: a
# caller resets and reads them to show that a run used the kernels.
KERNEL_LAUNCHES = {PACK: 0, UNPACK: 0}

MAX_CHANNELS = 16  # channels one call moves (csrc/stream_compact.cu)
TILE = 4096        # lanes per block of the kernels; the unit of tile_off


def reset_launch_counts() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


class StreamPacked(NamedTuple):
    """A pack and what its unpack needs.  JAX's `n_valid` is
    min(count, cap) here."""
    packed: torch.Tensor    # (C, cap) float32: slot s of channel c
    count: torch.Tensor     # () int32, live lanes (past cap on overflow)
    tile_off: torch.Tensor  # (ceil(n / TILE),) int32 live lanes before tile
    n: int                  # lanes packed
    cap: int


def _words(a: torch.Tensor) -> torch.Tensor:
    """A float32 or int32 (n,) tensor as contiguous int32 words."""
    if a.dim() != 1 or a.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"channels must be 1-D float32 or int32 tensors, "
                         f"got {a.dtype} {tuple(a.shape)}")
    a = a.contiguous()
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _mask(words: torch.Tensor) -> torch.Tensor:
    return words.view(torch.float32) > 0.0


def stream_lanes_needed(mask: torch.Tensor) -> torch.Tensor:
    """Slots a dense pack of `mask` (bool, or float > 0) needs: the number
    of live lanes, a device int32 (the overflow guard's counterpart of
    `stream_rows_needed`)."""
    m = mask if mask.dtype == torch.bool else mask > 0.0
    return m.sum(dtype=torch.int32)


def _tile_offsets(m: torch.Tensor) -> torch.Tensor:
    n = m.shape[0]
    n_tiles = -(-n // TILE)
    cnt = torch.zeros(n_tiles * TILE, dtype=torch.int32, device=m.device)
    cnt[:n] = m.to(torch.int32)
    cnt = cnt.view(n_tiles, TILE).sum(dim=1, dtype=torch.int32)
    return (torch.cumsum(cnt, 0, dtype=torch.int32) - cnt).contiguous()


def _check_pack(channels, cap: int, mask_from: int):
    if not 1 <= len(channels) <= MAX_CHANNELS:
        raise ValueError(f"1 to {MAX_CHANNELS} channels, got {len(channels)}")
    if not 0 <= mask_from < len(channels):
        raise ValueError(f"mask_from {mask_from} out of range")
    words = [_words(a) for a in channels]
    n, dev = words[0].shape[0], words[0].device
    if any(w.shape[0] != n or w.device != dev for w in words):
        raise ValueError("channels must share one length and device")
    if cap < 1 or n >= (1 << 31) - TILE or len(words) * cap >= 1 << 31:
        raise ValueError(f"unsupported cap {cap} or length {n}")
    return words, n, dev


def stream_pack_channels(channels: Sequence[torch.Tensor], cap: int,
                         mask_from: int) -> StreamPacked:
    """Pack the lanes where `channels[mask_from] > 0`, in lane order, into
    slots [0, min(count, cap)) of a (C, cap) buffer; the slots past the
    count read 0.  A CUDA tensor launches `stream_pack_kernel`, a CPU
    tensor runs `stream_pack_plain`."""
    words, n, dev = _check_pack(channels, cap, mask_from)
    if dev.type == "cuda":
        return _pack_cuda(words, n, cap, mask_from)
    if dev.type == "cpu":
        return stream_pack_plain(channels, cap, mask_from)
    raise ValueError(f"unsupported device {dev}")


def stream_pack_plain(channels: Sequence[torch.Tensor], cap: int,
                      mask_from: int) -> StreamPacked:
    """The pack's plain torch version, on any device."""
    words, n, dev = _check_pack(channels, cap, mask_from)
    m = _mask(words[mask_from])
    lanes = torch.nonzero(m).flatten()
    k = min(int(lanes.shape[0]), cap)
    packed = torch.zeros((len(words), cap), dtype=torch.int32, device=dev)
    packed[:, :k] = torch.stack(words)[:, lanes[:k]]
    count = torch.tensor(int(lanes.shape[0]), dtype=torch.int32, device=dev)
    return StreamPacked(packed.view(torch.float32), count, _tile_offsets(m),
                        n, cap)


def _fill_word(miss, dtype: torch.dtype) -> int:
    """The 32-bit word of a fill value in the channel's type."""
    if dtype == torch.int32:
        return int(np.array(miss, np.int32).view(np.uint32))
    return int(np.array(miss, np.float32).view(np.uint32))


def _check_unpack(mask_src, packed, misses, sp: StreamPacked):
    if len(packed) != len(misses) or not 1 <= len(packed) <= MAX_CHANNELS:
        raise ValueError("one fill per channel, 1 to "
                         f"{MAX_CHANNELS} channels")
    if mask_src.dim() != 1 or mask_src.shape[0] != sp.n:
        raise ValueError(f"mask_src must be the pack's ({sp.n},) mask")
    mask = (mask_src if mask_src.dtype == torch.float32
            else mask_src.to(torch.float32)).contiguous()
    words = [_words(a) for a in packed]
    dev = mask.device
    if any(w.shape[0] > sp.cap or w.device != dev for w in words) \
            or sp.tile_off.device != dev:
        raise ValueError(f"packed channels must hold at most cap = {sp.cap} "
                         f"words on the mask's device {dev}")
    dtypes = [a.dtype for a in packed]
    fills = [_fill_word(m, t) for m, t in zip(misses, dtypes)]
    return mask, words, dtypes, fills, dev


def stream_unpack_channels(mask_src: torch.Tensor,
                           packed: Sequence[torch.Tensor],
                           misses: Sequence, sp: StreamPacked
                           ) -> Tuple[torch.Tensor, ...]:
    """Distribute per-slot results back to the lanes of the pack: lane i
    gets `packed[c][slot(i)]` when its mask value > 0 and it has a slot
    below min(count, cap) (0 past a shorter channel's length, as JAX pads),
    else `misses[c]` (a float for a float32 channel, an int for an int32
    one).  `mask_src` is the (n,) mask the pack ran with (float > 0, or
    bool).  Each output has its input channel's dtype.  A CUDA tensor
    launches `stream_unpack_kernel`, a CPU tensor runs the plain version."""
    mask, words, dtypes, fills, dev = _check_unpack(mask_src, packed, misses,
                                                    sp)
    if dev.type == "cuda":
        out = _unpack_cuda(mask, words, fills, sp)
    elif dev.type == "cpu":
        out = _unpack_words_plain(mask, words, fills, sp)
    else:
        raise ValueError(f"unsupported device {dev}")
    return tuple(o.view(t) for o, t in zip(out, dtypes))


def stream_unpack_plain(mask_src: torch.Tensor,
                        packed: Sequence[torch.Tensor], misses: Sequence,
                        sp: StreamPacked) -> Tuple[torch.Tensor, ...]:
    """The unpack's plain torch version, on any device."""
    mask, words, dtypes, fills, _ = _check_unpack(mask_src, packed, misses,
                                                  sp)
    out = _unpack_words_plain(mask, words, fills, sp)
    return tuple(o.view(t) for o, t in zip(out, dtypes))


def _unpack_words_plain(mask, words, fills, sp: StreamPacked):
    m = mask > 0.0
    slot = torch.cumsum(m.to(torch.int32), 0, dtype=torch.int32) - 1
    has_slot = m & (slot < torch.clamp(sp.count, max=sp.cap))
    out = []
    for w, fill in zip(words, fills):
        ok = has_slot & (slot < w.shape[0])
        got = w[torch.clamp(slot, 0, max(w.shape[0] - 1, 0))] \
            if w.shape[0] else torch.zeros_like(slot)
        fw = torch.tensor(np.array(fill, np.uint32).view(np.int32),
                          device=mask.device)
        out.append(torch.where(ok, got, torch.where(has_slot, 0, fw)))
    return out


_bound = None


def _kernels() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from .. import _build
        lib = _build.load_library()
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nr_stream_pack.argtypes = [vp, ci, ci, ci, ci, vp, vp, vp, vp,
                                       vp]
        lib.nr_stream_pack.restype = ci
        lib.nr_stream_unpack.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, ci,
                                         vp, vp]
        lib.nr_stream_unpack.restype = ci
        lib.nr_stream_layout.argtypes = [ci]
        lib.nr_stream_layout.restype = ci
        lib.nr_error_string.argtypes = [ci]
        lib.nr_error_string.restype = ctypes.c_char_p
        if (lib.nr_stream_layout(0), lib.nr_stream_layout(1)) != (
                MAX_CHANNELS, TILE):
            raise RuntimeError("kernel library compactor layout mismatch")
        _bound = lib
    return _bound


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.nr_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err}: {msg}")


def _pack_cuda(words, n: int, cap: int, mask_from: int) -> StreamPacked:
    lib = _kernels()
    dev = words[0].device
    n_tiles = -(-n // TILE)
    packed = torch.empty((len(words), cap), dtype=torch.int32, device=dev)
    # the look-back status words and the block counter (the call clears
    # them), then the results: tile offsets and the count
    status = torch.empty((n_tiles + 1,), dtype=torch.int64, device=dev)
    res = torch.empty((n_tiles + 1,), dtype=torch.int32, device=dev)
    tile_off, count = res[:n_tiles], res[n_tiles]
    ptrs = (ctypes.c_void_p * len(words))(*(w.data_ptr() for w in words))
    with torch.cuda.device(dev):
        err = lib.nr_stream_pack(ptrs, len(words), n, mask_from, cap,
                                 packed.data_ptr(), status.data_ptr(),
                                 tile_off.data_ptr(), count.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, PACK)
    KERNEL_LAUNCHES[PACK] += 1
    return StreamPacked(packed.view(torch.float32), count, tile_off, n, cap)


def _unpack_cuda(mask, words, fills, sp: StreamPacked):
    lib = _kernels()
    n_ch = len(words)
    out = torch.empty((n_ch, sp.n), dtype=torch.int32, device=mask.device)
    ptrs = (ctypes.c_void_p * n_ch)(*(w.data_ptr() for w in words))
    lens = (ctypes.c_int * n_ch)(*(w.shape[0] for w in words))
    fill = (ctypes.c_uint32 * n_ch)(*fills)
    with torch.cuda.device(mask.device):
        err = lib.nr_stream_unpack(mask.data_ptr(), sp.n, n_ch, ptrs, lens,
                                   fill, sp.tile_off.data_ptr(),
                                   sp.count.data_ptr(), sp.cap,
                                   out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, UNPACK)
    KERNEL_LAUNCHES[UNPACK] += 1
    return list(out)
