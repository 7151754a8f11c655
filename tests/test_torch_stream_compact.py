"""The streaming compactor (B3a pack, B3b unpack): the port's plain versions
against the JAX package's Pallas compactor in interpret mode, on the masks
of `tests/test_stream_compact.py` (random 20% and 35%, empty, full,
lane-striped, one lane, the tail) at a lane count that is not a multiple of
128.

The layouts differ by design: JAX packs per (rows, 128) tile and column
with 8-row claims, the port packs densely in lane order.  What both must
give is the contract: the live slots hold exactly the masked lanes (the
port's in lane order), the mask channel reads 0 past the count, and
`unpack(f(pack(x)))` is the masked elementwise `f(x)` with the fills
elsewhere; the port's round trip equals JAX's bit for bit.  The JAX side
runs at NR_STREAM_ROWS=64, as its own tests do.

The `cuda` test (a GPU; it skips without one) holds the kernels against
the plain versions, on these masks at 50,000 lanes and on the kernels' own
edges at 2^22 + 37 lanes (1025 tiles): random 40%, live lanes only in
every 37th tile, dead mask words of -0.0 and NaN; each at caps with and
without overflow, count == cap and count == cap + 1, and a cut inside a
tile, each pack called twice in a row on the same scratch sizes:
`python -m pytest tests/test_torch_stream_compact.py -m cuda`."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nrenderer_torch.ops import stream_compact as sc

ROWS = 64
N = 2 * ROWS * 128 + 1000   # not a multiple of 128
MASKS = ["random_20", "random_35", "empty", "full", "striped", "one",
         "tail"]
EDGE_MASKS = ["many_tiles", "sparse_tiles", "nan_zero"]


def make_mask(name: str, n: int = N) -> np.ndarray:
    rng = np.random.default_rng(2)
    return {
        "random_20": rng.random(n) < 0.2,
        "random_35": rng.random(n) < 0.35,
        "empty": np.zeros(n, bool),
        "full": np.ones(n, bool),
        "striped": (np.arange(n) % 128) < 20,
        "one": np.eye(1, n, 777, dtype=bool)[0],
        "tail": np.arange(n) >= n - 130,
        "many_tiles": rng.random(n) < 0.4,
        # live lanes only in every 37th tile, after 36 empty ones
        "sparse_tiles": ((np.arange(n) // sc.TILE) % 37 == 36)
        & (rng.random(n) < 0.5),
        "nan_zero": rng.random(n) < 0.3,
    }[name]


# every word a float reads as not > 0: both zeros, NaNs of either sign,
# negatives
DEAD_WORDS = np.array([-0.0, np.nan, -np.nan, 0.0, -1.0, -np.inf],
                      np.float32)


def _channels(m: np.ndarray, k: int = 2, dead: bool = False):
    """k random float channels and a t_cap-like mask channel (1 where
    live, 0 elsewhere; with `dead`, DEAD_WORDS in turn elsewhere), as
    numpy."""
    rng = np.random.default_rng(1)
    chans = [rng.standard_normal(m.shape[0]).astype(np.float32)
             for _ in range(k)]
    off = DEAD_WORDS[np.arange(m.shape[0]) % len(DEAD_WORDS)] if dead \
        else np.float32(0.0)
    return chans + [np.where(m, np.float32(1.0), off).astype(np.float32)]


@pytest.fixture
def jax_stream(monkeypatch):
    pytest.importorskip("jax")
    monkeypatch.setenv("NR_STREAM_ROWS", str(ROWS))
    import jax.numpy as jnp
    from nrenderer_tpu.ops import stream_compact as jsc

    def round_trip(chans, f, misses):
        m = jnp.asarray(chans[-1]) > 0
        cap = max(128, (int(jsc.stream_rows_needed(m)) + ROWS) * 128)
        sp = jsc.stream_pack_channels([jnp.asarray(c) for c in chans], cap,
                                      mask_from=len(chans) - 1)
        outs = jsc.stream_unpack_channels(
            jnp.asarray(chans[-1]), [f(p) for p in sp.packed], misses, sp)
        return [np.asarray(o) for o in outs]

    return round_trip


@pytest.mark.parametrize("name", MASKS)
def test_pack_holds_the_masked_lanes_in_lane_order(name):
    m = make_mask(name)
    chans = [torch.as_tensor(c) for c in _channels(m)]
    live = np.nonzero(m)[0]
    cap = max(1, len(live) + 300)
    sp = sc.stream_pack_channels(chans, cap, mask_from=2)
    assert int(sp.count) == len(live) == int(sc.stream_lanes_needed(
        torch.as_tensor(m)))
    assert sp.cap == cap and sp.n == N
    assert tuple(sp.packed.shape) == (3, cap) and sp.packed.dtype == \
        torch.float32
    for c, ch in enumerate(chans):
        np.testing.assert_array_equal(sp.packed[c, :len(live)].numpy(),
                                      ch.numpy()[live])
    # every slot past the count reads 0: dead rays wherever consumed
    assert (sp.packed[:, len(live):] == 0).all()
    # each tile's offset is the live lanes before it
    n_tiles = -(-N // sc.TILE)
    pad = np.zeros(n_tiles * sc.TILE, bool)
    pad[:N] = m
    cnt = pad.reshape(n_tiles, sc.TILE).sum(axis=1)
    np.testing.assert_array_equal(sp.tile_off.numpy(),
                                  np.cumsum(cnt) - cnt)


@pytest.mark.parametrize("name", MASKS)
def test_round_trip_matches_jax(jax_stream, name):
    """unpack(f(pack(x))) equals JAX's round trip bit for bit and the
    masked elementwise f(x) with the fills on dead lanes."""
    m = make_mask(name)
    chans = _channels(m)
    misses = [-7.0, 5.0, 0.0]
    f = lambda p: p * 2.0 + 1.0
    want = jax_stream(chans, f, misses)
    sp = sc.stream_pack_channels([torch.as_tensor(c) for c in chans],
                                 max(1, int(m.sum())), mask_from=2)
    got = sc.stream_unpack_channels(torch.as_tensor(chans[-1]),
                                    [f(p) for p in sp.packed], misses, sp)
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy().view(np.int32),
                                      want[c].view(np.int32))
        np.testing.assert_array_equal(
            got[c].numpy(), np.where(m, f(chans[c]), np.float32(misses[c])))


def test_int32_words_survive_bit_for_bit():
    """int32 channels (pixel ids, sample indices, winner ids) and odd float
    bit patterns (NaN payloads, -0.0, denormals) move as raw words, and an
    int32 channel's fill is an int32."""
    rng = np.random.default_rng(5)
    n = 3000
    m = rng.random(n) < 0.5
    ints = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    ints[:4] = [-1, 2**31 - 1, -2**31, 0]
    odd = rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32).copy()
    odd[:3] = np.array([0x7FC12345, 0x80000000, 0x00000001],
                       np.uint32).view(np.float32)
    keep = np.where(m, 1.0, 0.0).astype(np.float32)
    chans = [torch.as_tensor(ints), torch.as_tensor(odd),
             torch.as_tensor(keep)]
    sp = sc.stream_pack_channels(chans, n, mask_from=2)
    live = np.nonzero(m)[0]
    np.testing.assert_array_equal(
        sp.packed[0, :len(live)].view(torch.int32).numpy(), ints[live])
    np.testing.assert_array_equal(
        sp.packed[1, :len(live)].view(torch.int32).numpy(),
        odd.view(np.int32)[live])
    out = sc.stream_unpack_channels(
        chans[2], [sp.packed[0].view(torch.int32), sp.packed[1]],
        [-1, float("nan")], sp)
    assert out[0].dtype == torch.int32 and out[1].dtype == torch.float32
    np.testing.assert_array_equal(out[0].numpy(), np.where(m, ints, -1))
    np.testing.assert_array_equal(out[1].numpy().view(np.int32)[m],
                                  odd.view(np.int32)[m])
    assert np.isnan(out[1].numpy()[~m]).all()


def test_overflow_drops_the_excess_and_reports_the_count():
    """A cap below the live count keeps the first `cap` live lanes, never
    writes past the buffer, reports the true count, and the unpack gives
    the dropped lanes their fill."""
    m = make_mask("random_35")
    chans = [torch.as_tensor(c) for c in _channels(m)]
    live = np.nonzero(m)[0]
    cap = len(live) // 3
    sp = sc.stream_pack_channels(chans, cap, mask_from=2)
    assert int(sp.count) == len(live) > sp.cap == cap
    assert tuple(sp.packed.shape) == (3, cap)
    np.testing.assert_array_equal(sp.packed[0].numpy(),
                                  chans[0].numpy()[live[:cap]])
    out = sc.stream_unpack_channels(chans[2], [sp.packed[0]], [-3.0], sp)[0]
    kept = np.zeros(N, bool)
    kept[live[:cap]] = True
    np.testing.assert_array_equal(out.numpy(),
                                  np.where(kept, chans[0].numpy(), -3.0))


def test_shorter_result_channels_read_zero_past_their_length():
    """A result channel shorter than the cap (the sweep over the live
    prefix only) reads 0 past its length, as JAX zero-pads."""
    m = make_mask("random_20")
    chans = [torch.as_tensor(c) for c in _channels(m)]
    k = int(m.sum())
    sp = sc.stream_pack_channels(chans, k + 500, mask_from=2)
    half = sp.packed[0, :k // 2] + 1.0
    out = sc.stream_unpack_channels(chans[2], [half], [9.0], sp)[0].numpy()
    live = np.nonzero(m)[0]
    np.testing.assert_array_equal(out[live[:k // 2]],
                                  chans[0].numpy()[live[:k // 2]] + 1.0)
    assert (out[live[k // 2:]] == 0.0).all() and (out[~m] == 9.0).all()


def test_bool_mask_and_empty_input():
    m = make_mask("striped")
    chans = [torch.as_tensor(c) for c in _channels(m)]
    sp = sc.stream_pack_channels(chans, 4096, mask_from=2)
    a = sc.stream_unpack_channels(torch.as_tensor(m), [sp.packed[0]], [0.0],
                                  sp)[0]
    b = sc.stream_unpack_channels(chans[2], [sp.packed[0]], [0.0], sp)[0]
    assert torch.equal(a, b)
    empty = sc.stream_pack_channels([torch.zeros(0), torch.zeros(0)], 8, 1)
    assert int(empty.count) == 0 and (empty.packed == 0).all()
    assert sc.stream_unpack_channels(torch.zeros(0), [empty.packed[0]],
                                     [1.0], empty)[0].shape == (0,)


def test_refusals():
    x = torch.ones(10)
    with pytest.raises(ValueError, match="float32 or int32"):
        sc.stream_pack_channels([x, x.double()], 4, 0)
    with pytest.raises(ValueError, match="channels"):
        sc.stream_pack_channels([x] * (sc.MAX_CHANNELS + 1), 4, 0)
    with pytest.raises(ValueError, match="mask_from"):
        sc.stream_pack_channels([x], 4, 1)
    with pytest.raises(ValueError, match="length"):
        sc.stream_pack_channels([x, torch.ones(9)], 4, 0)
    with pytest.raises(ValueError, match="cap"):
        sc.stream_pack_channels([x], 0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        sc.stream_pack_channels([torch.ones(10, device="meta")], 4, 0)
    sp = sc.stream_pack_channels([x], 4, 0)
    with pytest.raises(ValueError, match="at most cap"):
        sc.stream_unpack_channels(x, [torch.ones(5)], [0.0], sp)
    with pytest.raises(ValueError, match="one fill per channel"):
        sc.stream_unpack_channels(x, [torch.ones(4)], [0.0, 1.0], sp)


def test_kernel_source_layout_matches_the_wrapper():
    """TILE and MAX_CHANNELS in csrc/stream_compact.cu are the wrapper's
    (the library's own check runs only where it loads, on the card)."""
    src = (Path(sc.__file__).resolve().parents[1] / "csrc"
           / "stream_compact.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const("TILE") == sc.TILE
    assert const("MAX_CHANNELS") == sc.MAX_CHANNELS


@pytest.mark.parametrize("shift", [-1, 0, 1])
def test_plain_overflow_at_a_tile_boundary(shift):
    """The plain pack and unpack at TILE: the cap falls on the first live
    lane of tile 2 (shift 0) or one lane either side; tile offsets count
    per TILE lanes, the kept lanes are the first `cap` live ones, the
    dropped ones unpack to their fill."""
    n = 3 * sc.TILE + 100
    m = np.ones(n, bool)
    m[5:sc.TILE:7] = False           # some dead lanes in tile 0
    m[sc.TILE + 3] = False
    live = np.nonzero(m)[0]
    cap = int(np.searchsorted(live, 2 * sc.TILE)) + shift
    chans = [torch.as_tensor(c) for c in _channels(m)]
    sp = sc.stream_pack_channels(chans, cap, mask_from=2)
    assert int(sp.count) == len(live) > cap
    np.testing.assert_array_equal(sp.packed[0].numpy(),
                                  chans[0].numpy()[live[:cap]])
    cnt = np.add.reduceat(np.r_[m, np.zeros(-n % sc.TILE, bool)],
                          np.arange(0, n + (-n % sc.TILE), sc.TILE))
    np.testing.assert_array_equal(sp.tile_off.numpy(), np.cumsum(cnt) - cnt)
    assert int(sp.tile_off[2]) == cap - shift
    out = sc.stream_unpack_channels(chans[2], [sp.packed[0], sp.packed[1]],
                                    [-3.0, 4.0], sp)
    kept = np.zeros(n, bool)
    kept[live[:cap]] = True
    for c, fill in ((0, -3.0), (1, 4.0)):
        np.testing.assert_array_equal(
            out[c].numpy(), np.where(kept, chans[c].numpy(), fill))


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", MASKS + EDGE_MASKS)
def test_cuda_kernels_match_plain(gpu, name):
    """stream_pack_kernel and stream_unpack_kernel against the plain
    versions on the same CUDA tensors, bit for bit, with an int32 word
    channel, at caps with and without overflow: count == cap, count == cap
    + 1, a cut inside a tile; each pack twice in a row (the look-back
    scratch is cleared every call)."""
    n = 50_000 if name in MASKS else (1 << 22) + 37
    m = make_mask(name, n)
    chans = [torch.as_tensor(c, device=gpu)
             for c in _channels(m, 4, dead=name == "nan_zero")]
    chans.append(torch.arange(n, dtype=torch.int32, device=gpu))
    live = np.nonzero(m)[0]
    mid = (n // sc.TILE // 2) * sc.TILE + sc.TILE // 2 + 1
    caps = {n, 4096, max(1, len(live)), max(1, len(live) - 1),
            max(1, int(np.searchsorted(live, mid)))}
    for cap in sorted(caps):
        for _ in range(2):
            before = dict(sc.KERNEL_LAUNCHES)
            k = sc.stream_pack_channels(chans, cap, mask_from=4)
            p = sc.stream_pack_plain(chans, cap, mask_from=4)
            assert sc.KERNEL_LAUNCHES[sc.PACK] == before[sc.PACK] + 1
            assert torch.equal(k.packed.view(torch.int32),
                               p.packed.view(torch.int32))
            assert int(k.count) == int(p.count) == len(live)
            assert torch.equal(k.tile_off, p.tile_off)
        res = [k.packed[c] for c in range(5)] + [
            k.packed[5].view(torch.int32)]
        fills = [0.0, -1.0, 2.0, 3.0, 0.0, -1]
        ku = sc.stream_unpack_channels(chans[4], res, fills, k)
        pu = sc.stream_unpack_plain(chans[4], res, fills, p)
        assert sc.KERNEL_LAUNCHES[sc.UNPACK] == before[sc.UNPACK] + 1
        for a, b in zip(ku, pu):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
