"""The port's counter-based hash against the JAX package's, bit for bit.

Every random number of the path tracer comes from `hash_uniform(pixel,
sample, draw, seed)`; bit-equality is what lets the port's render be held
pixel by pixel against the Pallas kernel.  JAX computes it in wrapping int32
with logical shifts; the port in int64 reduced mod 2**32."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nrenderer_tpu.ops.pt_core import hash_uniform as jax_hash  # noqa: E402
from nrenderer_torch.ops.pt_core import (  # noqa: E402
    bounce_seed, hash_uniform,
)

torch.set_num_threads(1)

N = 16384  # tuples per draw site; 8 sites + the bounce seeds > 1e5 in all
I32 = np.iinfo(np.int32)


def _tuples(seed: int):
    rng = np.random.default_rng(seed)
    pid = rng.integers(I32.min, I32.max, N, endpoint=True).astype(np.int32)
    sample = rng.integers(I32.min, I32.max, N, endpoint=True).astype(np.int32)
    sd = rng.integers(I32.min, I32.max, N, endpoint=True).astype(np.int32)
    # the values a render actually uses, and the int32 extremes
    pid[:6] = [0, 1, 262143, I32.max, I32.min, -1]
    sample[:6] = [0, 2047, 1, I32.max, I32.min, -1]
    sd[:6] = [0, -1, I32.max, I32.min, 123456789, -987654321]
    return pid, sample, sd


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("draw", [0, 1, 2, 3, 4, 5, 6, 0x7FFF1234])
def test_hash_bit_exact(draw):
    pid, sample, sd = _tuples(draw & 0xFFFF)
    want = jax_hash(jnp.asarray(pid), jnp.asarray(sample), draw,
                    jnp.asarray(sd))
    got = hash_uniform(torch.from_numpy(pid), torch.from_numpy(sample), draw,
                       torch.from_numpy(sd))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    u = got.numpy()
    assert u.min() >= 0.0 and u.max() < 1.0


def test_hash_bounce_seeds_bit_exact():
    """Per-bounce seeds `seed + b * -1640531535` wrap in int32 (the Pallas
    kernel's bseed) and feed the draws 4 and 5."""
    pid, sample, sd = _tuples(99)
    pid_j, sample_j = jnp.asarray(pid), jnp.asarray(sample)
    for base in (0, -5, int(I32.max), int(I32.min), 20260101):
        for b in range(0, 20, 3):
            bseed_j = jnp.int32(base) + jnp.int32(b) * jnp.int32(-1640531535)
            bseed = bounce_seed(base, b)
            assert bseed == int(bseed_j)
            for draw in (4, 5):
                want = jax_hash(pid_j[:2048], sample_j[:2048], draw, bseed_j)
                got = hash_uniform(torch.from_numpy(pid[:2048]),
                                   torch.from_numpy(sample[:2048]), draw,
                                   bseed)
                np.testing.assert_array_equal(_bits(got.numpy()),
                                              _bits(want))


def test_hash_int_arguments_and_int64_tensors():
    """Python ints and int64 tensors give the same bits as int32 tensors."""
    pid, sample, sd = _tuples(7)
    want = hash_uniform(torch.from_numpy(pid), torch.from_numpy(sample), 3,
                        torch.from_numpy(sd))
    got = hash_uniform(torch.from_numpy(pid).long(),
                       torch.from_numpy(sample).long(), 3,
                       torch.from_numpy(sd).long())
    assert torch.equal(got, want)
    for i in range(8):
        one = hash_uniform(int(pid[i]), int(sample[i]), 3, int(sd[i]))
        assert one.item() == want[i].item()
        assert one.item() == float(jax_hash(jnp.int32(pid[i]),
                                            jnp.int32(sample[i]), 3,
                                            jnp.int32(sd[i])))
