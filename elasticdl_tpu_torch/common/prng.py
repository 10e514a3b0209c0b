"""The JAX Trainer's state key, computed without JAX.

The JAX Trainer stores `rng = jax.random.split(jax.random.PRNGKey(seed))[1]`
in its TrainState (elasticdl_tpu/training/trainer.py `init_state`). No
port model uses dropout, so the port only carries this key through
checkpoints; deriving the same bits keeps a port checkpoint restorable
into the JAX Trainer with strict=True and byte-identical to its own.

`threefry2x32` is JAX's threefry_2x32 hash (20 rounds, Salmon et al.
2011); `split` is jax.random.split under the partitionable threefry,
the default of the JAX the package pins (jax_threefry_partitionable).
"""

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The threefry_2x32 hash of the counter pairs (x0[i], x1[i]) under
    `key` (two uint32). Returns two uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed):
    """jax.random.PRNGKey(seed) for a 32-bit seed: [0, seed mod 2^32]."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError("seed %d is outside the 32-bit range" % seed)
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def split(key, num=2):
    """jax.random.split(key, num) (partitionable threefry): key i hashes
    the counter pair (0, i)."""
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(key, np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
    return np.stack([hi, lo], axis=-1)


def state_rng(seed):
    """The JAX Trainer's TrainState.rng for `seed`: split(PRNGKey(seed))[1]."""
    return split(prng_key(seed))[1]
