"""``jax.random``'s default stream in plain torch: threefry2x32 keys, ``split``
and ``uniform`` float32 draws, equal bit for bit to the JAX package's.

``jax.random`` is a counter-based function, not hidden state. A key is two
32-bit words. ``split(key, n)`` and ``uniform(key, (n,))`` apply the
20-round threefry2x32 block cipher (Salmon et al., SC 2011) under the key to
the counters ``0 .. n-1``, each counter as its (high, low) 32-bit words;
this is JAX's layout when ``jax_threefry_partitionable`` is true, its
default since JAX 0.5. ``split`` keeps the cipher's two output words as the
new key; ``uniform`` xors them into 32 bits, puts the top 23 of those under
the exponent of 1.0 and subtracts 1.

Keys are int64 tensors of shape [..., 2] holding the two words, or a key on
the host: a uint32[2] numpy array, a tuple or a CPU tensor. One key on the
host enters the arithmetic as two Python ints, so drawing under it on the
card copies nothing to the card and waits for nothing queued there. The
arithmetic runs on int64 tensors masked to 32 bits, so the CPU and CUDA give
the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000  # float32 1.0


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed &= (1 << 64) - 1
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64, device=device)


def _words(key, device):
    """(k1, k2, device) of ``key`` [..., 2]: Python ints for one key on the
    host, else int64 tensors [...] on ``device`` (default: the key's own, or
    the CPU)."""
    if not isinstance(key, torch.Tensor) or key.device.type == "cpu":
        host = np.asarray(key, dtype=np.int64) & MASK32
        if host.shape == (2,):
            return int(host[0]), int(host[1]), torch.device(device or "cpu")
        key = torch.from_numpy(host)
    key = key.to(device or key.device, torch.int64) & MASK32
    return key[..., 0], key[..., 1], key.device


def threefry2x32(k1, k2, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 of the words (x0, x1) under the key (k1, k2):
    int64 tensors of 32-bit values, broadcast together (the key's words may
    be Python ints).

    Each round is ``x0 += x1; x1 = rotl(x1, r) ^ x0`` mod 2^32, in five
    elementwise passes: x0 is masked only at the end (its sums stay under
    2^38), and ``rotl(x1, r)`` is ``(x1 >> (32 - r)) + x1 * 2^r``, whose
    bits above 32 the mask after the xor drops."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    shape = torch.broadcast_shapes(*(v.shape for v in (k1, k2, x0, x1) if isinstance(v, torch.Tensor)))
    x0 = (x0 + ks[0]).expand(shape).contiguous()  # fresh tensors, updated in place below
    x1 = ((x1 + ks[1]) & MASK32).expand(shape).contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            x1 = (x1 >> (32 - r)).add_(x1, alpha=1 << r).bitwise_xor_(x0).bitwise_and_(MASK32)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK32)
    return x0.bitwise_and_(MASK32), x1


def _counters(start: int, stop: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    c = torch.arange(start, stop, dtype=torch.int64, device=device)
    return c >> 32, c & MASK32


def split(key, num: int = 2, start: int = 0, stop: int | None = None, device=None) -> torch.Tensor:
    """Rows ``[start, stop)`` (default: all) of ``jax.random.split(key, num)``,
    as an int64 tensor [stop - start, 2]. A row depends on its index alone, so
    a rank computes only its own rows of a split."""
    stop = num if stop is None else stop
    if not 0 <= start <= stop <= num:
        raise ValueError(f"rows [{start}, {stop}) are not rows of a split into {num}")
    k1, k2, device = _words(key, device)
    a, b = threefry2x32(k1, k2, *_counters(start, stop, device))
    return torch.stack([a, b], dim=-1)


def uniform(keys, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in [0, 1) float32 for each key of
    ``keys`` [..., 2]: a tensor [..., n]."""
    k1, k2, device = _words(keys, device)
    if isinstance(k1, torch.Tensor):
        k1, k2 = k1[..., None], k2[..., None]
    a, b = threefry2x32(k1, k2, *_counters(0, n, device))
    bits = a.bitwise_xor_(b).bitwise_right_shift_(9).bitwise_or_(_ONE_BITS)
    return torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0, 0.0)
