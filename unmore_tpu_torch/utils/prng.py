"""``jax.random``'s default stream in plain torch: threefry2x32 keys,
``split``, ``fold_in``, and the float32 draws ``uniform``, ``normal`` and
``truncated_normal`` that flax's initializers make, equal to the JAX
package's.

``jax.random`` is a counter-based function, not hidden state. A key is two
32-bit words. ``split(key, n)`` and ``uniform(key, shape)`` apply the
20-round threefry2x32 block cipher (Salmon et al., SC 2011) under the key to
the counters ``0 .. n-1`` (the elements of ``shape`` in row-major order),
each counter as its (high, low) 32-bit words; this is JAX's layout when
``jax_threefry_partitionable`` is true, its default since JAX 0.5.
``split`` keeps the cipher's two output words as the new key;
``fold_in(key, d)`` enciphers the counter words (0, d); ``uniform`` xors
the two words into 32 bits, puts the top 23 of those under the exponent of
1.0 and subtracts 1.

``normal`` and ``truncated_normal`` go through XLA's float32 ``erf_inv``
and ``log1p`` as its CPU code computes them: Cephes' and Giles'
polynomials, where a multiply feeding an add rounds once (XLA's CPU code
contracts the pair into an FMA; here the pair runs in float64 and rounds to
float32 once), and division and sqrt round their float64 result. Every
step is an IEEE operation, so the CPU and a card give the same bits, and on
an x86 CPU with FMA they are XLA's.

Keys are int64 tensors of shape [..., 2] holding the two words, or a key on
the host: a uint32[2] numpy array, a tuple or a CPU tensor. One key on the
host enters the arithmetic as two Python ints, so drawing under it on the
card copies nothing to the card and waits for nothing queued there. The
arithmetic runs on int64 tensors masked to 32 bits, so the CPU and CUDA give
the same bits.
"""

from __future__ import annotations

import math

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


def fold_in(key, data, device=None) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for each 32-bit ``data`` (an int,
    or an int64 tensor [...] of them): the threefry2x32 of the counter words
    (0, data) under ``key``, as keys [..., 2]."""
    k1, k2, device = _words(key, device)
    d = torch.as_tensor(data, dtype=torch.int64, device=device) & MASK32
    a, b = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def random_bits(key, n: int, start: int = 0, device=None) -> torch.Tensor:
    """Elements ``[start, start + n)`` of ``jax.random.bits(key, shape)``
    flattened, for any ``shape`` (the partitionable layout numbers the
    elements of a shape in row-major order): int64 tensor [..., n] of 32-bit
    values, for each key of ``key`` [..., 2]."""
    k1, k2, device = _words(key, device)
    if isinstance(k1, torch.Tensor):
        k1, k2 = k1[..., None], k2[..., None]
    a, b = threefry2x32(k1, k2, *_counters(start, start + n, device))
    return a.bitwise_xor_(b)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU code contracts a
    multiply feeding an add, returned as float64 holding the float32 value
    (the next step's operand). The operands are float32 values, in float32
    or float64 tensors or Python floats. Their product is exact in float64,
    so only the sum rounds twice (to float64, then float32), which differs
    from one rounding only when the float64 sum lands on a float32 midpoint."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return torch.mul(a.double(), b).add_(c).float().double()


def _floats(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1): the top 23 under 1.0's exponent, minus 1."""
    bits = bits.bitwise_right_shift_(9).bitwise_or_(_ONE_BITS)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(keys, shape, minval: float = 0.0, maxval: float = 1.0, start: int = 0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for each
    key of ``keys`` [..., 2]: a tensor [..., *shape] (``shape`` an int n is
    (n,)). ``floats * (maxval - minval) + minval`` rounds once, as XLA's CPU
    code computes it, then is raised to ``minval``. ``start`` skips the
    first elements of the flattened draw: the result is its elements
    ``[start, start + numel)``, so a large draw can be made in pieces."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    floats = _floats(random_bits(keys, math.prod(shape), start, device))
    lo, hi = np.float32(minval), np.float32(maxval)
    if (lo, hi) != (0.0, 1.0):
        floats = _fma(floats, float(hi - lo), float(lo)).float()
    return torch.clamp_min(floats, float(lo)).view(*floats.shape[:-1], *shape)


# Giles' single-precision erfinv polynomial, as XLA's ErfInv32 evaluates it,
# in w - 2.5 for w = -log1p(-x^2) < 5 and in sqrt(w) - 3 otherwise
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU log1p: Cephes' rational log1p for |x| < sqrt(2) - 1, else Cephes'
# logf of 1 + x, its degree-8 polynomial in three interleaved parts
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
           -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_F32 = lambda v: float(np.float32(v))  # noqa: E731


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a / b`` (float32 values in any float tensors) correctly
    rounded on every device: the float64 quotient rounded to float32 (53 >=
    2 * 24 + 2 bits make the double rounding harmless)."""
    return (a.double() / b.double()).float()


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt`` correctly rounded, through float64 as :func:`_div`:
    torch's vectorised float32 sqrt on the CPU is not."""
    return a.double().sqrt().float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """The polynomial ``coeffs`` (highest power first) at ``x``, each step
    one :func:`_fma`; float64 holding float32 values."""
    x = x.double()
    p = torch.full_like(x, _F32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, _F32(c))
    return p


def _logf(y: torch.Tensor) -> torch.Tensor:
    """Cephes' logf of float32 ``y``, step for step as XLA's CPU code runs it."""
    y = torch.clamp_min(y, _F32(np.finfo(np.float32).tiny))
    bits = y.view(torch.int32)
    e = ((bits >> 23) - 126).float()  # the exponent of a mantissa in [0.5, 1)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _F32(0.707106781186547524)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    p = _LOGF_P
    t2 = t * t
    t3 = (t2 * t).double()
    t64 = t.double()
    a = _fma(_fma(t64, _F32(p[0]), _F32(p[1])), t64, _F32(p[2]))
    b = _fma(_fma(t64, _F32(p[3]), _F32(p[4])), t64, _F32(p[5]))
    c = _fma(_fma(t64, _F32(p[6]), _F32(p[7])), t64, _F32(p[8]))
    poly = _fma(_fma(_fma(a, t3, b), t3, c), t3, e * _F32(-2.12194440e-4)).float()
    return (t - t2 * 0.5) + poly + e * 0.693359375


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``log1p`` of float32 ``x`` (> -1)."""
    x2 = x * x
    small = x + (x2 * -0.5 + x * x2 * _div(_horner(x, _LOG1P_NUM), _horner(x, _LOG1P_DEN)))
    return torch.where(x.abs() < _F32(0.41421356237309504880), small, _logf(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (``ErfInv32``): Giles' polynomial in
    ``w = -log1p(-x^2)``, its Horner steps each rounded once."""
    w = -log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0).double()
    p = torch.where(lt, _F32(_ERFINV_SMALL[0]), _F32(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, torch.where(lt, _F32(cs), _F32(cl)))
    return x * torch.where(x.abs() == 1.0, torch.inf, p.float())


_SQRT2 = _F32(np.sqrt(2))


def normal_scale(scale: float) -> float:
    """The one factor of ``erf_inv(u)`` in ``normal(...) * scale``: XLA folds
    the constants ``sqrt(2)`` and ``scale`` into one float32 product."""
    return float(np.float32(_SQRT2) * np.float32(scale))


def normal(key, shape, start: int = 0, device=None, scale: float = 1.0) -> torch.Tensor:
    """``jax.random.normal(key, shape) * scale`` float32: ``sqrt(2) *
    erf_inv(u)`` of a uniform u on [nextafter(-1, 0), 1), times ``scale``,
    the two factors folded (:func:`normal_scale`)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    return erf_inv(uniform(key, shape, lo, 1.0, start, device)) * normal_scale(scale)


# erf(-2 / sqrt(2)) and erf(2 / sqrt(2)) in float32 as XLA computes them:
# the uniform bounds of a normal truncated to [-2, 2]
ERF_MINUS_SQRT2 = -0.9544997
ERF_SQRT2 = 0.9544997


def truncated_normal(key, lower: float, upper: float, shape, start: int = 0, device=None) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` float32 for
    the bounds (-2, 2), whose ``erf`` values this module holds: ``sqrt(2) *
    erf_inv`` of a uniform between them, clipped to the open interval."""
    if (lower, upper) != (-2, 2):
        raise NotImplementedError("truncated_normal holds the erf bounds of (-2, 2) only")
    out = erf_inv(uniform(key, shape, ERF_MINUS_SQRT2, ERF_SQRT2, start, device)) * _SQRT2
    lo = np.nextafter(np.float32(lower), np.float32(np.inf))
    hi = np.nextafter(np.float32(upper), np.float32(-np.inf))
    return torch.clamp(out, float(lo), float(hi))
