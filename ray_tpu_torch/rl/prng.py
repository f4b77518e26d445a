"""The reference's random streams in numpy: JAX's threefry2x32 keys and
flax's parameter keys.

The reference draws its RL networks' initial weights and the noise of its
off-policy updates from JAX keys (``jax.random.PRNGKey(seed)``, ``split``,
``fold_in``, ``normal``, ...). This module computes the same numbers
without JAX, so a port network drawn from a seed starts from the
reference's weights and an update uses the reference's noise:

- ``PRNGKey``, ``split``, ``fold_in``, ``bits``, ``uniform``, ``normal`` and
  ``truncated_normal`` follow jax 0.9's threefry2x32 in its partitionable
  mode (``jax_threefry_partitionable``): a draw of shape ``s`` hashes the
  64-bit row-major index of each element as the counter pair (high word,
  low word) and xors the two output words. ``bits``, ``split``,
  ``fold_in`` and ``uniform`` are bit for bit JAX's.
- ``normal`` and ``truncated_normal`` are sqrt(2) * erfinv(u) with XLA's
  float32 ``erf_inv`` (M. Giles' polynomial over XLA's CPU log1p, Cephes'
  approximations), each evaluated in float32 in XLA's order with the
  multiply-adds XLA's CPU code fuses rounded once.
- ``param_key`` is flax's ``make_rng("params")`` in the scope of a module
  path: a SHA-1 of the path's names and the scope's draw counter, whose
  first four bytes (big-endian) are folded into the root key (flax's
  ``_fold_in_static``; ``flax_fix_rng_separator`` off, flax's default).
- ``lecun_normal``, ``orthogonal``, ``uniform`` and ``constant`` are the
  initialisers the reference's layers use.

A key is a ``uint32`` array of shape (2,); ``split`` gives shape (n, 2).
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["PRNGKey", "bits", "constant", "erf_inv", "fold_in", "lecun_normal", "normal",
           "orthogonal", "param_key", "split", "truncated_normal", "uniform"]

Shape = Union[int, Tuple[int, ...]]
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _fma32(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32, as XLA's CPU code contracts it: the
    product of two float32 values is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.isscalar(shape) else tuple(int(s) for s in shape)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds over counter words ``x0``, ``x1``
    (uint32 arrays of one shape) under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    shape = np.shape(x0)
    # 1-d arrays: numpy's uint32 arithmetic wraps silently there
    x = [np.asarray(x0, np.uint32).reshape(-1) + ks[0],
         np.asarray(x1, np.uint32).reshape(-1) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0].reshape(shape), x[1].reshape(shape)


def _counters(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """The (high, low) words of each element's row-major index."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(_MASK)).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)`` with 32-bit integers (JAX's default):
    the key [0, seed mod 2**32]."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``num`` new keys, shape (num, 2)."""
    b0, b1 = threefry2x32(key, *_counters((int(num),)))
    return np.stack([b0, b1], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([int(data) & _MASK], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def bits(key: np.ndarray, shape: Shape) -> np.ndarray:
    """``jax.random.bits(key, shape)``: uint32 words."""
    b0, b1 = threefry2x32(key, *_counters(_shape(shape)))
    return b0 ^ b1


def uniform(key: np.ndarray, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23 random
    mantissa bits under exponent 0, minus one, scaled and shifted in
    float32 (one fused multiply-add), no lower than ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    one = np.float32(1.0).view(np.uint32)
    floats = ((bits(key, shape) >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma32(floats, np.float32(hi - lo), lo))


# XLA's CPU float32 log: Cephes' logf polynomial over the mantissa in
# [sqrt(1/2), sqrt(2)), highest coefficient first
_LOG_P = np.array([7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
                   1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
                   3.3333331174E-1], np.float32)
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)
# XLA's log1p below |x| < sqrt(2) - 1: Cephes' rational approximation
_LOG1P_NUM = np.array([4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
                       6.5787325942061044846969E0, 2.9911919328553073277375E1,
                       6.0949667980987787057556E1, 5.7112963590585538103336E1,
                       2.0039553499201281259648E1], np.float32)
_LOG1P_DEN = np.array([1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
                       2.2176239823732856465394E2, 3.0909872225312059774938E2,
                       2.1642788614495947685003E2, 6.0118660497603843919306E1], np.float32)
_F32 = np.float32


def _log32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log of positive ``x``: the exponent apart, the
    mantissa m folded into [sqrt(1/2), sqrt(2)), then Cephes' polynomial in
    m - 1 with XLA's fused multiply-adds."""
    x = np.maximum(np.asarray(x, _F32), np.uint32(0x00800000).view(_F32))
    xi = x.view(np.uint32)
    e = ((xi >> np.uint32(23)).astype(np.int32) - 0x7F).astype(_F32) + _F32(1)
    m = ((xi & np.uint32(0x807FFFFF)) | _F32(0.5).view(np.uint32)).view(_F32)
    small = m < _F32(0.707106781186547524)
    e = e - np.where(small, _F32(1), _F32(0))
    m = (m - _F32(1)) + np.where(small, m, _F32(0))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y, y1, y2 = _fma32(m, p[0], p[1]), _fma32(m, p[3], p[4]), _fma32(m, p[6], p[7])
    y, y1, y2 = _fma32(y, m, p[2]), _fma32(y1, m, p[5]), _fma32(y2, m, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, _LOG_Q1 * e)
    m = m - _F32(0.5) * x2
    return ((m + y) + _LOG_Q2 * e).astype(_F32)


def _poly32(x: np.ndarray, coefficients: np.ndarray) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coefficients:
        p = _fma32(p, x, c)
    return p


def _log1p32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log1p: Cephes' rational approximation where |x| <
    sqrt(2) - 1, else log(1 + x)."""
    x = np.asarray(x, _F32)
    x2 = x * x
    small = (_poly32(x, _LOG1P_NUM) / _poly32(x, _LOG1P_DEN)).astype(_F32)
    small = x + _fma32(_F32(-0.5), x2, (x * x2) * small)
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, _log32(x + _F32(1)))


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"):
# coefficients for w = -log1p(-x^2) below 5 and from 5 up, highest first
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                        1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                        2.83297682], np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``, evaluated in float32 in its order, with
    the multiply-adds of the polynomial fused as XLA's CPU code fuses them."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -_log1p32(x * -x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
        for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = _fma32(p, w, np.where(lt, c_lt, c_ge))
        out = (p * x).astype(np.float32)
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out)


_SQRT2 = np.float32(np.sqrt(2))


def normal(key: np.ndarray, shape: Shape = ()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: sqrt(2) * erfinv(u), u
    uniform on (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return (_SQRT2 * erf_inv(uniform(key, shape, lo, 1.0))).astype(np.float32)


def _erf32(x: float) -> np.float32:
    return np.float32(math.erf(float(np.float32(x))))


def truncated_normal(key: np.ndarray, lower: float, upper: float,
                     shape: Shape = ()) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32:
    sqrt(2) * erfinv(u) for u uniform on [erf(lower / sqrt 2), erf(upper /
    sqrt 2)), clipped into the open interval (lower, upper)."""
    lo, hi = np.float32(lower), np.float32(upper)
    a, b = _erf32(lo / _SQRT2), _erf32(hi / _SQRT2)
    out = (_SQRT2 * erf_inv(uniform(key, shape, a, b))).astype(np.float32)
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf))).astype(np.float32)


def _static_hash(data: Sequence[Union[str, int]]) -> int:
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def param_key(key: np.ndarray, path: Sequence[str], counter: int) -> np.ndarray:
    """flax's ``make_rng("params")`` for the ``counter``-th draw (from 1) in
    the scope of the module ``path`` (its names from the root, which has
    none) under the root key ``key``: each parameter of a module is one
    draw, in the order the module creates them."""
    return fold_in(key, _static_hash((*path, int(counter))))


# flax's lecun_normal divides by the standard deviation of a unit normal
# truncated to [-2, 2], so that the truncated draw keeps its variance
TRUNC_STD = 0.87962566103423978


def lecun_normal(key: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """flax's ``lecun_normal()`` of a ``[in, out]`` kernel: a unit normal
    truncated to (-2, 2), times sqrt(1 / in) / TRUNC_STD, in float32."""
    variance = np.float32(1.0 / shape[0])
    stddev = np.sqrt(variance) / np.float32(TRUNC_STD)
    return (truncated_normal(key, -2.0, 2.0, shape) * stddev).astype(np.float32)


def orthogonal(key: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """flax's ``orthogonal()`` of a ``[rows, cols]`` kernel: the Q of a
    normal draw of shape (max, min), each column signed by R's diagonal,
    transposed when there are fewer rows than columns. The QR is LAPACK's
    float32 one through scipy, the routine JAX's CPU QR calls."""
    from scipy.linalg import qr

    rows, cols = shape
    z = normal(key, (max(rows, cols), min(rows, cols)))
    q, r = qr(z, mode="economic")
    q = (q * np.sign(np.diagonal(r))[None, :]).astype(np.float32)
    return np.ascontiguousarray(q.T if rows < cols else q)


def constant(value: float, shape: Shape) -> np.ndarray:
    return np.full(_shape(shape), np.float32(value), np.float32)
