"""The ``jax.random`` calls of the campaign path, rebuilt on plain torch.

The port keeps the JAX package's key schedule so that a trajectory started
from the same integer seed sees the same random numbers in both packages.
Implemented: ``PRNGKey``, ``fold_in``, ``split``, ``random_bits`` (32 and 64
bit), ``uniform``, ``normal`` and ``permutation``, exactly as jax 0.9
computes them for the threefry2x32 implementation with
``jax_threefry_partitionable=True``:

* a key is two uint32 words; ``fold_in(k, d)`` hashes the counter pair
  ``(0, d)`` under ``k``; ``split(k, num)`` hashes ``(0, i)`` for i < num;
* ``random_bits(k, shape)`` hashes the row-major flat index of each element
  as the counter pair ``(hi, lo)`` and keeps ``x0 ^ x1`` (32 bit) or
  ``x0 << 32 | x1`` (64 bit);
* ``permutation(k, m)`` sorts ``arange(m)`` by 32-bit keys, in
  ⌈3·ln m / ln(2³² − 1)⌉ rounds of ``k, sub = split(k)`` and a stable sort
  by ``random_bits(sub, 32, (m,))``;
* ``uniform`` keeps the top mantissa bits, scales to ``[lo, hi)`` with one
  fused multiply-add and clips at ``lo``; ``normal`` is ``√2·erf_inv(u)`` with u uniform on
  ``(nextafter(−1, 0), 1)``.

uint32 words are held in int64 tensors and masked with ``& 0xFFFFFFFF``
after every add and shift: torch's uint32 lacks shifts and xor on some
devices.  A key is an int64 tensor whose last axis has size 2; every
function here broadcasts over leading key axes, so a batch of keys (the
slot axis, the row axis) is one call.

Key words, random bits and uniforms agree with jax bit for bit.  Normals
agree to 3 ulp in both types: ``erf_inv`` and the ``log1p`` inside it are
XLA's polynomials with XLA's fused multiply-adds (float64: Giles' three
branches; float32: his two, on w < 5 and w ≥ 5), and only the ``log`` of
the large-argument branch is the device's own.  float64 normals match bit
for bit but for a few in 10⁵, float32 ones but for about 5 in 10³ (XLA's
CPU ``log`` in float32 is its own polynomial, 1 ulp from torch's in ~7 %
of the arguments of that branch); tests/test_torch_prng.py.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds on broadcastable int64-held uint32 words.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a Python int (64-bit two's complement
    split into high and low words)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & MASK32], dtype=torch.int64,
                        device=device)


def as_key(key, device=None) -> torch.Tensor:
    """An int seed (``PRNGKey``) or a (2,) key, as a key on ``device``."""
    if isinstance(key, int):
        return PRNGKey(key, device=device)
    return torch.as_tensor(key, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is an int or an integer tensor that
    broadcasts against ``key[..., 0]``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: shape ``key.shape[:-1] + (num, 2)``."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return torch.stack((y0, y1), dim=-1)


def _counters(shape, device):
    size = math.prod(shape)
    flat = torch.arange(size, dtype=torch.int64, device=device)
    return (flat >> 32).reshape(shape), (flat & MASK32).reshape(shape)


def _hash_shape(key: torch.Tensor, shape):
    hi, lo = _counters(tuple(shape), key.device)
    pad = (None,) * len(shape)
    k0 = key[(..., 0) + pad]
    k1 = key[(..., 1) + pad]
    return threefry2x32(k0, k1, hi, lo)


def random_bits(key: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """``jax.random.bits``: 32-bit values as int64, 64-bit values as the
    pair ``(hi, lo)`` of int64-held words (no uint64 arithmetic needed)."""
    b0, b1 = _hash_shape(key, shape)
    if bit_width == 32:
        return b0 ^ b1
    if bit_width == 64:
        return b0, b1
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _unit(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Uniform on [0, 1) from the top mantissa bits.  ``m·2^-nmant`` is the
    exact value of jax's ``bitcast(m | one) − 1``."""
    if dtype == torch.float64:
        hi, lo = random_bits(key, 64, shape)
        mant = (hi << 20) | (lo >> 12)                   # top 52 of 64 bits
        return mant.to(torch.float64) * 2.0 ** -52
    if dtype == torch.float32:
        mant = random_bits(key, 32, shape) >> 9           # top 23 of 32 bits
        return mant.to(torch.float32) * 2.0 ** -23
    raise ValueError(f"unsupported dtype {dtype}")


def uniform(key: torch.Tensor, shape, dtype=torch.float64, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``."""
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    f = _unit(key, shape, dtype)
    # one fused multiply-add, as XLA contracts ``f·(hi − lo) + lo``
    return torch.maximum(lo, torch.addcmul(lo, f, hi - lo))


# XLA's float64 erf_inv (Giles' approximation, as in XLA's math library):
# three polynomials in w = −log1p(−x²), selected at w < 6.25, w < 16 and
# otherwise, highest-order coefficient first.
_ERFINV_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


# XLA's log1p below |x| < √2 − 1: a Cephes rational approximation.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    """Σ coefs[i]·x^(k−i), each step one fused multiply-add (``addcmul``),
    as XLA's compiled polynomials contract them."""
    p = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        p = torch.addcmul(torch.full_like(x, c), p, x)
    return p


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``log1p`` (float64, and float32 on the CPU): the rational form
    for small |x|, its coefficients rounded to x's type, else
    ``log(1 + x)``."""
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (_horner(x, _LOG1P_NUM)
                                          / _horner(x, _LOG1P_DEN)))
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def erf_inv_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``erf_inv``, operation for operation."""
    w = -log1p_xla(-x * x)
    lt625 = w < 6.25
    lt16 = w < 16.0

    def coef(i):
        c = torch.full_like(x, _ERFINV_LT_6_25[i])
        if i < 19:
            c = torch.where(lt625, c, _ERFINV_LT_16[i])
        if i < 17:
            c = torch.where(lt16, c, _ERFINV_GE_16[i])
        return c

    w = torch.where(lt625, w - 3.125,
                    torch.sqrt(w) - torch.where(lt16, x.new_tensor(3.25),
                                                x.new_tensor(5.0)))
    p = coef(0)
    for i in range(1, 17):
        p = torch.addcmul(coef(i), p, w)
    for i in range(17, 19):
        p = torch.where(lt16, torch.addcmul(coef(i), p, w), p)
    for i in range(19, 23):
        p = torch.where(lt625, torch.addcmul(coef(i), p, w), p)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


# XLA's float32 erf_inv (Giles' single-precision approximation): one
# polynomial in w − 2.5 for w < 5 and one in √w − 3 above, w = −log1p(−x²),
# highest-order coefficient first.
_ERFINV32_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, operation for operation."""
    w = -log1p_xla(-x * x)
    lt5 = w < 5.0

    def coef(i):
        return torch.where(lt5, torch.full_like(x, _ERFINV32_LT_5[i]),
                           torch.full_like(x, _ERFINV32_GE_5[i]))

    w = torch.where(lt5, w - 2.5, torch.sqrt(w) - 3.0)
    p = coef(0)
    for i in range(1, len(_ERFINV32_LT_5)):
        p = torch.addcmul(coef(i), p, w)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape, dtype=torch.float64) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for float64 and float32:
    √2·erf_inv(u), u uniform on (nextafter(−1, 0), 1) in ``dtype``."""
    if dtype == torch.float64:
        erf_inv = erf_inv_f64
    elif dtype == torch.float32:
        erf_inv = erf_inv_f32
    else:
        raise ValueError(f"unsupported dtype {dtype}")
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    u = uniform(key, shape, dtype, lo, 1.0)
    return math.sqrt(2.0) * erf_inv(u)


def permutation(key: torch.Tensor, m: int) -> torch.Tensor:
    """``jax.random.permutation(key, m)`` for an int ``m``: ``arange(m)``
    (int64) sorted stably by fresh 32-bit words in each round."""
    m = int(m)
    rounds = math.ceil(3 * math.log(max(1, m)) / math.log(MASK32))
    x = torch.arange(m, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, 32, (m,)), stable=True).indices
        x = x[order]
    return x
