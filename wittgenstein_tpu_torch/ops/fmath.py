"""float32 math bit for bit as the JAX package computes it on the CPU.

Where the reference turns float32 math into integers (a latency, a
pairing time times a speed ratio, a mining threshold on a 2^-24 grid),
one ulp of difference between two math libraries changes the result.
PyTorch's `exp`, `log1p` and `erfinv` are not XLA's, so the functions
here rebuild XLA-CPU's own float32 code: the Cephes-style polynomials of
its math library, with every multiply whose result feeds one add fused
into a multiply-add (LLVM contracts those on an FMA machine) and every
other operation rounded to float32 on its own.  A fused multiply-add is
emulated exactly in float64 (`fma`).  Each function is held against the
JAX function on its whole input domain, or an exhaustive grid of it, by
the tests.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
F64 = torch.float64
_INF = float("inf")


def f32c(v):
    """A constant as the float32 it rounds to, held in a Python float."""
    return float(np.float32(v))


def fma(a, b, c):
    """``a * b + c`` in float32 with ONE rounding, as a fused
    multiply-add (`a` a float32 tensor, `b` and `c` float32 tensors or
    float32 values): the product is exact in float64, the float64 sum's
    rounding error is recovered exactly (TwoSum), and the sum is rounded
    to odd before the float32 rounding, which makes the two roundings
    one."""
    def wide(v):
        return v.to(F64) if isinstance(v, torch.Tensor) else v
    ab = a.to(F64) * wide(b)
    c = wide(c)
    s = ab + c
    bb = s - ab
    err = (ab - (s - bb)) + (c - bb)
    # the parity of s's last significand bit: |s| over its ulp is the
    # significand, an integer (exact: a power-of-two divisor)
    mag = s.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, _INF)) - mag
    even = torch.fmod(mag / ulp, 2) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, err * _INF), s)
    return s.to(F32)


# ---------------------------------------------------------------- exp

_EXP_LO, _EXP_HI = f32c(-87.8), f32c(88.8)
_F32_MIN = float(np.finfo(np.float32).tiny)
_LOG2E, _LN2_HI, _LN2_LO = f32c(1.44269504088896341), f32c(0.693359375), \
    f32c(-2.12194440e-4)
_EXP_P = [f32c(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                            8.3334519073e-3, 4.1665795894e-2,
                            1.6666665459e-1, 5.0000001201e-1)]
_POW2 = {}


def _pow2(device):
    """2^n as float32 for n = -127..127 (index n + 127), 2^-127 as 0:
    XLA builds it in the exponent bits, (n + 127) << 23."""
    if device not in _POW2:
        n = np.arange(-127, 128)
        table = np.where(n > -127, np.ldexp(1.0, n), 0.0)
        _POW2[device] = torch.tensor(table, dtype=F32, device=device)
    return _POW2[device]


def exp_f32(x):
    """float32 ``exp`` bit for bit as XLA computes it on the CPU (the
    reference's platform): x = n ln2 + r with n = floor(x log2e + 1/2)
    clamped to [-127, 127], exp(r) by Cephes' degree-6 polynomial, times
    2^n (`_pow2`); each multiply-add fused (`fma`);
    results below the smallest normal float32 flushed to 0, as XLA's
    CPU code runs with denormals flushed."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(fma(x, _LOG2E, 0.5)).clamp(-127, 127)
    r = fma(n, -_LN2_HI, x)
    r = fma(n, -_LN2_LO, r)
    z = fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = fma(z, r, p)
    z = 1.0 + fma(z, r * r, r)
    out = z * _pow2(n.device)[(n + 127).long()]
    return torch.where(out < _F32_MIN, 0.0, out)


def sqrt_f32(x):
    """The correctly rounded float32 square root (IEEE, as XLA's
    ``sqrt``): PyTorch's CPU float32 `sqrt` is off by one ulp on about
    1% of inputs, the float64 root rounded to float32 never is."""
    return torch.sqrt(x.to(F64)).to(F32)


# ---------------------------------------------------------------- log

#: Cephes' logf polynomial (Eigen's plog), as XLA's CPU `log_f32`
_LOG_P = [f32c(c) for c in (7.0376836292e-2, -1.1514610310e-1,
                            1.1676998740e-1, -1.2420140846e-1,
                            1.4249322787e-1, -1.6668057665e-1,
                            2.0000714765e-1, -2.4999993993e-1,
                            3.3333331174e-1)]
_LOG_Q1, _LOG_Q2 = f32c(-2.12194440e-4), f32c(0.693359375)
_SQRTHF = f32c(0.707106781186547524)


def log_f32(x):
    """float32 ``log`` bit for bit as XLA's CPU `log_f32` computes it
    for x in [smallest normal, inf) (Eigen's `plog`): x = m 2^e, m in
    [sqrt(1/2), sqrt(2)) folded by one step, then
    ``(m-1) - (m-1)^2/2 + (m-1)^3 P(m-1) + e ln2`` with ln2 split in
    two; multiply-adds fused where XLA's code fuses them."""
    m, e = torch.frexp(x.clamp_min(_F32_MIN))     # m in [0.5, 1), exact
    small = m < _SQRTHF
    e = e.to(F32) - small.to(F32)
    xr = (m - 1.0) + torch.where(small, m, 0.0)     # exact
    x2 = xr * xr
    x3 = x2 * xr
    y = fma(xr, _LOG_P[0], _LOG_P[1])
    y1 = fma(xr, _LOG_P[3], _LOG_P[4])
    y2 = fma(xr, _LOG_P[6], _LOG_P[7])
    y = fma(y, xr, _LOG_P[2])
    y1 = fma(y1, xr, _LOG_P[5])
    y2 = fma(y2, xr, _LOG_P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    r = (xr - x2 * 0.5) + y
    return r + e * _LOG_Q2                            # e * q2 is exact


#: Cephes' log1p rational approximation (XLA's `EmitLog1p`), numerator
#: and denominator from the highest power down
_L1P_NUM = [f32c(c) for c in (4.5270000862445199635215e-5,
                              4.9854102823193375972212e-1,
                              6.5787325942061044846969e0,
                              2.9911919328553073277375e1,
                              6.0949667980987787057556e1,
                              5.7112963590585538103336e1,
                              2.0039553499201281259648e1)]
_L1P_DEN = [1.0] + [f32c(c) for c in (1.5062909083469192043167e1,
                                      8.3047565967967209469434e1,
                                      2.2176239823732856465394e2,
                                      3.0909872225312059774938e2,
                                      2.1642788614495947685003e2,
                                      6.0118660497603843919306e1)]
_L1P_SMALL = f32c(0.41421356237309504880)


def log1p_f32(t):
    """float32 ``log1p`` bit for bit as XLA computes it on the CPU:
    ``log_f32(1 + t)`` for |t| >= sqrt(2) - 1, else Cephes' rational
    form ``t - t^2/2 + t^3 P(t)/Q(t)``."""
    large = log_f32(t + 1.0)
    t2 = t * t
    num = torch.full_like(t, _L1P_NUM[0])
    for c in _L1P_NUM[1:]:
        num = fma(num, t, c)
    den = torch.full_like(t, _L1P_DEN[0])
    for c in _L1P_DEN[1:]:
        den = fma(den, t, c)
    small = t + fma(t2, -0.5, (t * t2) * (num / den))
    return torch.where(t.abs() < _L1P_SMALL, small, large)


#: Giles' single-precision erfinv coefficients (XLA's ErfInv32), from
#: the highest power down: w < 5, then w >= 5
_ERFINV_LO = [f32c(c) for c in (2.81022636e-08, 3.43273939e-07,
                                -3.5233877e-06, -4.39150654e-06,
                                0.00021858087, -0.00125372503,
                                -0.00417768164, 0.246640727, 1.50140941)]
_ERFINV_HI = [f32c(c) for c in (-0.000200214257, 0.000100950558,
                                0.00134934322, -0.00367342844,
                                0.00573950773, -0.0076224613,
                                0.00943887047, 1.00167406, 2.83297682)]


def erfinv_f32(x):
    """float32 ``erfinv`` bit for bit as the JAX package's
    `jax.scipy.special.erfinv` computes it on the CPU (XLA's ErfInv32):
    w = -log1p(-x^2); a degree-8 polynomial in w - 2.5 (w < 5) or in
    sqrt(w) - 3, times x; +-inf at |x| == 1."""
    w = -log1p_f32(x * (-x))
    lo = w < 5.0
    z = torch.where(lo, w - 2.5, sqrt_f32(w) - 3.0)
    coef = [torch.where(lo, a, b) for a, b in zip(_ERFINV_LO, _ERFINV_HI)]
    p = fma(coef[0], z, coef[1])
    for c in coef[2:]:
        p = fma(z, p, c)
    p = torch.where(x.abs() == 1.0, _INF, p)
    return x * p
