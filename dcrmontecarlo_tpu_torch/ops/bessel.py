"""Modified Bessel functions I0/K0/I1/K1 on torch tensors.

Port of ``dcrmontecarlo_tpu/ops/bessel.py``: the same Abramowitz & Stegun
9.8.1-9.8.8 polynomials and coefficient tables, evaluated op for op in
float32 (Horner order, branch guards and clamps unchanged), plus the
integrals ``ii0e`` / ``ik0`` and their small-argument series, which the
Robin chord integral (``greens.screened_chord_integral``) uses. The walk kernel
(``csrc/walk_kernel.cu``) carries the same polynomials as device
functions.
"""

import torch

__all__ = ["i0", "i0e", "k0", "k0e", "i1", "i1e", "k1", "k1e",
           "ii0e", "ik0"]

# A&S 9.8.1: I0(x), |x| <= 3.75, t = (x/3.75)^2
_I0_SMALL = (1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732, 0.0360768, 0.0045813)
# A&S 9.8.2: I0(x) x >= 3.75, e^-x sqrt(x) I0(x) = P(3.75/x)
_I0_LARGE = (
    0.39894228, 0.01328592, 0.00225319, -0.00157565, 0.00916281,
    -0.02057706, 0.02635537, -0.01647633, 0.00392377,
)
# A&S 9.8.5: K0(x), 0 < x <= 2, t = (x/2)^2: K0 = -ln(x/2) I0(x) + P(t)
_K0_SMALL = (-0.57721566, 0.42278420, 0.23069756, 0.03488590, 0.00262698,
             0.00010750, 0.00000740)
# A&S 9.8.6: K0(x), x >= 2, t = 2/x: e^x sqrt(x) K0(x) = P(t)
_K0_LARGE = (1.25331414, -0.07832358, 0.02189568, -0.01062446, 0.00587872,
             -0.00251540, 0.00053208)
# A&S 9.8.3: I1(x)/x for |x| <= 3.75, t = (x/3.75)^2
_I1_SMALL = (0.5, 0.87890594, 0.51498869, 0.15084934, 0.02658733,
             0.00301532, 0.00032411)
# A&S 9.8.4: x >= 3.75, e^-x sqrt(x) I1(x) = P(3.75/x)
_I1_LARGE = (
    0.39894228, -0.03988024, -0.00362018, 0.00163801, -0.01031555,
    0.02282967, -0.02895312, 0.01787654, -0.00420059,
)
# A&S 9.8.7: 0 < x <= 2, x K1(x) = x ln(x/2) I1(x) + P((x/2)^2)
_K1_SMALL = (1.0, 0.15443144, -0.67278579, -0.18156897, -0.01919402,
             -0.00110404, -0.00004686)
# A&S 9.8.8: x >= 2, e^x sqrt(x) K1(x) = P(2/x)
_K1_LARGE = (1.25331414, 0.23498619, -0.03655620, 0.01504268, -0.00780353,
             0.00325614, -0.00068245)


def _polyval(coeffs, t):
    # Horner, one rounding per multiply and per add (in place: the same
    # float32 operations as ``acc * t + c``)
    acc = torch.full_like(t, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc.mul_(t).add_(c)
    return acc


def _sq(v):
    return v * v


def _i0_small(x):
    return _polyval(_I0_SMALL, _sq(x / 3.75))


def _i0e_large(x):
    # e^{-x} I0(x) for x >= 3.75
    return _polyval(_I0_LARGE, 3.75 / x) / torch.sqrt(x)


def i0e(x):
    """Exponentially scaled modified Bessel function: ``e^{-|x|} I0(x)``."""
    x = torch.abs(x)
    small = _i0_small(x) * torch.exp(-x)
    xs = torch.clamp(x, min=3.75)
    return torch.where(x < 3.75, small, _i0e_large(xs))


def i0(x):
    """Modified Bessel function of the first kind, order 0."""
    x = torch.abs(x)
    xs = torch.clamp(x, min=3.75)
    return torch.where(x < 3.75, _i0_small(x), _i0e_large(xs) * torch.exp(xs))


def _k0_small(x):
    return -torch.log(x / 2.0) * _i0_small(x) + _polyval(_K0_SMALL,
                                                          _sq(x / 2.0))


def _k0e_large(x):
    # e^{x} K0(x) for x >= 2
    return _polyval(_K0_LARGE, 2.0 / x) / torch.sqrt(x)


def k0(x):
    """Modified Bessel function of the second kind, order 0 (x > 0)."""
    xc = torch.clamp(x, min=1e-30)  # K0 -> +inf as x -> 0+
    xs = torch.clamp(xc, min=2.0)
    return torch.where(xc <= 2.0, _k0_small(torch.clamp(xc, max=2.0)),
                       _k0e_large(xs) * torch.exp(-xs))


def k0e(x):
    """Exponentially scaled: ``e^{x} K0(x)`` (x > 0)."""
    xc = torch.clamp(x, min=1e-30)
    xs = torch.clamp(xc, min=2.0)
    return torch.where(
        xc <= 2.0, _k0_small(torch.clamp(xc, max=2.0)) * torch.exp(xc),
        _k0e_large(xs))


def _i1_small(x):
    return x * _polyval(_I1_SMALL, _sq(x / 3.75))


def _i1e_large(x):
    return _polyval(_I1_LARGE, 3.75 / x) / torch.sqrt(x)


def i1e(x):
    """Exponentially scaled modified Bessel function: ``e^{-|x|} I1(x)``."""
    x = torch.abs(x)
    small = _i1_small(x) * torch.exp(-x)
    xs = torch.clamp(x, min=3.75)
    return torch.where(x < 3.75, small, _i1e_large(xs))


def i1(x):
    """Modified Bessel function of the first kind, order 1 (x >= 0)."""
    x = torch.abs(x)
    xs = torch.clamp(x, min=3.75)
    return torch.where(x < 3.75, _i1_small(x), _i1e_large(xs) * torch.exp(xs))


def _k1_small(x):
    return (torch.log(x / 2.0) * _i1_small(x)
            + _polyval(_K1_SMALL, _sq(x / 2.0)) / x)


def _k1e_large(x):
    return _polyval(_K1_LARGE, 2.0 / x) / torch.sqrt(x)


def k1(x):
    """Modified Bessel function of the second kind, order 1 (x > 0)."""
    xc = torch.clamp(x, min=1e-30)  # K1 ~ 1/x as x -> 0+
    xs = torch.clamp(xc, min=2.0)
    return torch.where(xc <= 2.0, _k1_small(torch.clamp(xc, max=2.0)),
                       _k1e_large(xs) * torch.exp(-xs))


def k1e(x):
    """Exponentially scaled: ``e^{x} K1(x)`` (x > 0)."""
    xc = torch.clamp(x, min=1e-30)
    xs = torch.clamp(xc, min=2.0)
    return torch.where(
        xc <= 2.0, _k1_small(torch.clamp(xc, max=2.0)) * torch.exp(xc),
        _k1e_large(xs))


# Integrals int_0^z I0 and int_0^z K0 (see the JAX package's bessel.py for
# the series derivation and the fits' provenance).
_GAMMA_E = 0.5772156649015329
_HALF_PI = 1.5707963267948966


def _int_series_coeffs(n_terms=11):
    A, B, C = [], [], []
    fact = 1.0
    h = 0.0
    for k in range(n_terms):
        if k > 0:
            fact *= k
            h += 1.0 / k
        a = 0.25 ** k / (fact * fact)
        m = 2 * k + 1
        A.append(a / m)
        B.append(a * (1.0 / (m * m) + h / m))
        if k > 0:
            C.append(a * h)
    return tuple(A), tuple(B), tuple(C)


_II0_SER, _IK0_SER, _K0REG_SER = _int_series_coeffs()
_II0E_LARGE = (
    0.39892117833666013, 0.0683659380497933, -0.019199593449555692,
    0.5493053727171856, -2.987467946770637, 9.326451372102712,
    -15.800573705385947, 14.685752682422835, -7.138285073342126,
    1.4282994561660782,
)
_IK0_TAIL = (
    1.2532603568891372, -0.39012360170047267, 0.29878153845917976,
    -0.30142804207123175, 0.2850220058180192, -0.2003588389084528,
    0.08645137263695717, -0.0167236317256414,
)


def _ii0_over_z_series(z2):
    """``(int_0^z I0) / z`` as a series in ``z^2`` (z <= 3.75)."""
    return _polyval(_II0_SER, z2)


def _ik0_reg_over_z_series(z2):
    """The K0-integral's regular sum over z: ``P_B(z^2)`` (z <= 2)."""
    return _polyval(_IK0_SER, z2)


def _k0_reg_over_z2_series(z2):
    """``T(z)/z^2`` where ``K0 = -(ln(z/2)+gamma_E) I0 + T`` (z <= 2)."""
    return _polyval(_K0REG_SER, z2)


def ii0e(z):
    """Exponentially scaled integral: ``e^{-|z|} \\int_0^z I0(s) ds``."""
    z = torch.abs(z)
    small = z * _ii0_over_z_series(z * z) * torch.exp(-z)
    zs = torch.clamp(z, min=3.75)
    large = _polyval(_II0E_LARGE, 3.75 / zs) / torch.sqrt(zs)
    return torch.where(z < 3.75, small, large)


def ik0(z):
    """``\\int_0^z K0(s) ds`` (monotone, ``-> pi/2`` as ``z -> inf``)."""
    zc = torch.clamp(z, min=1e-30)
    zsm = torch.clamp(zc, max=2.0)
    z2 = zsm * zsm
    L = torch.log(0.5 * zsm) + _GAMMA_E
    small = zsm * (_ik0_reg_over_z_series(z2)
                   - L * _ii0_over_z_series(z2))
    zs = torch.clamp(zc, min=2.0)
    large = _HALF_PI - torch.exp(-zs) / torch.sqrt(zs) * _polyval(
        _IK0_TAIL, 2.0 / zs)
    return torch.where(zc <= 2.0, small, large)
