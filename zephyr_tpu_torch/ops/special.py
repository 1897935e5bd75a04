'''
Special functions for the analytical oracle, in torch: the port of
``zephyr_tpu.ops.special``. J0/Y0 are the same classic rational
(Cephes-style) minimax approximations as the JAX package (accurate to
~1e-8 relative), so the two agree to rounding.
'''

import torch

_TWO_OVER_PI = 0.636619772367581343
_PI_OVER_4 = 0.785398163397448310


def _asymptotic_pq(z):
    y2 = z * z
    p = 1.0 + y2 * (-0.1098628627e-2 + y2 * (0.2734510407e-4
        + y2 * (-0.2073370639e-5 + y2 * 0.2093887211e-6)))
    q = -0.1562499995e-1 + y2 * (0.1430488765e-3 + y2 * (-0.6911147651e-5
        + y2 * (0.7621095161e-6 + y2 * (-0.934935152e-7))))
    return p, q


def bessel_j0(x):
    'Bessel function of the first kind, order zero, for a real tensor x.'

    ax = torch.abs(x)

    # |x| < 8: rational approximation in y = x^2
    y = x * x
    num = 57568490574.0 + y * (-13362590354.0 + y * (651619640.7
          + y * (-11214424.18 + y * (77392.33017 + y * (-184.9052456)))))
    den = 57568490411.0 + y * (1029532985.0 + y * (9494680.718
          + y * (59272.64853 + y * (267.8532712 + y))))
    small = num / den

    # |x| >= 8: asymptotic form
    axs = torch.where(ax > 0, ax, torch.ones_like(ax))
    z = 8.0 / axs
    xx = ax - _PI_OVER_4
    p, q = _asymptotic_pq(z)
    large = torch.sqrt(_TWO_OVER_PI / axs) * (
        torch.cos(xx) * p - z * torch.sin(xx) * q)

    return torch.where(ax < 8.0, small, large)


def bessel_y0(x):
    'Bessel function of the second kind, order zero, for real x > 0.'

    xs = torch.where(x > 0, x, torch.ones_like(x))  # guard log/sqrt

    y = xs * xs
    num = -2957821389.0 + y * (7062834065.0 + y * (-512359803.6
          + y * (10879881.29 + y * (-86327.92757 + y * 228.4622733))))
    den = 40076544269.0 + y * (745249964.8 + y * (7189466.438
          + y * (47447.26470 + y * (226.1030244 + y))))
    small = num / den + _TWO_OVER_PI * bessel_j0(xs) * torch.log(xs)

    z = 8.0 / xs
    xx = xs - _PI_OVER_4
    p, q = _asymptotic_pq(z)
    large = torch.sqrt(_TWO_OVER_PI / xs) * (
        torch.sin(xx) * p + z * torch.cos(xx) * q)

    out = torch.where(xs < 8.0, small, large)
    # Y0 -> -inf as x -> 0+; undefined for x <= 0
    return torch.where(x > 0, out, torch.full_like(out, -float('inf')))


def hankel1_0(x):
    '''
    Hankel function of the first kind, order zero, H0^(1)(x) =
    J0(x) + i Y0(x), for a real tensor x >= 0.
    '''

    return torch.complex(bessel_j0(x), bessel_y0(x))


def bessel_i0(x):
    'Modified Bessel function of the first kind, order zero (real x).'

    return torch.special.i0(x)


def sinc(x):
    'Normalized sinc, matching numpy.sinc: sin(pi x) / (pi x).'

    return torch.sinc(x)
