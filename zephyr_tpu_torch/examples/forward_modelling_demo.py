'''
Forward-modelling demo: the reference's "Compare Solutions Homogeneous"
notebook as a script: MiniZephyr and Eurus against the analytical
Green's-function oracle, plus the viscoacoustic dispersion check from the
"Test Dispersion" notebook, with hard assertions.

    python -m zephyr_tpu_torch.examples.forward_modelling_demo [--device cpu]
'''

import argparse

import numpy as np


def element_norm(arr):
    return np.sqrt((arr.conj() * arr).sum()).real / arr.size


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from zephyr_tpu_torch.backend import (MiniZephyr, Eurus, SimpleSource,
                                          StackedSimpleSource,
                                          AnalyticalHelmholtz, MultiFreq,
                                          ViscoMultiFreq, MiniZephyrHD)

    nx, nz, freq = 100, 200, 200.
    sloc = np.array([[25., 25.]])
    seg = (slice(40, 180), slice(40, 80))

    # --- MiniZephyr vs oracle ----------------------------------------------
    sc = {'c': 2500., 'rho': 1., 'nx': nx, 'nz': nz, 'freq': freq,
          'device': args.device}
    uMZ = (MiniZephyr(sc) * SimpleSource(sc)(sloc)).ravel()
    uAH = np.asarray(AnalyticalHelmholtz(sc)(sloc))
    err = element_norm((uAH.reshape(nz, nx)[seg]
                        - uMZ.reshape(nz, nx)[seg])
                       / abs(uAH.reshape(nz, nx)[seg]))
    print('MiniZephyr vs analytical: %.2e  (reference tol 1e-2)' % err)
    assert err < 1e-2

    # --- Eurus (isotropic parameters) vs oracle -----------------------------
    scE = {'c': 2000. * np.ones((nz, nx)), 'rho': np.ones((nz, nx)),
           'freq': freq, 'nx': nx, 'nz': nz, 'dx': 1., 'dz': 1.,
           'theta': np.zeros((nz, nx)), 'eps': np.zeros((nz, nx)),
           'delta': np.zeros((nz, nx)), 'nPML': 10, 'cPML': 1e3,
           'device': args.device}
    uE = (Eurus(scE) * StackedSimpleSource(scE)(sloc)).ravel()
    uAH2 = np.asarray(AnalyticalHelmholtz(scE)(sloc))
    errE = element_norm((uAH2.reshape(nz, nx)[seg]
                         - uE[:nz * nx].reshape(nz, nx)[seg])
                        / abs(uAH2.reshape(nz, nx)[seg]))
    print('Eurus (isotropic) vs analytical: %.2e  (reference tol 3e-2)'
          % errE)
    assert errE < 3e-2

    # --- viscoacoustic dispersion (Test Dispersion notebook) ----------------
    scV = {'Disc': MiniZephyrHD, 'c': 2500. * np.ones((nz, nx)),
           'rho': 1., 'nx': nx, 'nz': nz, 'freqs': [100., 200.],
           'device': args.device}
    q = SimpleSource(dict(scV, freq=100.))(sloc)
    u_elastic = MultiFreq(scV) * q
    u_visco = ViscoMultiFreq(dict(scV, Q=20., freqBase=200.)) * q
    shift = np.angle(np.vdot(u_elastic[0].ravel(),
                             u_visco[0].ravel()))
    print('Q=20 dispersion phase rotation at 100 Hz: %.3f rad '
          '(nonzero = causal dispersion active)' % shift)
    assert abs(shift) > 1e-3

    print('all forward-modelling checks passed')
    return {'minizephyr': err, 'eurus': errE, 'dispersion': shift}


if __name__ == '__main__':
    main()
