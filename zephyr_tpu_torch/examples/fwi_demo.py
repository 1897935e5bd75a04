'''
End-to-end FWI demo: recover a velocity anomaly on a layered model.

The analogue of the reference's notebooks/Test Inversion.ipynb workflow
(a transmission-geometry square-anomaly inversion driven by L-BFGS) and
of the Test Gradient Computation notebooks, scripted, with the exact
misfit gradient of Helm2DProblem each iteration.

    python -m zephyr_tpu_torch.examples.fwi_demo [--nx 100 --nz 200
        --maxiter 10] [--device cpu] [--out fwi_demo_model.npy]

The card runs complex64 (solver tol 1e-5), the CPU complex128 (1e-7).
'''

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--nx', type=int, default=100)
    parser.add_argument('--nz', type=int, default=200)
    parser.add_argument('--maxiter', type=int, default=10)
    parser.add_argument('--freqs', type=float, nargs='+',
                        default=[50., 100., 150., 200.])
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--out', default='fwi_demo_model.npy')
    args = parser.parse_args(argv)

    from zephyr_tpu_torch.backend import MiniZephyr
    from zephyr_tpu_torch.middleware import (Helm2DProblem, Helm2DSurvey,
                                             l2_DataMisfit, BaseInvProblem,
                                             BaseInversion, LBFGS)

    nz, nx = args.nz, args.nx
    c0 = 2500.

    # --- acquisition: transmission geometry (sources left, recs right) ----
    nsrc, nrec = 12, 24
    srcs = np.column_stack([np.full(nsrc, 5.),
                            np.linspace(5., nz - 5., nsrc)])
    recs = np.column_stack([np.full(nrec, nx - 5.),
                            np.linspace(5., nz - 5., nrec)])

    sc = {
        'Disc': MiniZephyr,
        'nx': nx, 'nz': nz, 'dx': 1., 'dz': 1.,
        'c': c0 * np.ones((nz, nx)),
        'rho': 1.,
        'freqs': list(args.freqs),
        'geom': {'src': srcs, 'rec': recs, 'mode': 'fixed'},
        'nPML': 10,
        'device': args.device,
        'solverOpts': {'tol': 1e-7 if args.device == 'cpu' else 1e-5,
                       'maxiter': 500},
    }

    # --- true model: layered + box anomaly --------------------------------
    c_true = c0 * np.ones((nz, nx))
    c_true[nz // 2:] += 200.
    c_true[2 * nz // 5: 3 * nz // 5, 2 * nx // 5: 3 * nx // 5] -= 300.

    print('Generating observed data (%d freqs x %d srcs x %d recs)...'
          % (len(args.freqs), nsrc, nrec))
    sc_true = dict(sc, c=c_true)
    p_true, s_true = Helm2DProblem(sc_true), Helm2DSurvey(sc_true)
    p_true.pair(s_true)
    dobs = s_true.dpred()

    # --- inversion: start from the layered background ---------------------
    c_start = c0 * np.ones((nz, nx))
    c_start[nz // 2:] += 200.
    sc_inv = dict(sc, c=c_start)
    problem, survey = Helm2DProblem(sc_inv), Helm2DSurvey(sc_inv)
    problem.pair(survey)

    dmisfit = l2_DataMisfit(survey, dobs)
    f0 = dmisfit.eval()
    print('initial misfit: %.4e' % f0)

    opt = LBFGS(maxIter=args.maxiter, lower=c0 - 600., upper=c0 + 600.)
    inversion = BaseInversion(BaseInvProblem(dmisfit, opt=opt))
    m = inversion.run(c_start.ravel())

    print('final misfit:   %.4e  (%.1f%% of initial)'
          % (opt.f, 100. * opt.f / f0))
    dm = m.reshape(nz, nx) - c_start
    box = dm[2 * nz // 5: 3 * nz // 5, 2 * nx // 5: 3 * nx // 5]
    print('recovered anomaly mean in true-box region: %+.1f m/s '
          '(true: -300)' % box.mean())
    print('background |update|: %.1f m/s' % np.abs(dm).mean())

    np.save(args.out, m.reshape(nz, nx))
    print('recovered model saved to', args.out)
    return {'f0': f0, 'f': opt.f, 'box_mean': float(box.mean())}


if __name__ == '__main__':
    main()
