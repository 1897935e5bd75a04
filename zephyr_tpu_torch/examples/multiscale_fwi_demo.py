'''
Multiscale FWI demo: frequency-continuation inversion with checkpointing.

BASELINE.md staged config 5 (the reference's Test Inversion /
MultiScale workflow): invert low-frequency blocks first, warm-starting
each block from the previous result, with an ``InversionCheckpointer``
checkpoint and a FULLWV-style iteration-numbered model file written per
block, then resumed from the latest of each.

    python -m zephyr_tpu_torch.examples.multiscale_fwi_demo [--device cpu]
        [--outdir DIR] [--maxiter 5] [--freqs 40 60 90 130]

The card runs complex64 (solver tol 1e-5), the CPU complex128 (1e-7).
'''

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--outdir', default='zephyr_tpu_torch_msdemo',
                        help='where the checkpoints and model files go')
    parser.add_argument('--maxiter', type=int, default=5,
                        help='L-BFGS iterations a frequency block')
    parser.add_argument('--freqs', type=float, nargs='+',
                        default=[40., 60., 90., 130.],
                        help='inverted low half first, then high half')
    args = parser.parse_args(argv)

    from zephyr_tpu_torch.backend import MiniZephyr
    from zephyr_tpu_torch.middleware import (Helm2DProblem, Helm2DSurvey,
                                             FrequencyContinuation, LBFGS,
                                             SEGYFile)
    from zephyr_tpu_torch.utils import (InversionCheckpointer,
                                        save_fullwv_model,
                                        latest_fullwv_model)

    nz, nx = 80, 60
    c0 = 2000.
    freqs = sorted(args.freqs)
    half = (len(freqs) + 1) // 2

    srcs = np.column_stack([np.full(8, 5.), np.linspace(5., nz - 5., 8)])
    recs = np.column_stack([np.full(16, nx - 5.),
                            np.linspace(5., nz - 5., 16)])
    sc = {
        'Disc': MiniZephyr,
        'nx': nx, 'nz': nz, 'dx': 1., 'dz': 1.,
        'c': c0 * np.ones((nz, nx)), 'rho': 1.,
        'freqs': freqs,
        'geom': {'src': srcs, 'rec': recs, 'mode': 'fixed'},
        'nPML': 8,
        'device': args.device,
        'solverOpts': {'tol': 1e-7 if args.device == 'cpu' else 1e-5,
                       'maxiter': 400},
    }

    c_true = c0 * np.ones((nz, nx))
    c_true[32:48, 22:38] -= 200.

    print('Generating observed data over %d frequencies...' % len(freqs))
    sc_true = dict(sc, c=c_true)
    pt, st = Helm2DProblem(sc_true), Helm2DSurvey(sc_true)
    pt.pair(st)
    dobs = st.dpred().reshape(16, 8, len(freqs))

    os.makedirs(args.outdir, exist_ok=True)
    ckpt = InversionCheckpointer(os.path.join(args.outdir, 'ckpt'))
    projnm = os.path.join(args.outdir, 'msdemo')

    driver = FrequencyContinuation(
        Helm2DProblem, Helm2DSurvey, sc, dobs,
        blocks=[list(range(half)), list(range(half, len(freqs)))],
        optFactory=lambda: LBFGS(maxIter=args.maxiter, lower=c0 - 400.,
                                 upper=c0 + 400., print_progress=True))

    m = c0 * np.ones(nz * nx)
    print('\n=== frequency-continuation inversion ===')
    m = driver.run(m)

    for iblock, record in enumerate(driver.history):
        print('block %d (freqs %s): final misfit %.3e'
              % (iblock, record['block'], record['f']))
        ckpt.save(iblock, {'model': m.reshape(nz, nx),
                           'misfit': np.array(record['f']),
                           'block': np.array(iblock)})
        save_fullwv_model(projnm, iblock + 1, m.reshape(nz, nx))

    step, state = ckpt.restore()
    print('checkpoint restore: step %s, misfit %.3e'
          % (step, float(state['misfit'])))
    it, fn = latest_fullwv_model(projnm)
    model = SEGYFile(fn)[:].T
    print('latest FULLWV model: iteration %d, %s' % (it, fn))
    assert step == len(driver.history) - 1
    assert it == len(driver.history)
    assert np.allclose(model, state['model'], rtol=1e-6)

    dm = m.reshape(nz, nx) - c0
    inner = dm[34:46, 24:36].mean()
    print('recovered anomaly mean in true box: %+.1f m/s (true -200)'
          % inner)
    assert inner < -20., 'anomaly not recovered'
    print('multiscale FWI demo passed')
    return {'history': driver.history, 'inner': float(inner)}


if __name__ == '__main__':
    main()
