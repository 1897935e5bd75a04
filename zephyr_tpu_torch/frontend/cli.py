'''
Command-line interface for zephyr_tpu_torch: the port of
``zephyr_tpu.frontend.cli``.

    zephyr-tpu-torch <command> PROJNM [options] [--device DEVICE]
    python -m zephyr_tpu_torch.frontend.cli <command> ...

The same commands, arguments, options and printed lines as the JAX
package's ``zephyr-tpu`` (clean, init, invert, inspect, migrate, model,
pack, unpack), built on argparse. Every command takes ``--device``
(default 'cuda'): the jobs run on the card unless 'cpu' is asked for,
and without a card the default refuses to start.
'''

import argparse
import glob
import os
import pickle
import sys

from ..core.device import DEFAULT_DEVICE, resolve_device


def _job_class(name):
    '''The job class of ``--job``; anything but a Job raises ValueError.'''
    from . import jobs
    jClass = getattr(jobs, name, None)
    if not (isinstance(jClass, type) and issubclass(jClass, jobs.Job)):
        raise ValueError('--job %s: not a job class of '
                         'zephyr_tpu_torch.frontend.jobs' % (name,))
    return jClass


def clean(args):
    'Clean up project results / outputs'

    projnm = args.projnm
    if not args.yes:
        answer = input('Are you sure you want to clean project outputs? '
                       '[y/N]: ')
        if answer.strip().lower() not in ('y', 'yes'):
            print('Aborted!')
            return 1
    patterns = ['%s.utout' % projnm, '%s[0-9]*.vp' % projnm,
                '%s[0-9]*.gvp' % projnm, '%s.pickle.out' % projnm]
    removed = []
    for pattern in patterns:
        for fn in glob.glob(pattern):
            os.remove(fn)
            removed.append(fn)
    print('Removed %d output files' % len(removed))
    for fn in removed:
        print('\t%s' % fn)
    return 0


def init(args):
    'Set up a new modelling or inversion project'

    projnm = args.projnm
    print('Initializing project %s (storage: %s)' % (projnm, args.storage))
    if args.fromini is not None:
        with args.fromini as src, open('%s.ini' % projnm, 'w') as fp:
            fp.write(src.read())
        print('Wrote %s.ini' % projnm)
    return 0


def invert(args):
    'Run an inversion project'

    j = _job_class(args.job)(args.projnm,
                             supplementalConfig={'device': args.device})
    if hasattr(j, 'maxIter'):
        j.maxIter = args.maxiter
    j.run()
    return 0


def inspect(args):
    'Print information about an existing project'

    import numpy as np
    from ..middleware import FullwvDatastore

    ds = FullwvDatastore(args.projnm)
    sc = ds.systemConfig
    print(repr(ds))
    print('Grid:        %d x %d cells, dx=%g dz=%g'
          % (sc['nx'], sc['nz'], sc['dx'], sc['dz']))
    print('Frequencies: %d (%g - %g Hz)'
          % (len(sc['freqs']), sc['freqs'][0], sc['freqs'][-1]))
    print('Sources:     %d' % sc['geom']['src'].shape[0])
    print('Receivers:   %d' % sc['geom']['rec'].shape[0])
    for key in ('c', 'Q', 'rho', 'eps', 'delta', 'theta'):
        if key in sc:
            v = np.asarray(sc[key])
            print('Model %-6s shape %s, range [%g, %g]'
                  % (key, v.shape, v.min(), v.max()))
    return 0


def migrate(args):
    'Run a migration (single adjoint-state gradient image)'

    _job_class(args.job)(args.projnm,
                         supplementalConfig={'device': args.device}).run()
    return 0


def model(args):
    'Run a forward model'

    _job_class(args.job)(args.projnm,
                         supplementalConfig={'device': args.device}).run()
    return 0


def pack(args):
    'Collect project configuration into a portable pickle datafile'

    from ..middleware import FullwvDatastore

    projnm = args.projnm
    sc = FullwvDatastore(projnm).systemConfig
    with open('%s.pickle' % projnm, 'wb') as fp:
        pickle.dump(sc, fp)
    print('Packed %s -> %s.pickle' % (projnm, projnm))
    return 0


def unpack(args):
    'Extract configuration from a packed datafile'

    projnm = args.projnm
    with open('%s.pickle' % projnm, 'rb') as fp:
        sc = pickle.load(fp)
    print('Unpacked %s.pickle: %d keys' % (projnm, len(sc)))
    for key in sorted(sc, key=str):
        print('\t%s' % key)
    return 0


def parser():
    'The argparse parser of the ``zephyr-tpu-torch`` command.'

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument('projnm')
    common.add_argument('--device', default=DEFAULT_DEVICE,
                        help="torch device of the solves (default "
                             "'cuda'; 'cpu' for the CPU)")
    top = argparse.ArgumentParser(
        prog='zephyr-tpu-torch',
        description='A command-line interface for zephyr_tpu_torch')
    sub = top.add_subparsers(dest='command', required=True)

    def command(fn):
        p = sub.add_parser(fn.__name__, parents=[common], help=fn.__doc__,
                           description=fn.__doc__)
        p.set_defaults(run=fn)
        return p

    command(clean).add_argument(
        '--yes', action='store_true',
        help='Confirm the action without prompting.')
    p = command(init)
    p.add_argument('--storage', choices=['dir', 'hdf5'], default='dir')
    p.add_argument('--fromini', type=argparse.FileType('r'))
    p = command(invert)
    p.add_argument('--job', default='OmegaInversionJob',
                   help='The job to run')
    p.add_argument('--maxiter', type=int, default=10,
                   help='Maximum FWI iterations')
    command(inspect)
    command(migrate).add_argument('--job', default='OmegaMigrationJob',
                                  help='The job to run')
    command(model).add_argument('--job', default='OmegaJob',
                                help='The job to run')
    command(pack)
    command(unpack)
    return top


def main(argv=None):
    '''
    Run one command (``argv``, default sys.argv[1:]); returns the exit
    code. The device is resolved first, so without a card the default
    'cuda' refuses to start.
    '''

    args = parser().parse_args(argv)
    resolve_device(args.device)
    return args.run(args)


if __name__ == '__main__':
    sys.exit(main())
