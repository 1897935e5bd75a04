'''
Driver entry points for zephyr_tpu_torch: the port of the JAX package's
``__graft_entry__.py``.

- ``entry()`` returns a single-device forward step on the flagship model
  (MiniZephyr multi-frequency, multi-source forward modelling to a
  receiver data cube) plus example arguments. Complex tensors go in and
  come out as they are (torch moves complex data; the JAX package's
  re/im split around ``core/realio.py`` is not needed).
- ``dryrun_multichip(n)`` builds an n-device ('freq', 'src') mesh, runs
  the FULL FWI training step (forward + adjoint gradient + model update)
  with frequencies and sources sharded over it, and one spatially
  decomposed forward, on tiny shapes, each against its single-device
  answer.

    python -m zephyr_tpu_torch.entry [--device cpu] [--dryrun N]
'''

import argparse

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE, resolve_device, resolve_dtype

#: sharded vs single-device bounds of the dry-run: the FWI step's
#: gradient and misfit, and the spatially decomposed forward's data
#: (relative), in complex128 (CPU) and complex64 (the card, where the DD
#: forward measured 2.3e-6)
DRYRUN_GRAD_BOUND = 1e-3
DRYRUN_MISFIT_BOUND = 1e-4
DRYRUN_DD_BOUND = 1e-5


def _tiny_problem(nz=48, nx=40, nfreq=2, nsrc=2, nrec=3,
                  dtype=np.complex64):
    c = 2000. * np.ones((nz, nx), dtype=np.float32)
    rho = np.ones((nz, nx), dtype=np.float32)
    freqs = np.linspace(40., 40. + 20. * (nfreq - 1), nfreq,
                        dtype=np.float32)
    q = np.zeros((nfreq, nsrc, nz, nx), dtype=dtype)
    for s in range(nsrc):
        q[:, s, 10 + 5 * s, 8] = 1.0
    R = np.zeros((nrec, nz * nx), dtype=dtype)
    for r in range(nrec):
        R[r, (12 + 8 * r) * nx + (nx - 8)] = 1.0
    return c, rho, freqs, q, R


def entry(device=DEFAULT_DEVICE):
    '''
    Returns (fn, example_args): a forward step (velocity model (nz, nx),
    source fields (nfreq, nsrc, nz, nx) complex64) -> data cube (nfreq,
    nsrc, nrec), on ``device`` (default the card).
    '''

    from .parallel.multifreq import multifreq_dpred
    from .solver.helmholtz import SolverConfig

    dev = resolve_device(device)
    c, rho, freqs, q, R = _tiny_problem()
    cfg = SolverConfig(tol=1e-5, maxiter=200, mg_coarse='inv')
    rho_t = torch.as_tensor(rho, device=dev)

    def forward_step(c_model, q_fields):
        return multifreq_dpred(c_model, rho_t, freqs, q_fields, R,
                               config=cfg, nPML=8, device=dev)

    example_args = (torch.as_tensor(c, device=dev),
                    torch.as_tensor(q, device=dev))
    return forward_step, example_args


def _rel(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float(torch.linalg.norm((a - b).flatten())
                 / max(float(torch.linalg.norm(b.flatten())), 1e-30))


def dryrun_multichip(n_devices, device=DEFAULT_DEVICE):
    '''
    Create an n-device ('freq', 'src') mesh, run the full FWI training
    step over it (frequencies and sources sharded, the framework's
    data-parallel axes; the model and receivers replicated) and ONE step
    on tiny shapes, against the same step on a 1-device mesh (gradient
    within ``DRYRUN_GRAD_BOUND``, misfit within ``DRYRUN_MISFIT_BOUND``);
    then a spatially decomposed forward ((z, x) tiles on 4 devices, x
    slabs on 2 or 3) against ``multifreq_dpred`` (``DRYRUN_DD_BOUND``).

    One process: the mesh is virtual, its devices ``cuda:i % count`` on
    the card (complex64) or ``cpu`` repeated when ``device='cpu'``
    (complex128). Mesh semantics match the reference's frequency/source
    pool fan-out (zephyr/backend/distributors.py:70-193). Returns the
    measured differences.
    '''

    from .parallel import make_mesh, make_sharded_fwi_step
    from .parallel.mesh import Mesh
    from .parallel.multifreq import multifreq_dpred
    from .parallel.spatial import make_dd_dpred
    from .solver.helmholtz import SolverConfig

    dev = resolve_device(device)
    if dev.type == 'cuda':
        count = torch.cuda.device_count()
        devices = [torch.device('cuda', i % count) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    cdtype = resolve_dtype(None, dev)
    np_c = np.complex128 if cdtype == torch.complex128 else np.complex64
    n = len(devices)
    src = 2 if n % 2 == 0 and n >= 2 else 1
    freq = n // src
    mesh = make_mesh(freq=freq, src=src, devices=devices)

    nfreq = max(freq, 2)
    nsrc = max(src, 2)
    c, rho, freqs, q, R = _tiny_problem(nz=40, nx=32, nfreq=nfreq,
                                        nsrc=nsrc, dtype=np_c)
    # tol 1e-6 where the JAX package's dry-run has 1e-4: the port's
    # batched solves are not bit-identical across batch sizes (a
    # one-column matmul runs as a matrix-vector product), and the
    # rounding moves a solve stopped at 1e-4 enough to shift the gradient
    # by 1.8e-3 and at 1e-5 the misfit by 1.8e-4 (CPU, complex128)
    cfg = SolverConfig(tol=1e-6, maxiter=400, mg_coarse='inv',
                       mg_min_size=16)

    # observed data from a perturbed model
    c_true = c.copy()
    c_true[18:26, 12:20] -= 100.
    with torch.no_grad():
        dobs = multifreq_dpred(c_true, rho, freqs, q, R, config=cfg, nPML=8,
                               device=devices[0]).cpu().numpy()

    step = make_sharded_fwi_step(mesh, rho, freqs, q, R, dobs, lr=1e6,
                                 config=cfg, nPML=8)
    c0 = torch.as_tensor(c, device=devices[0])
    c1, misfit, grad = step(c0)
    if not (bool(torch.isfinite(misfit)) and bool(torch.isfinite(grad).all())
            and c1.shape == c0.shape):
        raise RuntimeError('dryrun_multichip: misfit %r, finite gradient %s'
                           % (float(misfit),
                              bool(torch.isfinite(grad).all())))

    # sharded-vs-single-device equality: the same FWI step on a 1-device
    # mesh must produce the same misfit and gradient
    mesh1 = make_mesh(freq=1, src=1, devices=devices[:1])
    step1 = make_sharded_fwi_step(mesh1, rho, freqs, q, R, dobs, lr=1e6,
                                  config=cfg, nPML=8)
    _, misfit1, grad1 = step1(c0)
    gdiff = _rel(grad.cpu(), grad1.cpu())
    mdiff = abs(float(misfit) - float(misfit1)) / max(abs(float(misfit1)),
                                                      1e-30)
    if not gdiff <= DRYRUN_GRAD_BOUND:
        raise RuntimeError('sharded grad != single-device grad (%.3e)'
                           % gdiff)
    if not mdiff <= DRYRUN_MISFIT_BOUND:
        raise RuntimeError('sharded misfit != single-device (%.3e)' % mdiff)
    print('dryrun_multichip(%d): mesh=%s misfit=%.3e |grad|=%.3e '
          'sharded-vs-single grad rel.diff=%.3e misfit rel.diff=%.3e'
          % (n_devices, mesh.shape, float(misfit),
             float(torch.linalg.norm(grad)), gdiff, mdiff), flush=True)
    out = {'mesh': mesh.shape, 'misfit': float(misfit), 'grad_rel': gdiff,
           'misfit_rel': mdiff}

    # spatial domain decomposition on the same devices: an ('x',)- or
    # ('z','x')-sharded forward must match the single-device answer
    nsp = 4 if n >= 4 else n
    if nsp >= 2:
        sp = np.empty(nsp, dtype=object)
        sp[:] = devices[:nsp]
        if nsp % 2 == 0 and nsp >= 4:
            dd_mesh = Mesh(sp.reshape(2, nsp // 2), ('z', 'x'))
            dd_kw = dict(axis_name='x', axis_z='z')
        else:
            dd_mesh = Mesh(sp, ('x',))
            dd_kw = dict(axis_name='x')
        nz, nx = c.shape
        Rg = R.reshape(R.shape[0], nz, nx)
        # both sides at tight tolerance so the comparison pins the DD
        # decomposition itself, not the outer solver tolerance (complex64
        # at 1e-6). overlap=0: the dry-run's shards are
        # sub-wavelength, where overlapped Schwarz is measured harmful
        # (the RAS path runs at realistic shard sizes in the tests and in
        # chip_smoke.py phase 14)
        cfg_dd = cfg._replace(
            tol=1e-7 if cdtype == torch.complex128 else 1e-6)
        dd = make_dd_dpred(dd_mesh, freqs, cfg_dd, nPML=8, overlap=0,
                           **dd_kw)
        d_dd, dd_info = dd(c + 0j, rho, q, Rg)
        with torch.no_grad():
            d_ref = multifreq_dpred(c + 0j, rho, freqs, q, R, config=cfg_dd,
                                    nPML=8, device=devices[0])
        dd_rel = _rel(d_dd.cpu(), d_ref.cpu())
        if not dd_rel <= DRYRUN_DD_BOUND:
            raise RuntimeError('DD forward != single-device (%.3e > %.0e)'
                               % (dd_rel, DRYRUN_DD_BOUND))
        print('dryrun_multichip(%d): spatial DD mesh=%s forward '
              'rel.diff=%.3e (iters per freq: %s)'
              % (n_devices, dd_mesh.shape, dd_rel,
                 [i for i, _ in dd_info]), flush=True)
        out.update(dd_mesh=dd_mesh.shape, dd_rel=dd_rel,
                   dd_iters=[i for i, _ in dd_info])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[1])
    ap.add_argument('--device', default=DEFAULT_DEVICE)
    ap.add_argument('--dryrun', type=int, default=0, metavar='N',
                    help='also run dryrun_multichip(N)')
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    d = fn(*example_args)
    print('entry forward:', tuple(d.shape), d.dtype)
    if args.dryrun:
        dryrun_multichip(args.dryrun, device=args.device)


if __name__ == '__main__':
    main()
