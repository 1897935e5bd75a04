'''
Multi-frequency FWI on one device: the port of the production gradient
routine of ``zephyr_tpu.parallel.multifreq``.

``fwi_misfit_grad_chunked`` is the host-driven adjoint-state FWI misfit
and gradient: per frequency one prepared forward operator and one on the
transposed planes, restarted chunked solves for the source batch
(forward, then adjoint), and the gradient term through the
differentiable plane construction (autograd). ``freq_grid_plan`` picks
each frequency's grid by the reference's targetGPW rule; ``_kaiser_stamps``
builds the per-grid source and receiver stamps.
'''

import math
import time

import numpy as np
import torch

from ..backend.interpolation import resample_field
from ..ops.kaiser import inject
from ..ops.minizephyr_coeff import minizephyr_planes
from ..ops.stencil import plane_products, transpose_block_planes
from ..solver.helmholtz import (SolverConfig, make_chunked_solver,
                                prepare_operator, resolve_panels,
                                shifted_velocity)


def viscous_velocity(c, freq, Q=np.inf, freqBase=0.0):
    '''
    The ViscoMultiFreq dispersion transform as a pure function
    (reference distributors.py:326-359): Kolsky-Futterman causal
    dispersion plus constant-Q imaginary part. ``c`` is a complex tensor,
    ``freq`` a number, ``Q`` a number or an (nz, nx) array.
    '''

    # the dispersion on/off decision is static (Q is a config constant)
    disperse = bool(np.any(np.asarray(Q) != np.inf)) and freqBase > 0
    Q = torch.as_tensor(np.asarray(Q, dtype=np.float64),
                        dtype=c.real.dtype, device=c.device)
    if disperse:
        fact = 1. + (math.log(float(freq) / freqBase) / (np.pi * Q))
        cR = fact * c
        return cR + 0.5j * cR / Q
    return c + 0.5j * c / Q


def freq_grid_plan(nz, nx, freqs, cmin, dx=1.0, target_gpw=None,
                   max_scale=10.0, quantum=None, min_size=128):
    '''
    Per-frequency grid shapes by the reference's targetGPW rule
    (MultiGridHelper.scales, reference distributors.py:515-573):
    scale = median(cmin / (freq * dx * targetGPW), max_scale, 1). Shapes
    snap UP to a coarse quantum (default n/4, min 256), so no frequency
    solves below the target gridpoints-per-wavelength and the number of
    distinct shapes stays small. A copy of the JAX package's function
    (numpy only), so both packages solve on the same grids.

    With target_gpw=None every frequency keeps the fine grid.

    The PML decay profile of the true operator is frequency-independent,
    so on a fixed grid the relative stretch sigma/omega, and with it the
    preconditioned iteration count, grows at low frequency; constant
    gridpoints-per-wavelength keeps both kh and sigma/omega fixed.
    '''

    if target_gpw is None:
        return [(nz, nx)] * len(np.asarray(freqs))

    def _q(n):
        if quantum:
            return quantum
        return max(256, n // 4) if n >= 512 else max(32, n // 4)

    qz, qx = _q(nz), _q(nx)
    plans = []
    for f in np.asarray(freqs, dtype=np.float64):
        s = float(np.median(((cmin / (float(np.real(f)) * dx * target_gpw)),
                             max_scale, 1.0)))
        nzf = int(np.clip(np.ceil(nz / s / qz) * qz, min(min_size, nz),
                          nz))
        nxf = int(np.clip(np.ceil(nx / s / qx) * qx, min(min_size, nx),
                          nx))
        plans.append((nzf, nxf))
    return plans


def _kaiser_stamps(shape, dxf, dzf, pos, ireg, receiver=False):
    '''
    Padded Kaiser stamp arrays (cols (n, K) int32, vals (n, K) complex)
    for positions on a scaled grid. Source stamps keep the reference's
    1/(dx dz) point-source normalization (backend/source.py srcScale) so
    fields are grid-independent; receiver stamps are pure interpolation
    (the scale stripped), so data values are grid-independent too.
    '''

    from ..backend.source import SparseKaiserSource
    from ..ops.kaiser import pad_stamps

    src = SparseKaiserSource({'nx': shape[1], 'nz': shape[0],
                              'dx': dxf, 'dz': dzf, 'ireg': ireg})
    rows, cols, vals = src.stamps(np.asarray(pos, dtype=np.float64))
    if receiver:
        vals = vals * (dxf * dzf)
    return pad_stamps(rows, cols, vals, np.asarray(pos).shape[0])


def fwi_misfit_grad_chunked(c, rho, freqs, q, R, dobs,
                            config=SolverConfig(), premul=None, Q=np.inf,
                            freqBase=0.0, chunk=16, target_gpw=None,
                            src_pos=None, rec_pos=None, cmin=None,
                            dx=1.0, dz=1.0, ireg=4, max_scale=10.0,
                            grid_quantum=None, grid_min=128, device='cpu',
                            stats=None, **plane_kwargs):
    '''
    Production-scale FWI misfit + gradient: host-driven per-frequency
    loop with chunked restarted solves and an explicit adjoint-state
    gradient:

        F = 0.5 || R conj(x) - dobs ||^2,   x = A(c)^{-1} (premul q)
        grad F = -grad_c Re< w , A(c) x >,  w = A^{-T} (R^H r)

    — one extra chunked solve with the TRANSPOSED operator per frequency
    (the reference's adjoint-state Jtvec semantics,
    zephyr/middleware/problem.py:124-163), with the sensitivity flowing
    through the differentiable plane construction (``minizephyr_planes``).
    The same signature and semantics as
    ``zephyr_tpu.parallel.multifreq.fwi_misfit_grad_chunked``
    plus the device of the solves (``device``) and an optional ``stats``
    dict that receives the per-frequency grids, the (forward, adjoint)
    iteration counts of every source chunk and the host seconds of each
    phase.

    With ``target_gpw`` set (requires ``src_pos``/``rec_pos`` physical
    (x, z) positions and ``cmin``), every frequency solves on its own
    coarser grid chosen by the reference's targetGPW rule (see
    ``freq_grid_plan``); the velocity resamples differentiably inside the
    plane construction, so the returned gradient is the exact gradient of the
    multi-scale misfit w.r.t. the FINE-grid model; sources/receivers are
    rebuilt per scale from positions via Kaiser stamps (``q``/``R`` are
    ignored on this path and may be None).

    The working precision is that of ``q`` (or, with ``q`` None, of
    ``dobs``): complex64 or complex128; the CUDA kernels take complex64.

    Returns (misfit, grad) as (float, (nz, nx) real numpy array).
    '''

    dev = torch.device(device)
    c = np.asarray(c)
    adapted = target_gpw is not None
    if adapted:
        if src_pos is None or rec_pos is None:
            raise ValueError('target_gpw needs src_pos/rec_pos (physical '
                             '(x, z) positions)')
        nz, nx = c.shape
        nsrc = np.asarray(src_pos).shape[0]
        qdtype = np.asarray(q if q is not None else dobs).dtype
        if cmin is None:
            cmin = float(np.real(c).min())
    else:
        _, nsrc, nz, nx = q.shape
        qdtype = np.asarray(q).dtype
    if not (np.isrealobj(c) or np.allclose(np.imag(c), 0)):
        raise ValueError('fwi gradient is w.r.t. a real velocity model')
    qdtype = np.complex128 if qdtype == np.complex128 else np.complex64
    cdtype = torch.complex128 if qdtype == np.complex128 else torch.complex64
    rdtype = np.float64 if qdtype == np.complex128 else np.float32
    rho_r = np.asarray(np.real(rho)).astype(rdtype)
    c_r = np.real(c).astype(rdtype)
    c_t = torch.as_tensor(c_r, device=dev)

    plans = freq_grid_plan(nz, nx, freqs, cmin, dx=dx,
                           target_gpw=target_gpw, max_scale=max_scale,
                           quantum=grid_quantum, min_size=grid_min)

    def _spacing(shape):
        return dx * nx / shape[1], dz * nz / shape[0]

    def _planes_of(c_real, freq, shape, rho_j, pml_cap=None,
                   viscous=True):
        ci = c_real.to(cdtype)
        if viscous:
            ci = viscous_velocity(ci, freq, Q, freqBase)
        if shape != (nz, nx):
            ci = resample_field(ci, shape)
        dxf, dzf = _spacing(shape)
        pk = dict(plane_kwargs)
        if adapted:
            pk.update(dx=dxf, dz=dzf)
        if pml_cap is not None:
            pk['pml_cap'] = pml_cap
        return minizephyr_planes(ci, rho_j, freq, **pk)[None, None]

    def _shape_fns(shape):
        rho_j = torch.as_tensor(rho_r, device=dev)
        if shape != (nz, nx):
            rho_j = resample_field(rho_j, shape)
        # resolve the auto-panel default per SOLVE shape (the lateral
        # contrast comes from the fine host model; the panel count
        # tracks the shape actually solved on)
        cfg_s = resolve_panels(config, c_r, nx=shape[1])

        def prep_ops(freq):
            planes = _planes_of(c_t, freq, shape, rho_j)
            csh = shifted_velocity(c_t.to(cdtype), cfg_s.shift)
            pshift = _planes_of(csh, freq, shape, rho_j,
                                pml_cap=cfg_s.pml_cap, viscous=False)
            op_f = prepare_operator(planes, pshift, cfg_s,
                                    with_transpose=False)
            op_t = prepare_operator(transpose_block_planes(planes),
                                    transpose_block_planes(pshift), cfg_s,
                                    with_transpose=False)
            return op_f, op_t

        def residual_dense(x, R_j, dobs_f):
            # d = R conj(x); r = d - dobs; t = R^H r (adjoint receiver
            # fields)
            u = torch.conj(x[:, 0].reshape((x.shape[0], -1)))
            r = u @ R_j.T - dobs_f
            t = r @ torch.conj(R_j)
            mis = 0.5 * torch.sum(torch.abs(r) ** 2)
            return t.reshape((x.shape[0], 1) + shape), mis

        def residual_stamps(x, rcols, rvals, dobs_f):
            # the same algebra with gather/scatter Kaiser stamps: no
            # dense (nrec, n^2) matrix at production grid sizes
            S = x.shape[0]
            u = torch.conj(x[:, 0].reshape((S, -1)))
            d = torch.sum(u[:, rcols] * rvals[None], dim=-1)   # (S, nrec)
            r = d - dobs_f
            contrib = torch.conj(rvals)[None] * r[:, :, None]
            t = torch.zeros_like(u)
            t.index_add_(1, rcols.reshape(-1), contrib.reshape(S, -1))
            mis = 0.5 * torch.sum(torch.abs(r) ** 2)
            return t.reshape((S, 1) + shape), mis

        def grad_term(freq, w, x):
            # -d/dc Re< w , A(c) x >, with w, x held fixed; when the
            # solve grid is coarser the chain rule flows back through
            # the differentiable resample to the FINE model. With w, x
            # fixed, sum Re(w * A x) = sum Re(planes * G): one pass, not
            # autograd through a 9-shift apply
            G = plane_products(w[:, 0], x[:, 0])
            cr = c_t.clone().requires_grad_(True)
            with torch.enable_grad():
                pl9 = _planes_of(cr, freq, shape, rho_j)[0, 0]
                f = -torch.sum(torch.real(pl9 * G))
                g, = torch.autograd.grad(f, cr)
            return g

        return dict(prep=prep_ops, residual=residual_dense,
                    residual_st=residual_stamps, grad=grad_term,
                    solver=make_chunked_solver(cfg_s,
                                               chunk=max(chunk, 32)))

    fns = {}
    for shape in plans:
        if shape not in fns:
            fns[shape] = _shape_fns(shape)

    stamp_cache = {}

    def _stamps_for(shape):
        # the source fields are injected on the device, once per grid
        if shape not in stamp_cache:
            dxf, dzf = _spacing(shape)
            stamps = (_kaiser_stamps(shape, dxf, dzf, src_pos, ireg)
                      + _kaiser_stamps(shape, dxf, dzf, rec_pos, ireg,
                                       receiver=True))
            scols, svals, rcols, rvals = (
                torch.as_tensor(np.ascontiguousarray(a), device=dev)
                for a in stamps)
            svals, rvals = svals.to(cdtype), rvals.to(cdtype)
            stamp_cache[shape] = (inject(scols, svals, *shape)[:, None],
                                  rcols.long(), rvals)
        return stamp_cache[shape]

    timed = stats is not None
    tacc = {}

    def _tic():
        if timed and dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def _toc(key, t0):
        if timed:
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            tacc[key] = tacc.get(key, 0.0) + (time.perf_counter() - t0)

    R_t = (None if adapted
           else torch.as_tensor(np.asarray(R), device=dev).to(cdtype))
    misfit = 0.0
    grad = torch.zeros((nz, nx), dtype=c_t.dtype, device=dev)
    pm = None if premul is None else np.asarray(premul).ravel()
    solve_iters = []
    for i, f in enumerate(np.asarray(freqs)):
        f = float(f)
        shape = plans[i]
        sf = fns[shape]
        t0 = _tic()
        op_f, op_t = sf['prep'](f)
        _toc('prep', t0)
        if adapted:
            q_i, rcols, rvals = _stamps_for(shape)
        else:
            q_i = np.asarray(q[i])[:, None]
        for s0 in range(0, nsrc, chunk):
            s1 = min(s0 + chunk, nsrc)
            if adapted:
                b = q_i[s0:s1]
            else:
                b = torch.as_tensor(np.ascontiguousarray(q_i[s0:s1]),
                                    device=dev).to(cdtype)
            if pm is not None:
                b = b * complex(pm[i])
            t0 = _tic()
            x, it_f, _ = sf['solver'](op_f, b)
            _toc('fwd_solve', t0)
            dobs_f = torch.as_tensor(np.ascontiguousarray(
                np.asarray(dobs)[i, s0:s1]), device=dev).to(cdtype)
            t0 = _tic()
            if adapted:
                t, mis = sf['residual_st'](x, rcols, rvals, dobs_f)
            else:
                t, mis = sf['residual'](x, R_t, dobs_f)
            misfit += float(mis)
            _toc('residual', t0)
            t0 = _tic()
            w, it_a, _ = sf['solver'](op_t, t)
            _toc('adj_solve', t0)
            t0 = _tic()
            grad += sf['grad'](f, w, x)
            _toc('grad_term', t0)
            solve_iters.append((i, s0, int(it_f), int(it_a)))
    if timed:
        stats.update(shapes=plans, iters=solve_iters, seconds=tacc)
    return misfit, grad.cpu().numpy()
