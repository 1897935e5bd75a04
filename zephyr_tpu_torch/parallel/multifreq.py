'''
Multi-frequency modelling and FWI on one device: the port of
``zephyr_tpu.parallel.multifreq``.

- ``build_multifreq_ops`` prepares one Helmholtz operator per frequency
  (a list: the JAX package vmaps them into one pytree with a leading
  frequency axis); ``multifreq_solve`` solves every (frequency, source)
  system on them; ``multifreq_dpred`` is the differentiable forward map
  c -> data (nfreq, nsrc, nrec) and ``fwi_misfit`` its least-squares
  misfit, both differentiable with ``torch.autograd`` through the solve.
- ``multifreq_dpred_chunked`` is the host-driven production forward
  modelling: per frequency one prepared operator and restarted chunked
  solves over the source batch.
- ``multifreq_dpred_25d`` is 2.5D modelling: the Fourier summation over
  cross-line wavenumbers ky (``ky_summed_fields``), one prepared operator
  at a time.
- ``fwi_misfit_grad_chunked`` is the host-driven adjoint-state FWI misfit
  and gradient: per frequency one prepared forward operator and one on the
  transposed planes, restarted chunked solves for the source batch
  (forward, then adjoint), and the gradient term through the
  differentiable plane construction (autograd). ``freq_grid_plan`` picks
  each frequency's grid by the reference's targetGPW rule;
  ``_kaiser_stamps`` builds the per-grid source and receiver stamps.

Every entry point runs on the card unless the caller passes
``device='cpu'``. Receiver matrices are applied as gathers and sums over
their nonzeros: no matmul, so no TF32 setting reaches the data.
'''

import contextlib
import math

import numpy as np
import torch

from ..backend.interpolation import resample_field
from ..core.device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..ops.eurus_coeff import eurus_planes
from ..ops.kaiser import extract, inject, pad_stamps
from ..ops.minizephyr_coeff import minizephyr_planes
from ..ops.stencil import plane_products, transpose_block_planes
from ..solver.helmholtz import (SolverConfig, make_chunked_solver,
                                prepare_operator, resolve_panels,
                                shifted_velocity, solve_batched)
from ..utils.profiling import recording, span


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


def _complex_dtype(a):
    '''
    The working precision of a source array or tensor: complex128 for
    complex128 (or float64) data, else complex64.
    '''
    if isinstance(a, torch.Tensor):
        wide = a.dtype in (torch.complex128, torch.float64)
    else:
        wide = np.asarray(a).dtype in (np.complex128, np.float64)
    return torch.complex128 if wide else torch.complex64


def _field(a, dev, dtype):
    '''
    ``a`` (a numpy array, a number or a tensor) as a tensor of ``dtype``
    on ``dev``; a tensor keeps its autograd history. A real ``dtype``
    takes the real part of complex input.
    '''
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        if not dtype.is_complex:
            a = np.real(a)
        a = torch.as_tensor(np.ascontiguousarray(a))
    elif not dtype.is_complex and a.is_complex():
        a = a.real
    return a.to(device=dev, dtype=dtype)


def _freq_list(freqs):
    'The frequencies as a list of Python floats.'
    if isinstance(freqs, torch.Tensor):
        freqs = freqs.detach().cpu().numpy()
    return [float(f) for f in np.real(np.asarray(freqs)).ravel()]


def _receivers(R, dev, dtype):
    '''
    A receiver matrix R (nrec, nz * nx) as padded stamps (cols, vals)
    (nrec, K) on the device, its nonzeros: ``extract`` with them is R u
    per source, a gather and a sum, not a matmul.
    '''
    if isinstance(R, torch.Tensor):
        R = R.detach().cpu().numpy()
    R = np.asarray(R)
    rows, cols = np.nonzero(R)
    cols, vals = pad_stamps(rows, cols, R[rows, cols], R.shape[0])
    return (torch.as_tensor(cols, device=dev),
            torch.as_tensor(vals, device=dev).to(dtype))


def build_multifreq_ops(c, rho, freqs, config=SolverConfig(), ky=0.0,
                        Q=np.inf, freqBase=0.0, eurus_params=None,
                        device=DEFAULT_DEVICE, dtype=None, **plane_kwargs):
    '''
    Build per-frequency Helmholtz operators (planes + multigrid
    hierarchies + stratified solve), one HelmholtzOperator per frequency
    in a list. Differentiable w.r.t. c and rho: each operator's
    ``planes`` carry the autograd history of ``c`` (the preconditioner is
    built from detached planes).

    Args:
        c: (nz, nx) real or complex velocity (array or tensor)
        rho: (nz, nx) density
        freqs: (nfreq,) frequencies
        eurus_params: None for MiniZephyr; dict(theta, eps, delta, cPML)
            for the Eurus TTI operator (its transposed parts, which the
            backward needs, only when ``c`` or ``rho`` requires grad with
            autograd on: the numbers are the same, and the transposed
            line states cost memory)
        device: the card unless 'cpu' is asked for
        dtype: complex64 or complex128 (default: complex64 on the card,
            complex128 on the CPU)
        plane_kwargs: dx, dz, nPML, tau, freeSurf

    Returns:
        [HelmholtzOperator] of length nfreq.
    '''

    dev = resolve_device(device)
    cdtype = resolve_dtype(dtype, dev)
    rdtype = torch.empty((), dtype=cdtype).real.dtype
    c = _field(c, dev, cdtype)
    rho = _field(rho, dev, rdtype)
    with_transpose = eurus_params is None or (
        (c.requires_grad or rho.requires_grad) and torch.is_grad_enabled())
    if eurus_params is not None:
        eurus_params = {k: (v if k == 'cPML' else _field(v, dev, rdtype))
                        for k, v in eurus_params.items()}

    ops = []
    for freq in _freq_list(freqs):
        ci = viscous_velocity(c, freq, Q, freqBase)
        csh = shifted_velocity(ci.detach(), config.shift)
        if eurus_params is None:
            planes = minizephyr_planes(ci, rho, freq, ky=ky,
                                       **plane_kwargs)[None, None]
            pplanes = minizephyr_planes(csh, rho, freq, ky=ky,
                                        pml_cap=config.pml_cap,
                                        **plane_kwargs)[None, None]
        else:
            planes = eurus_planes(ci, rho, freq, **eurus_params,
                                  **plane_kwargs)
            pplanes = eurus_planes(csh, rho, freq, pml_cap=config.pml_cap,
                                   **eurus_params, **plane_kwargs)
        ops.append(prepare_operator(planes, pplanes, config,
                                    with_transpose=with_transpose))
    return ops


def multifreq_solve(ops, b, config=SolverConfig()):
    '''
    Solve all (freq, src) systems: b (nfreq, nsrc, B, nz, nx) on the
    operators' device (a numpy array is moved there); returns wavefields
    of the same shape, conjugated per the reference FT convention
    (discretization.py:101-103). Differentiable through each operator's
    planes and through b.
    '''

    planes0 = ops[0].planes
    b = _field(b, planes0.device, planes0.dtype)
    xs = [solve_batched(op._replace(planes=op.planes.detach()), b[i],
                        config, planes=op.planes)
          for i, op in enumerate(ops)]
    return torch.conj_physical(torch.stack(xs))


def multifreq_dpred(c, rho, freqs, q, R, config=SolverConfig(),
                    premul=None, Q=np.inf, freqBase=0.0,
                    eurus_params=None, device=DEFAULT_DEVICE,
                    **plane_kwargs):
    '''
    The differentiable forward map c (nz, nx) -> data cube
    (nfreq, nsrc, nrec), a tensor on ``device``.

    Args:
        q: (nfreq, nsrc, nz, nx) source fields (already weighted by the
           per-frequency source spectrum); their dtype (complex128, else
           complex64) is the working precision
        R: (nrec, nz*nx) receiver extraction matrix
        premul: (nfreq,) complex premultipliers (e.g. half-derivative)
    '''

    dev = resolve_device(device)
    cdtype = _complex_dtype(q)
    q = _field(q, dev, cdtype)
    nfreq = q.shape[0]
    ops = build_multifreq_ops(c, rho, freqs, config, Q=Q,
                              freqBase=freqBase, eurus_params=eurus_params,
                              device=dev, dtype=cdtype, **plane_kwargs)
    b = q if premul is None else q * _field(premul, dev, cdtype).reshape(
        (nfreq, 1, 1, 1))
    b = b[:, :, None]                      # (nfreq, nsrc, 1, nz, nx)
    if eurus_params is not None:
        b = torch.cat([b, torch.zeros_like(b)], dim=2)
    u = multifreq_solve(ops, b, config)    # (nfreq, nsrc, B, nz, nx)
    return extract(u[:, :, 0], *_receivers(R, dev, cdtype))


def ky_summed_fields(ci, rho, freq, b, nky, cmin, config=SolverConfig(),
                     **plane_kwargs):
    '''
    One frequency's 2.5D wavefields: the Fourier summation over cross-line
    wavenumbers with the reference MiniZephyr25D conventions
    (minizephyr.py:380-433): regular sampling dky = freq / (cmin
    (nky - 1)), inverse-DFT weights 1 + (ky > 0) with the 1 / (2 nky - 1)
    normalisation folded into per-ky premultipliers, the sum scaled by
    exp(i pi) / 4 pi.

    ``ci`` is the (nz, nx) complex velocity tensor (any dispersion
    applied), ``b`` the (nsrc, 1, nz, nx) right-hand sides. The ky loop
    runs on the host and holds one prepared operator at a time (the JAX
    package's lax.scan path), so memory does not grow with nky outside
    reverse-mode autograd, which keeps each ky's solve for the backward.
    Differentiable w.r.t. ``ci`` in forward and reverse mode. Returns the
    conjugated, ky-summed wavefields (nsrc, nz, nx).
    '''

    nky = int(nky)
    weightfac = 1. / (2 * nky - 1) if nky > 1 else 1.
    dky = freq / (cmin * (nky - 1)) if nky > 1 else 0.
    needs_grad = torch.is_grad_enabled() and ci.requires_grad
    csh = shifted_velocity(ci.detach(), config.shift)
    acc = None
    for j in range(nky):
        ky = j * dky
        premul = weightfac * (1. + (ky > 0))
        planes = minizephyr_planes(ci, rho, freq, ky=ky,
                                   **plane_kwargs)[None, None]
        pplanes = minizephyr_planes(csh, rho, freq, ky=ky,
                                    pml_cap=config.pml_cap,
                                    **plane_kwargs)[None, None]
        op = prepare_operator(planes.detach(), pplanes, config,
                              with_transpose=needs_grad)
        x = solve_batched(op, premul * b, config, planes=planes)
        del op
        u = torch.conj(x[:, 0])
        acc = u if acc is None else acc + u
    return (np.exp(1j * np.pi) / (4 * np.pi)) * acc


def multifreq_dpred_25d(c, rho, freqs, q, R, nky, cmin=None,
                        config=SolverConfig(), Q=np.inf, freqBase=0.0,
                        device=DEFAULT_DEVICE, **plane_kwargs):
    '''
    2.5D forward modelling: Fourier summation over cross-line wavenumbers
    (the reference's MiniZephyr25D, zephyr/backend/minizephyr.py:346-461)
    by ``ky_summed_fields``, one frequency and one ky at a time on the
    host. Returns the data cube (nfreq, nsrc, nrec), a tensor on
    ``device``, differentiable w.r.t. c. ``q`` (nfreq, nsrc, nz, nx) sets
    the working precision as in ``multifreq_dpred``.
    '''

    dev = resolve_device(device)
    cdtype = _complex_dtype(q)
    rdtype = torch.empty((), dtype=cdtype).real.dtype
    q = _field(q, dev, cdtype)
    c = _field(c, dev, cdtype)
    rho = _field(rho, dev, rdtype)
    if cmin is None:
        cmin = float(torch.min(c.real.detach()))
    rx = _receivers(R, dev, cdtype)
    out = []
    for freq, q_f in zip(_freq_list(freqs), q):
        ci = viscous_velocity(c, freq, Q, freqBase)
        u = ky_summed_fields(ci, rho, freq, q_f[:, None], nky, cmin,
                             config, **plane_kwargs)
        out.append(extract(u, *rx))
    return torch.stack(out)


def multifreq_dpred_chunked(c, rho, freqs, q, R, config=SolverConfig(),
                            premul=None, Q=np.inf, freqBase=0.0,
                            chunk=16, device=DEFAULT_DEVICE, stats=None,
                            **plane_kwargs):
    '''
    Host-driven production forward modelling: per frequency one prepared
    operator (forward only) and restarted chunked solves
    (``make_chunked_solver``, ``chunk`` iterations a restart) for the
    whole source batch; it reuses each frequency's prepared operator
    across all sources like the reference reuses one LU factorization
    (zephyr/backend/distributors.py:127-173). ``c`` may be complex. The
    working precision is that of ``q`` (complex128, else complex64).

    Not differentiable (use ``multifreq_dpred`` for the autodiff path).
    An optional ``stats`` dict receives each frequency's iteration count
    and worst true relres. Returns the (nfreq, nsrc, nrec) data cube as
    numpy complex128.
    '''

    dev = resolve_device(device)
    nfreq, nsrc = q.shape[:2]
    c = np.asarray(c)
    config = resolve_panels(config, c)
    cdtype = _complex_dtype(q)
    rdtype = torch.empty((), dtype=cdtype).real.dtype
    c_t = _field(c.astype(np.complex128), dev, cdtype)
    rho_t = _field(rho, dev, rdtype)
    rx = _receivers(R, dev, cdtype)
    pm = None if premul is None else np.asarray(premul).ravel()
    solver = make_chunked_solver(config, chunk=chunk)
    out = np.zeros((nfreq, nsrc, rx[0].shape[0]), np.complex128)
    iters, relres = [], []
    for i, freq in enumerate(_freq_list(freqs)):
        ci = viscous_velocity(c_t, freq, Q, freqBase)
        planes = minizephyr_planes(ci, rho_t, freq,
                                   **plane_kwargs)[None, None]
        pplanes = minizephyr_planes(
            shifted_velocity(ci, config.shift), rho_t, freq,
            pml_cap=config.pml_cap, **plane_kwargs)[None, None]
        op = prepare_operator(planes, pplanes, config, with_transpose=False)
        b = _field(q[i], dev, cdtype)[:, None]      # (nsrc, 1, nz, nx)
        if pm is not None:
            b = b * complex(pm[i])
        x, it, rr = solver(op, b)
        del op
        out[i] = extract(torch.conj(x[:, 0]), *rx).cpu().numpy()
        iters.append(int(it))
        relres.append(float(rr))
    if stats is not None:
        stats.update(iters=iters, relres=relres)
    return out


def fwi_misfit(c, dobs, *args, **kwargs):
    '''
    0.5 || dpred - dobs ||^2 over ``multifreq_dpred`` (same arguments
    after ``dobs``): a real scalar tensor, differentiable w.r.t. c.
    '''

    d = multifreq_dpred(c, *args, **kwargs)
    dobs = _field(dobs, d.device, d.dtype)
    return 0.5 * torch.sum(torch.abs(d - dobs) ** 2)


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
                            grid_quantum=None, grid_min=128,
                            device=DEFAULT_DEVICE,
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
    plus the device of the solves (``device``, the card unless the
    caller passes 'cpu') and an optional ``stats``
    dict that receives the per-frequency grids, the (forward, adjoint)
    iteration counts of every source chunk and the seconds of each phase
    (spans timed by CUDA events on the card, the host clock on the CPU;
    ``stats`` turns tracing on for the call, ``utils.profiling``).

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

    dev = resolve_device(device)
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
    # the phases of ``stats``: spans timed by CUDA events on the card
    cuda = dev if timed and dev.type == 'cuda' else None

    def phase(key):
        return span('fwi.' + key, cuda=cuda)

    R_t = (None if adapted
           else torch.as_tensor(np.asarray(R), device=dev).to(cdtype))
    misfit = 0.0
    grad = torch.zeros((nz, nx), dtype=c_t.dtype, device=dev)
    pm = None if premul is None else np.asarray(premul).ravel()
    solve_iters = []
    with recording() if timed else contextlib.nullcontext() as rec:
        mark = len(rec.spans) if timed else 0
        for i, f in enumerate(np.asarray(freqs)):
            f = float(f)
            shape = plans[i]
            sf = fns[shape]
            with phase('prep'):
                op_f, op_t = sf['prep'](f)
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
                with phase('fwd_solve'):
                    x, it_f, _ = sf['solver'](op_f, b)
                dobs_f = torch.as_tensor(np.ascontiguousarray(
                    np.asarray(dobs)[i, s0:s1]), device=dev).to(cdtype)
                with phase('residual'):
                    if adapted:
                        t, mis = sf['residual_st'](x, rcols, rvals, dobs_f)
                    else:
                        t, mis = sf['residual'](x, R_t, dobs_f)
                    misfit += float(mis)
                with phase('adj_solve'):
                    w, it_a, _ = sf['solver'](op_t, t)
                with phase('grad_term'):
                    grad += sf['grad'](f, w, x)
                solve_iters.append((i, s0, int(it_f), int(it_a)))
    if timed:
        stats.update(shapes=plans, iters=solve_iters,
                     seconds=rec.seconds('fwi.', since=mark))
    return misfit, grad.cpu().numpy()


def make_sharded_fwi_step(mesh, rho, freqs, q, R, dobs, lr=1.0,
                          config=SolverConfig(), premul=None,
                          Q=np.inf, freqBase=0.0, eurus_params=None,
                          **plane_kwargs):
    '''
    Build an FWI gradient-descent step over a ('freq', 'src') or
    ('host', 'freq', 'src') mesh:
        step(c) -> (c_next, misfit, grad)

    The source fields q (nfreq, nsrc, nz, nx), the observed data dobs
    (nfreq, nsrc, nrec) and the premultipliers split over the mesh by
    ``freq_src_sharding`` (frequencies over 'freq', and over 'host' first
    on a multi-process mesh; sources over 'src'); the model, density and
    receiver matrix R (nrec, nz*nx) are replicated. Each mesh coordinate
    of this process runs the differentiable ``fwi_misfit`` (autograd
    through ``solve_batched``) on its block, on its device; the partial
    misfits and gradients are summed in a fixed order on the model's
    device and over 'host' by ``dist.all_reduce`` (``Mesh.psum``),
    matching the reference's gradient accumulation over frequencies
    (problem.py:152,162). The working precision is that of ``q``; c_next,
    misfit and grad are tensors on the model's device (the mesh's first
    device for a numpy model).
    '''

    from .mesh import Sharding, freq_src_sharding, replicated

    fs = freq_src_sharding(mesh)
    by_freq = Sharding(mesh, fs.spec[:1])
    rep = replicated(mesh)
    cdtype = _complex_dtype(q)
    rdtype = torch.empty((), dtype=cdtype).real.dtype
    freqs = np.asarray(_freq_list(freqs))
    if isinstance(R, torch.Tensor):
        R = R.detach().cpu().numpy()
    blocks = {}
    for co in mesh.coords():
        dev = resolve_device(mesh.device(co))
        blocks[co] = dict(
            dev=dev, q=fs.shard(q, co, cdtype),
            dobs=fs.shard(dobs, co, cdtype),
            freqs=freqs[by_freq.block(freqs.shape, co)],
            premul=(None if premul is None
                    else by_freq.shard(np.asarray(premul), co, cdtype)),
            rho=rep.shard(np.real(np.asarray(rho)), co, rdtype))

    def step(c):
        if isinstance(c, torch.Tensor):
            dev0 = c.device
        else:
            dev0 = mesh.device(mesh.coords()[0])
            c = torch.as_tensor(np.asarray(c))
        c = c.detach().to(device=dev0, dtype=rdtype)
        misfits, grads = {}, {}
        for co, blk in blocks.items():
            cl = c.to(blk['dev']).detach().requires_grad_(True)
            m = fwi_misfit(cl, blk['dobs'], blk['rho'], blk['freqs'],
                           blk['q'], R, config=config, premul=blk['premul'],
                           Q=Q, freqBase=freqBase, eurus_params=eurus_params,
                           device=blk['dev'], **plane_kwargs)
            g, = torch.autograd.grad(m, cl)
            misfits[co], grads[co] = m.detach(), g
        misfit = mesh.psum(misfits).to(dev0)
        grad = mesh.psum(grads).to(dev0)
        return c - lr * grad, misfit, grad

    return step
