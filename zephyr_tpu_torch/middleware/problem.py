'''
Inverse-problem layer for zephyr_tpu_torch: the Helmholtz Problem
classes, the port of ``zephyr_tpu.middleware.problem``.

Reference parity: zephyr/middleware/problem.py (HelmBaseProblem and its
concrete bindings). The public surface is the JAX package's:
``updateModel`` with EPS-guarded cache clearing, the lazy ``system``
distributor, ``fields``/``lazyFields``, ``Jvec``/``Jtvec`` and the fused
``misfit_and_gradient``.

``Jvec``/``Jtvec`` are the exact JVP/VJP of the discrete forward map
c (nz, nx) real -> data (nrec, nsrc, nfreq) complex, a torch function
built by ``_dpred_fn``: ``Jvec`` runs it under ``torch.autograd.
forward_ad`` (the solve's forward-mode rule: one more solve with the same
operator a frequency), ``Jtvec`` and ``misfit_and_gradient`` under
reverse-mode autograd (one transpose solve a frequency). Each frequency's
operator is prepared from detached planes; the planes that carry the
derivatives enter only as the solve's differentiable input. The source
and receiver matrices are built on the device from the survey's sparse
matrices; the receiver products are gathers and sums, so no matmul (and
no TF32 switch) enters them.

Everything runs on the card unless the ``device`` config key says 'cpu';
``dtype`` defaults to complex64 on the card and complex128 on the CPU.
The 2.5D problems are not ported yet and raise.
'''

import hashlib

import numpy as np
import scipy.sparse as sp
import torch
import torch.autograd.forward_ad as fwAD

from ..core.attrmap import BaseSCCache
from ..core.device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..backend import (BaseModelDependent, MultiFreq, ViscoMultiFreq,
                       ViscoMultiGridMultiFreq)
from ..backend.minizephyr import MiniZephyr, MiniZephyrHD
from ..backend.eurus import Eurus, EurusHD
from ..backend.interpolation import resample_field
from ..ops.minizephyr_coeff import minizephyr_planes
from ..ops.eurus_coeff import eurus_planes
from ..solver.helmholtz import (prepare_operator, resolve_panels,
                                resolve_solver_config, solve_batched,
                                shifted_velocity)
from .survey import (HelmBaseSurvey, HelmMultiGridSurvey, Helm2DSurvey,
                     Helm25DSurvey)
from .fields import HelmFields
from .mesh import TensorMesh2D

EPS = 1e-15

#: the ROADMAP item that ports the 2.5D problems
PROBLEMS_25D = ('2.5D problems (MiniZephyr25D and the ky summation) are '
                'not ported yet: ROADMAP Queue 1, item 13')


def _source_batch(q, premul, nblock, nz, nx, device, dtype):
    '''
    The right-hand-side batch (nsrc, nblock, nz, nx) premul * q^T of a
    (nz * nx, nsrc) source matrix (scipy sparse or dense), built on the
    device from its nonzeros; the second block of a TTI pair is zero.
    '''

    q = sp.coo_matrix(q)
    q.sum_duplicates()
    nrow, nsrc = q.shape
    b = torch.zeros((nsrc, nblock * nrow), dtype=dtype, device=device)
    if q.nnz:
        vals = premul * np.asarray(q.data, dtype=np.complex128)
        b[torch.as_tensor(q.col, device=device),
          torch.as_tensor(q.row, device=device)] = torch.as_tensor(
              vals, device=device).to(dtype)
    return b.reshape((nsrc, nblock, nz, nx))


class _Receivers(object):
    '''
    Receiver matrices (nrec, nrow) as padded gathers on the device: for
    each receiver its K nonzero columns and weights (zero weight in the
    padding). One matrix serves every source (fixed mode) or each source
    has its own (relative mode).
    '''

    def __init__(self, mats, device, dtype):
        csrs = [sp.csr_matrix(m) for m in mats]
        for c in csrs:
            c.sum_duplicates()
        nrec = csrs[0].shape[0]
        K = max(1, max(int(np.diff(c.indptr).max(initial=0))
                       for c in csrs))
        idx = np.zeros((len(csrs), nrec, K), np.int64)
        w = np.zeros((len(csrs), nrec, K), np.complex128)
        for s, c in enumerate(csrs):
            counts = np.diff(c.indptr)
            rows = np.repeat(np.arange(nrec), counts)
            pos = np.arange(c.nnz) - c.indptr[rows]
            idx[s, rows, pos] = c.indices
            w[s, rows, pos] = c.data
        self.nrec, self.K = nrec, K
        self.idx = torch.as_tensor(idx.reshape(len(csrs), -1),
                                   device=device)
        self.w = torch.as_tensor(w, device=device).to(dtype)

    def project(self, u):
        'Data (nrec, nsrc) of wavefields u (nsrc, nrow): R u per source.'
        nsrc = u.shape[0]
        idx = self.idx.expand(nsrc, -1) if self.idx.shape[0] == 1 \
            else self.idx
        g = torch.gather(u, 1, idx).reshape(nsrc, self.nrec, self.K)
        return torch.sum(g * self.w, dim=-1).T


class HelmBaseProblem(BaseModelDependent, BaseSCCache):
    'Base frequency-domain problem (parity: problem.py:17-201).'

    initMap = {
    #   Argument            Required    Rename as ...   Store as type
        'SystemWrapper':    (True,      None,           None),
    }

    surveyPair = HelmBaseSurvey
    cacheItems = ['_system', '_dpred_grad_fn']

    def __init__(self, systemConfig, *args, **kwargs):

        BaseSCCache.__init__(self, systemConfig, *args, **kwargs)
        self.mesh = TensorMesh2D(self.nx, self.nz, self.dx, self.dz)
        self.survey = None

    # -- pairing -------------------------------------------------------------

    def pair(self, s):
        self.survey = s
        s.prob = self

    @property
    def ispaired(self):
        return self.survey is not None

    # -- device --------------------------------------------------------------

    @property
    def device(self):
        'The torch device of the solves (the ``device`` key; default cuda).'
        return resolve_device(self.systemConfig.get('device',
                                                    DEFAULT_DEVICE))

    @property
    def dtype(self):
        'complex128 on the CPU and complex64 on CUDA unless configured.'
        dt = self.systemConfig.get('dtype', None)
        return resolve_dtype(dt, self.device if dt is None else None)

    # -- model management ----------------------------------------------------

    def updateModel(self, m, loneKey='c'):
        'EPS-guarded model update with cache clearing (problem.py:51-66).'

        if m is None:
            return
        if isinstance(m, dict):
            self.systemConfig.update(m)
            self.clearCache()
        elif isinstance(m, (np.ndarray, np.inexact, complex, float)):
            m = np.asarray(m)
            current = np.asarray(
                self.systemConfig.get(loneKey, 0.)).ravel()
            if current.size != m.size or \
                    not np.linalg.norm(m.ravel() - current) < EPS:
                self.systemConfig[loneKey] = m
                self.clearCache()
        else:
            raise TypeError(
                "%s doesn't know how to update with model of type %s"
                % (self.__class__.__name__, type(m)))

    @property
    def system(self):
        if getattr(self, '_system', None) is None:
            self._system = self.SystemWrapper(self.systemConfig)
        return self._system

    # -- reference-parity scalings (kept for API completeness) ---------------

    def scaledTerms(self, ifreq):
        omega = 2 * np.pi * self.survey.freqs[ifreq]
        c = self.system.subProblems[ifreq].c
        return omega, c

    def gradientScaler(self, ifreq):
        omega, c = self.scaledTerms(ifreq)
        return self.survey.postProcessors[ifreq](
            -(omega ** 2 / c ** 3).ravel())

    def sensScaler(self, ifreq):
        omega, c = self.scaledTerms(ifreq)
        return self.survey.postProcessors[ifreq](
            -(c ** 3 / omega ** 2).ravel())

    # -- fields --------------------------------------------------------------

    def lazyFields(self, m=None):
        if not self.ispaired:
            raise RuntimeError(
                '%s instance is not paired to a survey'
                % (self.__class__.__name__,))
        self.updateModel(m)
        qf = self.survey.getSources()
        uF = self.system * qf
        if not np.iterable(uF):
            uF = [uF]
        return uF

    def fields(self, m=None):
        uF = self.lazyFields(m)
        uF = (pp(np.asarray(uFi))
              for uFi, pp in zip(uF, self.survey.postProcessors))
        fields = HelmFields(self.mesh, self.survey)
        for ifreq, uFsub in enumerate(uF):
            fields[:, 'u', ifreq] = uFsub
        return fields

    # -- exact sensitivity machinery ----------------------------------------

    @property
    def baseVelocity(self):
        'The (real) base velocity model the sensitivities act on.'
        c = np.asarray(self.systemConfig['c'])
        if c.size == 1:
            c = float(np.real(c)) * np.ones((self.nz, self.nx))
        return np.real(c).reshape((self.nz, self.nx))

    def _discInfo(self):
        'Resolve the discretization family and per-frequency premul.'
        Disc = self.systemConfig.get('Disc', MiniZephyr)
        is_eurus = issubclass(Disc, Eurus)
        is_hd = issubclass(Disc, (MiniZephyrHD, EurusHD))
        is_25d = (int(self.systemConfig.get('nky', 1) or 1) > 1
                  and not is_eurus)
        return Disc, is_eurus, is_hd, is_25d

    def _modelTransform(self, c, freq, Q=None):
        '''
        The per-frequency complex-velocity transform implemented by the
        SystemWrapper (dispersion for the Visco wrappers), as a torch
        function of the real base velocity tensor c (distributors.py:
        326-359 semantics). ``Q`` overrides the configured attenuation
        model (used by the MultiGrid path, which resamples an array-valued
        Q to each frequency's grid).
        '''

        if not issubclass(self.SystemWrapper, ViscoMultiFreq):
            return c + 0j
        if Q is None:
            Q = self.systemConfig.get('Q', np.inf)
        freqBase = self.systemConfig.get('freqBase', 0.)
        Q = np.asarray(Q, dtype=np.float64)
        disperse = bool(np.any(Q != np.inf)) and freqBase > 0
        Q = torch.as_tensor(Q, dtype=c.dtype, device=c.device)
        if Q.numel() > 1:
            Q = Q.reshape(c.shape)
        if disperse:
            c = (1. + np.log(freq / freqBase) / (np.pi * Q)) * c
        # cR + 0.5i cR / Q, with the real quotient formed first (a
        # complex quotient by an infinite Q is not finite in torch)
        return torch.complex(c, 0.5 * c / Q)

    def _planeKwargs(self):
        sc = self.systemConfig
        kwargs = dict(
            dx=float(sc.get('dx', 1.)), dz=float(sc.get('dz', 1.)),
            nPML=int(sc.get('nPML', 10)),
            tau=float(sc.get('tau', np.inf)),
            freeSurf=tuple(bool(f) for f in sc.get(
                'freeSurf', (False, False, False, False))))
        return kwargs

    @property
    def solverConfig(self):
        '''
        Solver options with the precision-aware tol default and the
        auto-panel default resolved on the host from this problem's
        velocity model (scalar systems; Eurus block systems ignore the
        panel config).
        '''
        cfg = resolve_solver_config(self.systemConfig.get('solverOpts', {}),
                                    self.dtype)
        c = self.systemConfig.get('c', None)
        if c is not None and np.asarray(c).size > 1:
            nz = int(self.systemConfig['nz'])
            nx = int(self.systemConfig['nx'])
            cfg = resolve_panels(cfg, np.asarray(c).reshape(nz, nx))
        return cfg

    def _surveyFingerprint(self):
        '''
        Value-based fingerprint of everything the cached forward map
        closes over from the survey (geometry, spectra, grid scales):
        a survey change after the first Jvec/Jtvec must rebuild the
        closure. Model changes are handled by updateModel/cacheItems.
        '''

        s = self.survey
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(
            np.asarray(s.sLocs, np.float64)).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(s.rLocs, np.float64)).tobytes())
        h.update(np.asarray(s.freqs, np.float64).tobytes())
        h.update(s.mode.encode())
        h.update(np.ascontiguousarray(np.asarray(s.ssTerms)).tobytes())
        h.update(np.ascontiguousarray(np.asarray(s.srTerms)).tobytes())
        h.update(np.ascontiguousarray(np.asarray(s.tsTerms)).tobytes())
        if isinstance(s, HelmMultiGridSurvey):
            h.update(np.asarray(s.mgHelper.scales).tobytes())
        return (id(s), h.hexdigest())

    def _dpred_fn(self):
        '''
        Build (and cache) the differentiable forward map
        c (nz, nx) real tensor -> data cube (nrec, nsrc, nfreq) complex
        tensor, on this problem's device.

        For MultiGrid surveys (per-frequency computation grids,
        reference survey.py:209-330 + distributors.py:384-435) each
        frequency's system is built on its own scaled grid: the model is
        resampled differentiably (resample_field) inside the map, and the
        survey's scaled-grid source/receiver matrices are used as they
        are, so Jvec/Jtvec return fine-grid model sensitivities with the
        chain rule through the resampler.
        '''

        key = self._surveyFingerprint()
        if getattr(self, '_dpred_grad_fn', None) is not None \
                and getattr(self, '_dpred_key', None) == key:
            return self._dpred_grad_fn

        survey = self.survey
        cfg = self.solverConfig
        dev, cdtype = self.device, self.dtype
        rdtype = torch.empty((), dtype=cdtype).real.dtype
        Disc, is_eurus, is_hd, is_25d = self._discInfo()
        if is_25d:
            raise NotImplementedError(PROBLEMS_25D)
        is_mg = isinstance(survey, HelmMultiGridSurvey)
        if is_mg and is_eurus:
            raise NotImplementedError(
                'per-frequency computation grids are bound to the '
                'scalar 2D (visco) problem, as in the reference '
                '(zephyr/middleware/problem.py:224-238)')

        def real_field(v):
            return torch.as_tensor(np.real(np.asarray(v, np.complex128)),
                                   device=dev).to(rdtype)

        kwargs = self._planeKwargs()
        if is_eurus:
            sc = self.systemConfig
            kwargs['cPML'] = float(sc.get('cPML', 1e3))
            zeros = np.zeros((self.nz, self.nx))
            for k in ('theta', 'eps', 'delta'):
                kwargs[k] = real_field(sc.get(k, zeros)).reshape(
                    (self.nz, self.nx))
        rho = real_field(self.systemConfig.get(
            'rho', 310. * self.baseVelocity ** 0.25))
        if rho.numel() == 1:
            rho = rho * torch.ones((self.nz, self.nx), dtype=rdtype,
                                   device=dev)
        rho = rho.reshape((self.nz, self.nx))

        freqs = [float(f) for f in survey.freqs]
        nz, nx = self.nz, self.nx
        B = 2 if is_eurus else 1

        # per-frequency grid geometry and (static) resampled aux fields
        if is_mg:
            geoms, Qs, rhos = [], [], []
            Q_cfg = np.asarray(self.systemConfig.get('Q', np.inf))
            for i in range(len(freqs)):
                sc_i = survey.scScales[survey.buildSC(i)]
                snz, snx = int(sc_i['nz']), int(sc_i['nx'])
                geoms.append((snz, snx,
                              dict(kwargs, dx=float(sc_i['dx']),
                                   dz=float(sc_i['dz']))))
                if Q_cfg.size > 1:
                    ds = survey.mgHelper.downScalers[i]
                    Qs.append(np.real(np.asarray(
                        ds * Q_cfg.ravel())).reshape((snz, snx)))
                else:
                    Qs.append(None)
                rhos.append(resample_field(rho, (snz, snx))
                            if (snz, snx) != (nz, nx) else rho)
        else:
            geoms = [(nz, nx, kwargs)] * len(freqs)
            Qs = [None] * len(freqs)
            rhos = [rho] * len(freqs)

        # per-frequency right-hand sides (spectrum and premul applied, on
        # each frequency's own grid for MultiGrid surveys) and receivers
        def _rv(isrc, ifreq):
            return (survey.rVec(isrc, ifreq) if is_mg
                    else survey.rVec(isrc))

        bs, rxs = [], []
        for i, (q, f) in enumerate(zip(survey.getSources(), freqs)):
            premul = np.sqrt(2j * np.pi * f) if is_hd else \
                complex(self.systemConfig.get('premul', 1.))
            nz_i, nx_i = geoms[i][:2]
            bs.append(_source_batch(q, premul, B, nz_i, nx_i, dev, cdtype))
            mats = ([_rv(0, i)] if survey.mode == 'fixed'
                    else [_rv(s, i) for s in range(survey.nsrc)])
            rxs.append(_Receivers(mats, dev, cdtype))
        plane_fn = eurus_planes if is_eurus else (
            lambda *a, **k: minizephyr_planes(*a, **k)[None, None])

        def forward(c_real):
            c_real = c_real.reshape((nz, nx))
            needs_grad = torch.is_grad_enabled() and c_real.requires_grad
            panels = []
            for i, f in enumerate(freqs):
                nz_i, nx_i, kw = geoms[i]
                c_i = (resample_field(c_real, (nz_i, nx_i))
                       if (nz_i, nx_i) != (nz, nx) else c_real)
                ci = self._modelTransform(c_i, f, Q=Qs[i]).to(cdtype)
                planes = plane_fn(ci, rhos[i], freq=f, **kw)
                pplanes = plane_fn(
                    shifted_velocity(ci.detach(), cfg.shift), rhos[i],
                    freq=f, pml_cap=cfg.pml_cap, **kw)
                op = prepare_operator(
                    planes.detach(), pplanes, cfg,
                    with_transpose=needs_grad and not is_eurus)
                x = solve_batched(op, bs[i], cfg, planes=planes)
                u = torch.conj(x[:, 0].reshape((x.shape[0], nz_i * nx_i)))
                panels.append(rxs[i].project(u))
            return torch.stack(panels, dim=-1)  # (nrec, nsrc, nfreq)

        self._dpred_grad_fn = forward
        self._dpred_key = key
        return forward

    def _baseTensor(self):
        'The base velocity as a real tensor of the solve\'s precision.'
        rdtype = torch.empty((), dtype=self.dtype).real.dtype
        return torch.as_tensor(self.baseVelocity, device=self.device).to(
            rdtype)

    def Jvec(self, m=None, v=None, u=None):
        '''
        Sensitivity (Jacobian) times a model vector: the exact JVP of the
        forward map at the current model. Returns the raveled complex
        data-perturbation cube (nrec * nsrc * nfreq,).
        '''

        if not self.ispaired:
            raise RuntimeError('%s instance is not paired to a survey'
                               % (self.__class__.__name__,))
        if v is None:
            raise ValueError('Jvec requires a perturbation vector')

        self.updateModel(m)
        forward = self._dpred_fn()
        c0 = self._baseTensor()
        tangent = torch.as_tensor(np.real(v).reshape(c0.shape),
                                  device=c0.device).to(c0.dtype)
        with fwAD.dual_level():
            d = forward(fwAD.make_dual(c0, tangent))
            dpert = fwAD.unpack_dual(d).tangent
        return dpert.cpu().numpy().ravel()

    def Jtvec(self, m=None, v=None, u=None):
        '''
        Adjoint sensitivity: the exact VJP of the forward map, returning
        the real model-space gradient contribution for a complex data
        vector v. Satisfies Re<w, Jvec(v)> == <Jtvec(w), v> (to solver
        tolerance). Torch's gradient of a real -> complex map for the
        output gradient w is Re(J^H w), the JAX package's real part of
        vjp(conj(w)).
        '''

        if not self.ispaired:
            raise RuntimeError('%s instance is not paired to a survey'
                               % (self.__class__.__name__,))
        if v is None:
            raise ValueError('Jtvec requires a residual vector')

        self.updateModel(m)
        forward = self._dpred_fn()
        c0 = self._baseTensor().requires_grad_(True)
        w = torch.as_tensor(np.asarray(v).reshape(
            (self.survey.nrec, self.survey.nsrc, self.survey.nfreq)),
            device=c0.device).to(self.dtype)
        g, = torch.autograd.grad(forward(c0), c0, grad_outputs=w)
        return g.cpu().numpy().ravel()

    def misfit_and_gradient(self, m, dobs):
        '''
        0.5 || dpred(m) - dobs ||^2 and its exact gradient w.r.t. the
        (real) velocity model — the fused FWI objective used by the
        inversion loop (replaces SimPEG DataMisfit.evalDeriv).
        '''

        self.updateModel(m)
        forward = self._dpred_fn()
        dobs = torch.as_tensor(np.asarray(dobs).reshape(
            (self.survey.nrec, self.survey.nsrc, self.survey.nfreq)),
            device=self.device).to(self.dtype)
        c0 = self._baseTensor().requires_grad_(True)
        val = 0.5 * torch.sum(torch.abs(forward(c0) - dobs) ** 2)
        grad, = torch.autograd.grad(val, c0)
        return float(val.detach()), grad.cpu().numpy().ravel()

    @property
    def factors(self):
        return self.system.factors

    @factors.deleter
    def factors(self):
        del self.system.factors


class Helm2DProblem(HelmBaseProblem):

    initMap = {
    #   Argument            Required    Rename as ...   Store as type
        'SystemWrapper':    (False,     None,           None),
    }

    surveyPair = Helm2DSurvey
    SystemWrapper = MultiFreq


class Helm2DViscoProblem(Helm2DProblem):

    SystemWrapper = ViscoMultiFreq


class Helm2DViscoMultiGridProblem(Helm2DProblem):

    SystemWrapper = ViscoMultiGridMultiFreq


class Helm25DProblem(HelmBaseProblem):
    'Declared for the JAX package\'s names; raises until 2.5D is ported.'

    initMap = {
    #   Argument            Required    Rename as ...   Store as type
        'SystemWrapper':    (False,     None,           None),
    }

    surveyPair = Helm25DSurvey
    SystemWrapper = MultiFreq

    def __init__(self, systemConfig, *args, **kwargs):
        raise NotImplementedError(PROBLEMS_25D)


class Helm25DViscoProblem(Helm25DProblem):

    SystemWrapper = ViscoMultiFreq
