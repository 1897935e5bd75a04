'''
Acquisition geometry and data projection for zephyr_tpu_torch: the port
of ``zephyr_tpu.middleware.survey`` (host-side numpy/scipy, on the port's
backend).

Reference parity: zephyr/middleware/survey.py — geometry dict with
``src``, ``rec``, ``mode`` in {fixed, relative}, per-source/receiver
complex weights, per-frequency source spectra, Kaiser-interpolated source
and receiver vectors, and the (nrec, nsrc, nfreq) complex data cube.

The SimPEG BaseSurvey machinery is provided natively: ``pair()``-ing with
a problem installs the back-reference that ``dpred`` uses. ``dpred``
solves through the problem's distributor (on the card unless the
``device`` config key says 'cpu') and projects the wavefields on the
host; the problem's differentiable forward map builds the same source
and receiver matrices on the device.
'''

import numpy as np
import scipy.sparse as sp

from ..core.attrmap import BaseSCCache
from ..backend import SparseKaiserSource, MultiGridHelper


class HelmSrc(object):
    'A source: location plus its receiver list (parity: survey.py:12-18).'

    def __init__(self, rxList, loc):
        self.rxList = rxList
        self.loc = loc

    @property
    def nD(self):
        return sum(rx.locs.shape[0] for rx in self.rxList)


class HelmRx(object):
    'A receiver group (parity: survey.py:20-24).'

    def __init__(self, locs, rxType=None):
        self.locs = locs
        self.rxType = rxType


class HelmBaseSurvey(BaseSCCache):
    'Base survey (parity: survey.py:27-206).'

    srcPair = HelmSrc

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'geom':         (True,      None,           dict),
        'freqs':        (True,      None,           tuple),
        'sterms':       (False,     '_sterms',      np.complex128),
    }

    def __init__(self, systemConfig, *args, **kwargs):

        super().__init__(systemConfig, *args, **kwargs)
        self.prob = None

        if self.mode == 'fixed':
            rxList = HelmRx(self.rLocs)
            rxListGen = lambda sLoc: [rxList]
        elif self.mode == 'relative':
            rxListGen = lambda sLoc: [HelmRx(sLoc + self.rLocs)]

        self.srcList = [HelmSrc(rxListGen(loc), loc) for loc in self.sLocs]

    # -- pairing ------------------------------------------------------------

    def pair(self, p):
        'Bind this survey to a problem (SimPEG pair() semantics).'
        self.prob = p
        p.survey = self

    @property
    def ispaired(self):
        return self.prob is not None

    # -- geometry -----------------------------------------------------------

    @property
    def nfreq(self):
        return len(self.freqs)

    @property
    def geom(self):
        return self._geom

    @geom.setter
    def geom(self, value):
        if value.get('mode', 'fixed') not in {'fixed', 'relative'}:
            raise ValueError(
                "%s objects only work with 'fixed' or 'relative' receiver "
                'arrays' % (self.__class__.__name__,))
        self._geom = value

    @property
    def mode(self):
        return self.geom.get('mode', 'fixed')

    @property
    def sLocs(self):
        return self.geom.get('src')

    @property
    def rLocs(self):
        return self.geom.get('rec')

    @property
    def ssTerms(self):
        return self.geom.get('sterms',
                             np.ones((self.nsrc,), dtype=np.complex128))

    @property
    def srTerms(self):
        return self.geom.get('rterms',
                             np.ones((self.nrec,), dtype=np.complex128))

    @property
    def tsTerms(self):
        return getattr(self, '_sterms',
                       np.ones(self.nfreq, dtype=np.complex128))

    @property
    def nsrc(self):
        try:
            return self.sLocs.shape[0]
        except AttributeError:
            return 0

    nSrc = nsrc  # SimPEG-style alias

    @property
    def nrec(self):
        try:
            return self.rLocs.shape[0]
        except AttributeError:
            return 0

    @property
    def nD(self):
        'Number of data'
        return self.nsrc * self.nrec * self.nfreq

    @property
    def vnD(self):
        return self.nfreq * np.array([src.nD for src in self.srcList])

    # -- source / receiver vectors ------------------------------------------

    @property
    def RHSGenerator(self):
        if not hasattr(self, '_RHSGenerator'):
            self._RHSGenerator = self.geom.get('GeneratorClass',
                                               SparseKaiserSource)
        return self._RHSGenerator

    def sVecs(self):
        if not hasattr(self, '_sVecs'):
            self._sVecs = self.RHSGenerator(self.systemConfig)(self.sLocs) \
                * sp.diags((self.ssTerms,), (0,))
        return self._sVecs

    def rVec(self, isrc):
        if self.mode == 'fixed':
            if not hasattr(self, '_rVecs'):
                self._rVecs = (self.RHSGenerator(self.systemConfig)
                               (self.rLocs)
                               * sp.diags((self.srTerms,), (0,))).T
            return self._rVecs

        if not hasattr(self, '_rVecs'):
            self._rVecs = {}
        if isrc not in self._rVecs:
            self._rVecs[isrc] = (self.RHSGenerator(self.systemConfig)
                                 (self.rLocs + self.sLocs[isrc])
                                 * sp.diags((self.srTerms,), (0,))).T
        return self._rVecs[isrc]

    def rVecs(self, ifreq):
        return (self.rVec(i) for i in range(self.nsrc))

    def getSources(self):
        'Per-frequency source matrices, spectrum-conjugated (parity).'
        qs = self.sVecs()
        ts = self.tsTerms
        if isinstance(ts, (list, np.ndarray)):
            ts = np.asarray(ts)
            if ts.ndim < 2:
                qs = [qs * sterm.conjugate() for sterm in ts]
            else:
                qs = [qs * sp.diags((sterm.conjugate(),), (0,))
                      for sterm in ts]
        return qs

    def getResidualSources(self, resid):
        'Adjoint right-hand sides rVec^T resid per frequency (parity).'
        qb = [
            sp.hstack(
                [sp.csc_matrix(self.rVec(isrc)).T
                 * sp.csc_matrix(resid[:, isrc, ifreq].reshape(
                     (self.nrec, 1)))
                 for isrc in range(self.nsrc)]
            )
            for ifreq in range(self.nfreq)
        ]
        return qb

    # -- data projection -----------------------------------------------------

    def projectFields(self, u):
        data = np.empty((self.nrec, self.nsrc, self.nfreq),
                        dtype=np.complex128)
        for isrc, src in enumerate(self.srcList):
            data[:, isrc, :] = self.rVec(isrc) * u[src, 'u', :]
        return data

    def _lazyProjectFields(self, u):
        data = np.empty((self.nrec, self.nsrc, self.nfreq),
                        dtype=np.complex128)
        for ifreq, uFreq in enumerate(u):
            uFreq = np.asarray(uFreq)
            for isrc, rVec in enumerate(self.rVecs(ifreq)):
                data[:, isrc, ifreq] = rVec * uFreq[:, isrc]
        return data

    def dpred(self, m=None, u=None):
        'Predicted data vector of length nrec * nsrc * nfreq.'
        if not self.ispaired:
            raise RuntimeError('Survey is not paired to a problem')
        if u is None:
            u = self.prob.lazyFields(m)
            return self._lazyProjectFields(u).ravel()
        return self.projectFields(u).ravel()

    def residual(self, m=None, u=None, dobs=None):
        'dpred - dobs (SimPEG convention), with dobs stored or passed.'
        if dobs is None:
            dobs = self.dobs
        return self.dpred(m, u) - np.asarray(dobs).ravel()

    @property
    def postProcessors(self):
        return [lambda x: x for _ in self.freqs]

    @property
    def preProcessors(self):
        return [lambda x: x for _ in self.freqs]


class HelmMultiGridSurvey(HelmBaseSurvey):
    '''
    Survey for per-frequency computation grids (parity:
    survey.py:209-330): source/receiver vectors are built on each
    frequency's scaled grid and wavefields are interpolated back.
    '''

    @property
    def mgHelper(self):
        if not hasattr(self, '_mgHelper'):
            self._mgHelper = MultiGridHelper(self.systemConfig)
        return self._mgHelper

    @property
    def postProcessors(self):
        return self.mgHelper.upScalers

    @property
    def preProcessors(self):
        return self.mgHelper.downScalers

    @property
    def scScales(self):
        if not hasattr(self, '_scScales'):
            self._scScales = {}
        return self._scScales

    def buildSC(self, ifreq):
        hs = hash(self.mgHelper.scales[ifreq])
        if hs not in self.scScales:
            sc = dict(self.systemConfig)
            sc.update(self.mgHelper.downScalers[ifreq].scaleUpdate)
            self.scScales[hs] = sc
        return hs

    def sVecs(self, ifreq=None):
        if ifreq is None:
            ifreq = 0
        sc = self.scScales[self.buildSC(ifreq)]
        return self.RHSGenerator(sc)(self.sLocs) \
            * sp.diags((self.ssTerms,), (0,))

    def rVec(self, isrc, ifreq=0):
        hs = self.buildSC(ifreq)
        if not hasattr(self, '_rVecs'):
            self._rVecs = {}
        if self.mode == 'fixed':
            if hs not in self._rVecs:
                sc = self.scScales[hs]
                self._rVecs[hs] = (self.RHSGenerator(sc)(self.rLocs)
                                   * sp.diags((self.srTerms,), (0,))).T
            return self._rVecs[hs]
        if hs not in self._rVecs:
            self._rVecs[hs] = {}
        if isrc not in self._rVecs[hs]:
            sc = self.scScales[hs]
            self._rVecs[hs][isrc] = (
                self.RHSGenerator(sc)(self.rLocs + self.sLocs[isrc])
                * sp.diags((self.srTerms,), (0,))).T
        return self._rVecs[hs][isrc]

    def rVecs(self, ifreq):
        return (self.rVec(i, ifreq) for i in range(self.nsrc))

    def getSources(self):
        ts = self.tsTerms
        if isinstance(ts, (list, np.ndarray)):
            ts = np.asarray(ts)
            qs = [self.sVecs(ifreq) * sp.diags((sterm.conjugate(),), (0,))
                  if np.iterable(sterm)
                  else sterm.conjugate() * self.sVecs(ifreq)
                  for ifreq, sterm in enumerate(ts)]
        else:
            qs = [np.conjugate(ts) * self.sVecs(ifreq)
                  for ifreq in range(self.nfreq)]
        return qs

    def getResidualSources(self, resid):
        return [
            sp.hstack(
                [sp.csc_matrix(self.rVec(isrc, ifreq)).T
                 * sp.csc_matrix(resid[:, isrc, ifreq].reshape(
                     (self.nrec, 1)))
                 for isrc in range(self.nsrc)]
            )
            for ifreq in range(self.nfreq)
        ]

    def projectFields(self, u):
        data = np.empty((self.nrec, self.nsrc, self.nfreq),
                        dtype=np.complex128)
        for isrc, src in enumerate(self.srcList):
            for ifreq in range(self.nfreq):
                data[:, isrc, ifreq] = self.rVec(isrc, ifreq) * (
                    self.mgHelper.downScalers[ifreq]
                    * u[src, 'u', ifreq]).ravel()
        return data

    def _lazyProjectFields(self, u):
        data = np.empty((self.nrec, self.nsrc, self.nfreq),
                        dtype=np.complex128)
        for ifreq, uFreq in enumerate(u):
            uFreq = np.asarray(uFreq)
            for isrc, rVec in enumerate(self.rVecs(ifreq)):
                data[:, isrc, ifreq] = rVec * uFreq[:, isrc]
        return data


class Helm2DSurvey(HelmBaseSurvey):
    pass


class Helm2DMultiGridSurvey(Helm2DSurvey, HelmMultiGridSurvey):
    pass


class Helm25DSurvey(HelmBaseSurvey):
    pass


class Helm25DMultiGridSurvey(Helm25DSurvey, HelmMultiGridSurvey):
    pass
