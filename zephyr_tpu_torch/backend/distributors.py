'''
Distribution wrappers for composite problems, the port of
``zephyr_tpu.backend.distributors``.

Reference parity: zephyr/backend/distributors.py. The wrappers keep the
reference's composite-problem semantics (spUpdates config overlays,
nested ``remDists`` chains, maskKeys) and run each subproblem's solve on
the card:

- ``MultiFreq`` and friends build one discretization per frequency; the
  parallel distributor fans the subproblems out over the CUDA devices of
  the process (subproblem i on ``cuda:i % n``), and on one card, or on
  the CPU, runs them one after the other as they are consumed.
- ``ViscoMultiFreq`` reproduces the causality-preserving Kolsky-Futterman
  dispersion model (distributors.py:326-359) including its guards.
- ``MultiGridMultiFreq`` / ``ViscoMultiGridMultiFreq`` give each frequency
  its own coarser grid via ``MultiGridHelper`` (distributors.py:384-573).
'''

import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch

from ..core.attrmap import SCFilter, BaseSCCache
from ..core.device import DEFAULT_DEVICE, resolve_device
from .base import BaseModelDependent
from .discretization import BaseDiscretization, DiscretizationWrapper
from .interpolation import SplineGridInterpolator


class BaseDist(DiscretizationWrapper):
    'Distributor base: Disc to wrap, workers, nestable remDists chain.'

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'Disc':         (True,      '_Disc',        None),
        'parallel':     (False,     '_parallel',    bool),
        'nWorkers':     (False,     '_nWorkers',    np.int64),
        'remDists':     (False,     None,           list),
    }

    maskKeys = {'remDists'}

    @property
    def remDists(self):
        'Remaining distributor objects in the call graph'
        return getattr(self, '_remDists', [])

    @remDists.setter
    def remDists(self, value):
        if value:
            value = list(value)
            self._DiscOverride = value.pop(0)
        self._remDists = value

    @property
    def Disc(self):
        'The discretization (or next distributor) to instantiate'
        return getattr(self, '_DiscOverride', self._Disc)

    @property
    def addFields(self):
        'Additional fields for the subProblem systemConfigs'
        return {'remDists': self.remDists}


class LazyFields(object):
    '''
    Lazily-evaluated wavefield sequence (parity: the reference
    distributors yield wavefields through a generator so that nothing is
    solved until a field is consumed and many-frequency jobs never hold
    every wavefield at once — zephyr/backend/distributors.py:161-173).

    Unlike a bare generator this is re-iterable and indexable: ``len``
    is free (the subproblem count), iteration and ``[i]`` run the i-th
    subproblem solve on demand, and nothing is cached — each consumption
    recomputes, exactly like re-running the reference's pool dispatch.
    '''

    def __init__(self, thunks):
        self._thunks = list(thunks)

    def __len__(self):
        return len(self._thunks)

    def __iter__(self):
        for thunk in self._thunks:
            yield thunk()

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [thunk() for thunk in self._thunks[index]]
        return self._thunks[index]()


class BaseMPDist(BaseDist):
    '''
    The parallel distributor. The reference dispatches subproblems to a
    multiprocessing.Pool (distributors.py:70-193): ``__mul__`` enqueues
    every subproblem at once (``pool.apply_async``) and the returned
    generator collects results lazily. Here, when ``parallel`` (the
    default) and the process sees more than one CUDA device, subproblem
    i lives on ``cuda:i % n`` and every solve is started at once, one
    host thread a subproblem; the returned LazyFields waits for each
    wavefield on consumption. On one card, on the CPU, or with
    ``parallel: False`` (SerialMultiFreq) nothing runs until consumed,
    like the reference's serial generator path (distributors.py:169-173).
    '''

    maskKeys = {'parallel'}

    @property
    def parallel(self):
        return getattr(self, '_parallel', True)

    @property
    def nWorkers(self):
        '''
        Number of cards the subproblems are spread over: the CUDA devices
        of the process, capped by the ``nWorkers`` config key; 1 on the
        CPU or when the ``device`` config key names one card.
        '''
        dev = resolve_device(self.systemConfig.get('device', DEFAULT_DEVICE))
        if dev.type != 'cuda' or dev.index is not None:
            return 1
        return max(1, min(int(getattr(self, '_nWorkers', 100)),
                          torch.cuda.device_count()))

    @property
    def _spConfigs(self):
        'Subproblem configs, each placed on its own card when fanned out.'
        configs = super()._spConfigs
        dev = resolve_device(self.systemConfig.get('device', DEFAULT_DEVICE))
        nw = self.nWorkers if self.parallel else 1
        if nw < 2 or dev.type != 'cuda':
            return configs
        return (dict(config, device='cuda:%d' % (i % nw))
                for i, config in enumerate(configs))

    def __mul__(self, rhs):
        '''
        Multiply the composite system by right-hand-side vector(s).

        Args:
            rhs: array, scipy sparse matrix, list (one entry per
                subproblem), or generator thereof

        Returns:
            LazyFields — a lazily-consumed, re-iterable, indexable
            sequence of wavefield arrays, one per subproblem (parity
            with the reference's generator protocol,
            zephyr/backend/distributors.py:161-173)
        '''

        subs = self.subProblems

        if isinstance(rhs, list):
            def getRHS(i):
                nrhs = rhs[i]
                if hasattr(nrhs, 'ndim') and nrhs.ndim < 2:
                    return nrhs.reshape((nrhs.size, 1))
                return nrhs
        elif isinstance(rhs, types.GeneratorType):
            items = list(rhs)

            def getRHS(i):
                return items[i]
        else:
            if hasattr(rhs, 'ndim') and rhs.ndim < 2:
                rhs = rhs.reshape((rhs.size, 1))

            def getRHS(i):
                return rhs

        def scaled(result):
            # nested distributors return lazy/list wavefield sequences;
            # apply the scale term through them without forcing
            # evaluation
            if isinstance(result, LazyFields):
                return LazyFields(
                    (lambda t=t: scaled(t())) for t in result._thunks)
            if isinstance(result, list):
                return [scaled(r) for r in result]
            return self.scaleTerm * result

        nw = self.nWorkers
        if self.parallel and nw > 1:
            # every plain solve started at once, one thread a subproblem
            # (apply_async parity); a wrapper or a custom __mul__ stays
            # lazy
            pool = ThreadPoolExecutor(max_workers=len(subs))
            thunks = []
            for i, sub in enumerate(subs):
                plain = (isinstance(sub, BaseDiscretization)
                         and type(sub).__mul__ is BaseDiscretization.__mul__)
                if not plain:
                    thunks.append(
                        lambda i=i, sub=sub: scaled(sub * getRHS(i)))
                    continue
                b = getRHS(i)
                if sp.issparse(b):
                    b = b.toarray()
                b = np.asarray(b)
                if b.ndim < 2:
                    b = b.reshape((b.size, 1))
                fut = pool.submit(sub._dispatch_rhs, b.astype(np.complex128))
                thunks.append(lambda sub=sub, fut=fut:
                              scaled(sub._gather_rhs(*fut.result())))
            pool.shutdown(wait=False)
            return LazyFields(thunks)

        return LazyFields(
            (lambda i=i, sub=sub: scaled(sub * getRHS(i)))
            for i, sub in enumerate(subs))


class BaseIPYDist(BaseDist):
    '''
    Multi-node distributor stub (parity: the reference's never-wired
    ipyparallel client, distributors.py:196-240).
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'profile':      (False,     '_profile',     str),
    }

    maskKeys = {'profile'}

    @property
    def profile(self):
        return getattr(self, '_profile', 'default')


class MultiFreq(BaseMPDist):
    '''
    Forward modelling over a series of frequencies
    (parity: distributors.py:243-265).
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'freqs':        (True,      None,           list),
    }

    maskKeys = {'freqs'}

    @property
    def spUpdates(self):
        vals = []
        for freq in self.freqs:
            spUpdate = {'freq': freq}
            spUpdate.update(self.addFields)
            vals.append(spUpdate)
        return vals


class ViscoMultiFreq(MultiFreq, BaseModelDependent):
    '''
    Multi-frequency modelling with causality-preserving velocity
    dispersion for finite Q (parity: distributors.py:268-359):
        cR = c * (1 + ln(f / freqBase) / (pi Q));  c = cR + 0.5i cR / Q
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'c':            (True,      None,           np.float64),
        'Q':            (False,     None,           np.float64),
        'freqBase':     (False,     None,           np.float64),
    }

    maskKeys = {'freqs', 'c', 'Q', 'freqBase'}

    @staticmethod
    def _any(criteria):
        if isinstance(criteria, (bool, np.bool_)):
            return bool(criteria)
        return bool(np.any(criteria))

    @property
    def freqBase(self):
        return getattr(self, '_freqBase', 0.)

    @freqBase.setter
    def freqBase(self, value):
        assert value >= 0
        self._freqBase = value

    @property
    def Q(self):
        if hasattr(self, '_Q'):
            Q = self._Q
            if not isinstance(Q, np.ndarray):
                return Q * np.ones((self.nz, self.nx), dtype=np.float64)
            return Q
        self._Q = np.inf
        return self._Q

    @Q.setter
    def Q(self, value):
        criteria = value <= 0
        try:
            assert not criteria
        except (TypeError, ValueError):
            assert not self._any(criteria)
        self._Q = value

    @property
    def disperseFreqs(self):
        return self._any(self.Q != np.inf) and (self.freqBase > 0)

    def _dispersedC(self, freq):
        fact = 1. + (np.log(freq / self.freqBase) / (np.pi * self.Q))
        assert not self._any(fact < 0.1)
        cR = fact * self.c
        return cR + (0.5j * cR / self.Q)  # NB: + b/c of FT convention

    @property
    def spUpdates(self):
        vals = []
        if self.disperseFreqs:
            for freq in self.freqs:
                spUpdate = {'freq': freq, 'c': self._dispersedC(freq)}
                spUpdate.update(self.addFields)
                vals.append(spUpdate)
        else:
            for freq in self.freqs:
                c = self.c.ravel() + (0.5j * self.c.ravel()
                                      / self.Q.ravel())
                spUpdate = {'freq': freq, 'c': c}
                spUpdate.update(self.addFields)
                vals.append(spUpdate)
        return vals


class SerialMultiFreq(MultiFreq):
    'Multi-frequency with parallel dispatch forced off (parity).'

    @property
    def parallel(self):
        return False

    @property
    def addFields(self):
        return {}


class MultiGridHelper(BaseModelDependent, BaseSCCache):
    '''
    Per-frequency grid-scale computation and cached up/down interpolator
    pairs (parity: distributors.py:515-573). Scale factor:
        median(cMin / (freq dx targetGPW), maxScale, minScale)
    '''

    initMap = {
    #   Argument            Required    Rename as ...   Store as type
        'cMin':             (True,      None,           np.complex128),
        'freqs':            (True,      None,           list),
        'targetGPW':        (True,      None,           np.float64),
        'GridInterpolator': (False,     '_gi',          None),
        'maxScale':         (False,     '_maxScale',    np.float64),
        'minScale':         (False,     '_minScale',    np.float64),
    }

    @property
    def maxScale(self):
        return getattr(self, '_maxScale', 10.)

    @property
    def minScale(self):
        return getattr(self, '_minScale', 1.)

    @property
    def GridInterpolator(self):
        return getattr(self, '_gi', SplineGridInterpolator)

    @property
    def GIFilter(self):
        if not hasattr(self, '_GIFilter'):
            self._GIFilter = SCFilter(self.GridInterpolator)
        return self._GIFilter

    @property
    def scales(self):
        'Downscaling factor per frequency'
        return [float(np.median((
            np.real(self.cMin / freq / self.dx / self.targetGPW),
            self.maxScale, self.minScale))) for freq in self.freqs]

    @property
    def downScalers(self):
        if not hasattr(self, '_downScalers'):
            self._downScalers = []
            for scale in self.scales:
                sc = dict(self.systemConfig)
                sc['scale'] = scale
                self._downScalers.append(
                    self.GridInterpolator(self.GIFilter(sc)))
        return self._downScalers

    @property
    def upScalers(self):
        if not hasattr(self, '_upScalers'):
            self._upScalers = [ds.T for ds in self.downScalers]
        return self._upScalers


class MultiGridMultiFreq(MultiFreq, BaseModelDependent):
    '''
    Multi-frequency modelling where each frequency gets its own coarser
    grid sized by targetGPW (parity: distributors.py:384-435).
    '''

    initMap = {
    #   Argument            Required    Rename as ...   Store as type
        'c':                (True,      '_c',           np.complex128),
        'freqs':            (True,      None,           list),
        'cMin':             (True,      None,           np.float64),
        'targetGPW':        (True,      None,           np.float64),
    }

    @property
    def c(self):
        if isinstance(self._c, np.ndarray):
            return self._c
        return self._c * np.ones((self.nz, self.nx), dtype=np.complex128)

    @property
    def mgHelper(self):
        if not hasattr(self, '_mgHelper'):
            sc = dict(self.systemConfig)
            sc['freqs'] = self.freqs
            self._mgHelper = MultiGridHelper(sc)
        return self._mgHelper

    @property
    def spUpdates(self):
        vals = []
        for i, freq in enumerate(self.freqs):
            ds = self.mgHelper.downScalers[i]
            spUpdate = {'freq': freq, 'c': ds * self.c.ravel()}
            spUpdate.update(ds.scaleUpdate)
            spUpdate.update(self.addFields)
            vals.append(spUpdate)
        return vals


class ViscoMultiGridMultiFreq(ViscoMultiFreq, MultiGridMultiFreq):
    '''
    Dispersion and per-frequency grids combined
    (parity: distributors.py:438-512).
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'c':            (True,      '_c',           np.float64),
    }

    maskKeys = {'freqs', 'Q', 'freqBase'}

    @property
    def c(self):
        if isinstance(self._c, np.ndarray):
            return self._c
        return self._c * np.ones((self.nz, self.nx), dtype=np.float64)

    @property
    def spUpdates(self):
        vals = []
        for i, freq in enumerate(self.freqs):
            ds = self.mgHelper.downScalers[i]
            if self.disperseFreqs:
                c = ds * self._dispersedC(freq).ravel()
            else:
                c = ds * (self.c.ravel()
                          + 0.5j * self.c.ravel() / self.Q.ravel())
            spUpdate = {'freq': freq, 'c': c}
            if isinstance(self.Q, np.ndarray) and self.Q.size > 1:
                spUpdate['Q'] = ds * self.Q.ravel()
            spUpdate.update(ds.scaleUpdate)
            spUpdate.update(self.addFields)
            vals.append(spUpdate)
        return vals
