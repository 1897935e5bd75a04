'''
A copy of ``zephyr_tpu.middleware.time`` (host only: numpy), kept
in the port so that it never imports the JAX package.

Time <-> frequency bookkeeping for zephyr_tpu_torch.

Reference parity: zephyr/middleware/time.py — the derivative Keuper
wavelet (Pratt's dwavelet.m), explicit real<->complex DFT matrices
(dftreal/idftreal, Vandermonde form), and the TimeMachine helper that
enforces regular frequency sampling and converts source wavelets to
per-frequency spectra. The reference leaves fft/ifft/timeSlice as
NotImplementedError stubs (time.py:217-239); here they are implemented
(numpy FFT path consistent with the DFT convention).
'''

import numpy as np

from ..core.attrmap import AttributeMapper


def dwavelet(srcfreq, deltat, nexc):
    '''
    Derivative Keuper wavelet (parity: time.py:10-27, after R.G. Pratt's
    dwavelet.m): given the dominant frequency, sample interval, and the
    number of excursions.
    '''

    m = (int(nexc) + 2) / float(nexc)
    nsrc = int((1. / srcfreq) / deltat)
    delta = nexc * np.pi * srcfreq

    tsrc = np.arange(0, nsrc * deltat, deltat)
    return delta * (np.cos(delta * tsrc) - np.cos(m * delta * tsrc))


def dftreal(a, N, M):
    '''
    Multiple 1D forward DFT from real to complex (parity: time.py:29-49).
    NB: despite its docstring, the reference returns ALL N rows (its N/2
    truncation is dead code — time.py:42 allocates a half-size array that
    line 47 immediately reassigns); downstream slicing
    (db.py:237: sterms[:, 1:ns//2+1]) depends on the full-length output,
    so that behaviour is reproduced faithfully here.
    '''

    a = np.asarray(a)
    n = np.arange(N).reshape((N, 1))
    nk = n.T * n
    w = np.exp(2j * np.pi / N)
    W = w ** nk
    return np.dot(W, a[:N, :M]) / N


def idftreal(A, N, M):
    '''
    Multiple 1D inverse DFT from complex (zero to Nyquist) to real
    (parity: time.py:51-78).
    '''

    A = np.asarray(A)
    n = np.arange(N).reshape((N, 1))
    imax = int(np.fix((N + 1) // 2) - 1)
    k1 = np.arange(int(np.fix(N // 2)) + 1)
    k2 = np.arange(1, imax + 1)
    nk1 = n * k1.T
    nk2 = n * k2.T
    w = np.exp(-2j * np.pi / N)
    W = w ** nk1
    W2 = w ** nk2
    W[:, 1:imax + 1] += W2  # doubling for non-Nyquist terms
    return np.dot(W, A[:int(np.fix(N // 2)) + 1, :M]).real


class BaseTimeSensitive(AttributeMapper):
    'Time-sensitivity mixin (parity: time.py:81-98).'

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'freqs':        (True,      None,           list),
        'tau':          (False,     '_tau',         np.float64),
    }

    @property
    def tau(self):
        'Laplace-domain damping time constant'
        return getattr(self, '_tau', np.inf)

    @property
    def dampCoeff(self):
        'Computed damping coefficient to be added to real omega'
        return 1j / self.tau


class TimeMachine(BaseTimeSensitive):
    'Time-domain helper (parity: time.py:100-239).'

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'dt':           (False,     '_dt',          np.float64),
        'freqBase':     (False,     '_freqBase',    np.float64),
    }

    @property
    def dt(self):
        if getattr(self, '_dt', None) is None:
            self._dt = 1. / self.fMax
        return self._dt

    @dt.setter
    def dt(self, value):
        self._dt = value

    @property
    def tMax(self):
        return 1. / self.df

    @property
    def fMax(self):
        return self.freqs[-1]

    @property
    def df(self):
        if len(self.freqs) > 1:
            return self.freqs[1] - self.freqs[0]
        return 1.

    @property
    def nom(self):
        return len(self.freqs)

    @property
    def ns(self):
        return 2 * self.nom

    @property
    def freqs(self):
        return self._freqs

    @freqs.setter
    def freqs(self, value):
        if len(value) > 1:
            step = value[1] - value[0]
            for i in range(1, len(value)):
                ostep = step
                step = value[i] - value[i - 1]
                if abs(step - ostep) > 1e-5:
                    raise ValueError(
                        '%s requires that the frequencies be sampled '
                        'regularly' % (self.__class__.__name__,))
        self._freqs = value

    @property
    def freqBase(self):
        return getattr(self, '_freqBase', self.freqs[0])

    @freqBase.setter
    def freqBase(self, value):
        assert value >= 0
        self._freqBase = value

    def keuper(self, freq=None, nexc=2, dt=None):
        'Generate a Keuper wavelet time series of length ns.'

        if freq is None:
            if not self.freqBase > 0.:
                raise TypeError(
                    "%s requires argument 'freq', unless it is determined "
                    'from freqBase' % (self.__class__.__name__,))
            freq = self.freqBase
        if dt is None:
            dt = self.dt

        wavelet = dwavelet(freq, dt, nexc)
        tseries = np.zeros((self.ns,), dtype=np.float64)
        tseries[:len(wavelet)] = wavelet
        return tseries

    def fSource(self, tdata):
        'Convert time-series source(s) to equally-spaced frequencies.'

        tdata = np.asarray(tdata)
        if tdata.ndim < 2:
            tdata = tdata.reshape((1, len(tdata)))
        fdata = self.dft(tdata)
        return fdata[:, 1:fdata.shape[1] // 2 + 1]

    @staticmethod
    def dft(a):
        'Forward DFT along the last axis (rows are traces).'
        a = np.asarray(a).T
        return dftreal(a, a.shape[0], a.shape[1]).T

    @staticmethod
    def idft(A):
        'Inverse DFT along the last axis (rows are traces).'
        A = np.asarray(A).T
        ns = 2 * A.shape[0]
        A = np.vstack([np.zeros((1, A.shape[1]), dtype=np.complex128), A])
        return idftreal(A, ns, A.shape[1]).T

    @staticmethod
    def fft(a):
        'FFT counterpart of dft (same convention: conj positive freqs).'
        a = np.asarray(a)
        if a.ndim < 2:
            a = a.reshape((1, len(a)))
        N = a.shape[1]
        return np.conj(np.fft.fft(a, axis=1))[:, :N // 2] / N

    @staticmethod
    def ifft(A):
        'Inverse FFT counterpart of idft.'
        A = np.asarray(A)
        if A.ndim < 2:
            A = A.reshape((1, len(A)))
        ns = 2 * A.shape[1]
        full = np.zeros((A.shape[0], ns), dtype=np.complex128)
        full[:, 1:A.shape[1] + 1] = np.conj(A)
        # Hermitian completion for a real signal
        full[:, ns - A.shape[1]:] = np.conj(full[:, 1:A.shape[1] + 1]
                                            )[:, ::-1]
        # Nyquist term was counted twice in the reflection when present
        return np.fft.ifft(full, axis=1).real * ns

    def timeSlice(self, uF, taus=None):
        '''
        Reconstruct time-domain snapshots from per-frequency wavefields:
        u(t) = Re sum_f conj(uF_f) exp(2 pi i f t)  (FT convention of the
        conjugated frequency-domain solve). uF has shape (nfreq, ...).
        '''

        uF = np.asarray(uF)
        if taus is None:
            taus = np.arange(self.ns) * self.dt
        taus = np.asarray(taus)
        freqs = np.asarray(self.freqs, dtype=np.float64)
        phase = np.exp(2j * np.pi * np.outer(taus, freqs))
        flat = uF.reshape((len(freqs), -1))
        out = (phase @ np.conj(flat)).real * (2.0 / self.ns)
        return out.reshape((len(taus),) + uF.shape[1:])
