'''
A copy of ``zephyr_tpu.middleware.fields`` (host only: numpy), kept
in the port so that it never imports the JAX package.

Wavefield container for frequency-domain problems.

Reference parity: zephyr/middleware/fields.py (HelmFields): storage of
shape (nN, nSrc, nFreq) complex, indexed with 3-part keys
``u[src, 'u', ifreq]``, including the SimPEG Fields alias-field
machinery (reference fields.py:50-117): a field name may be declared in
``aliasFields = {name: (alias, loc, func)}``, in which case reads are
computed on the fly from the stored ``alias`` panels by ``func`` (a
callable or the name of a method), per frequency, with the reference's
Fortran-order reshaping and shape deflation.
'''

import numpy as np


class HelmFields(object):
    '''
    Field storage for frequency-domain wavefields:
        u[:, 'u', ifreq] = wavefield panel (nN, nSrc)
        u[isrc, 'u', :]  -> (nN, nFreq) or (nN, nSrc, nFreq) slices
    Alias fields (computed views over a stored field) are declared via
    the class attribute ``aliasFields``.
    '''

    knownFields = {'u': 'N'}
    aliasFields = None
    dtype = np.complex128

    def __init__(self, mesh, survey):
        self.mesh = mesh
        self.survey = survey
        self._fields = {}

    @property
    def shape(self):
        return (self.mesh.nN, self.survey.nSrc, self.survey.nfreq)

    def _ensure(self, name):
        if name not in self._fields:
            self._fields[name] = np.zeros(self.shape, dtype=self.dtype)
        return self._fields[name]

    def _parseKey(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) == 1:
            key = key + (None,)
        if len(key) == 2:
            key = key + (slice(None),)
        assert len(key) == 3, 'must be [Src, fieldName, freqs]'
        srcInd, name, freqInd = key
        if name is None:
            known = list(self.knownFields)
            assert len(known) == 1, \
                'field name required when several fields are known'
            name = known[0]
        return srcInd, name, freqInd

    def _srcIndex(self, srcInd):
        'Resolve HelmSrc instances / lists to integer indices.'
        srcList = self.survey.srcList
        if isinstance(srcInd, (slice, int, np.integer)):
            return srcInd
        if isinstance(srcInd, (list, tuple, np.ndarray)):
            return [self._srcIndex(s) for s in srcInd]
        return srcList.index(srcInd)

    def __setitem__(self, key, value):
        srcInd, name, freqInd = self._parseKey(key)
        if self.aliasFields and name in self.aliasFields:
            raise KeyError('alias field %r is read-only' % (name,))
        field = self._ensure(name)
        srcInd = self._srcIndex(srcInd)
        target = field[:, srcInd, freqInd]
        if np.isscalar(value) or np.asarray(value).size == 1:
            field[:, srcInd, freqInd] = value
            return
        value = np.asarray(value)
        if value.size != target.size:
            raise ValueError('Incorrect size for data.')
        field[:, srcInd, freqInd] = value.reshape(target.shape, order='F')

    def __getitem__(self, key):
        srcInd, name, freqInd = self._parseKey(key)
        srcInd = self._srcIndex(srcInd)
        if self.aliasFields and name in self.aliasFields:
            return self._getAlias(name, srcInd, freqInd)
        field = self._ensure(name)
        return field[:, srcInd, freqInd]

    def _deflate(self, a):
        '''
        Drop singleton axes, keeping at least two dims — the reference's
        _correctShape(..., deflate=True) rule (fields.py:56-62).
        '''
        shape = tuple(s for s in a.shape if s > 1)
        if len(shape) == 0:
            shape = (1, 1)
        elif len(shape) == 1:
            shape = shape + (1,)
        return a.reshape(shape, order='F')

    def _getAlias(self, name, srcInd, freqInd):
        '''
        Aliased-field read (reference fields.py:86-117): fetch the
        stored alias panels, call ``func(panel, srcs, ifreq)`` per
        frequency, concatenate along the frequency axis, deflate.
        '''

        alias, loc, func = self.aliasFields[name]
        if isinstance(func, str):
            assert hasattr(self, func), (
                'The alias field function is a string, but it does not '
                'exist in the Fields class.')
            func = getattr(self, func)
        field = self._ensure(alias)
        pointer = field[:, srcInd, freqInd]
        # normalize to (nN, nSrcSel, nFreqSel)
        nN = field.shape[0]
        freqII = np.arange(self.survey.nfreq)[freqInd]
        freqII = np.atleast_1d(freqII)
        srcII = np.asarray(self.survey.srcList, dtype=object)[srcInd]
        srcII = srcII.tolist() if isinstance(srcII, np.ndarray) else srcII
        nS = pointer.size // (nN * freqII.size)
        pointer = pointer.reshape((nN, nS, freqII.size), order='F')

        if freqII.size == 1:
            out = func(self._deflate(pointer), srcII, freqII[0])
            out = np.asarray(out)
        else:
            panels = []
            for i, find in enumerate(freqII):
                panel = pointer[:, :, i]
                outi = np.asarray(func(panel, srcII, find))
                while outi.ndim < 3:
                    outi = outi[..., np.newaxis]
                panels.append(outi)
            out = np.concatenate(panels, axis=2)
        return self._deflate(out)

    def __contains__(self, name):
        return name in self.knownFields or \
            bool(self.aliasFields and name in self.aliasFields)

    def __repr__(self):
        nN, nSrc, nFreq = self.shape
        nfields = len(self.knownFields) + len(self.aliasFields or {})
        return ('<%s container at 0x%x: %d fields, with N shape '
                '(%d, %d, %d)>' % (self.__class__.__name__, id(self),
                                   nfields, nN, nSrc, nFreq))
