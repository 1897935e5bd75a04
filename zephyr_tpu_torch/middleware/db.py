'''
A copy of ``zephyr_tpu.middleware.db`` (host only: numpy and scipy), kept
in the port so that it never imports the JAX package.

Datastores and data writers for zephyr_tpu_torch.

Reference parity: zephyr/middleware/db.py — the OMEGA/FULLWV project
reader (regex registry over 13 project-file types, SEG-Y model/data files,
ini-driven systemConfig assembly), the ``.utout`` Fortran-unformatted
writer, and the flat-Python and pickle datastores. The HDF5 store the
reference left commented out (db.py:313-339) is implemented here when
h5py is available.
'''

import glob
import os
import pickle

import numpy as np
import scipy.io as io

from .segy import SEGYFile
from .time import BaseTimeSensitive, TimeMachine
from .util import compileDict, readini

ftypeRegex = {
    'vp':       r'^%s(?P<iter>[0-9]*)\.vp(?P<freq>[0-9]*\.?[0-9]+)?[^i]*$',
    'qp':       r'^%s(?P<iter>[0-9]*)\.qp(?P<freq>[0-9]*\.?[0-9]+)?.*$',
    'vpi':      r'^%s(?P<iter>[0-9]*)\.vpi(?P<freq>[0-9]*\.?[0-9]+)?.*$',
    'rho':      r'^%s\.rho$',
    'eps2d':    r'^%s\.eps2d$',
    'del2d':    r'^%s\.del2d$',
    'theta':    r'^%s\.theta$',
    'src':      r'^%s\.(new)?src(\.avg)?$',
    'grad':     r'^%s(?P<iter>[0-9]*)\.gvp[a-z]?(?P<freq>[0-9]*\.?[0-9]+)?.*$',
    'data':     r'^%s\.(ut|vz|vx)[ifoOesrcbt]+(?P<freq>[0-9]*\.?[0-9]+).*$',
    'diff':     r'^%s\.ud[ifoOesrcbt]+(?P<freq>[0-9]*\.?[0-9]+).*$',
    'wave':     r'^%s(?P<iter>[0-9]*)\.(wave|bwave)(?P<freq>[0-9]*\.?[0-9]+).*$',
    'slice':    r'^%s\.sl(?P<iter>[0-9]*)',
}


class UtoutWriter(BaseTimeSensitive):
    '''
    Writes frequency-domain data to an OMEGA ``.utout`` file: one
    Fortran-unformatted record per frequency, each holding
    [omega + damp | data panel^T] as complex64 (parity: db.py:35-66).
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'projnm':       (True,      None,           str),
    }

    def __call__(self, data, fid=slice(None), ftype='utout'):

        ofreqs = self.freqs[fid]
        ofreqs = [(2 * np.pi * freq) + self.dampCoeff for freq in ofreqs]
        outfile = '%s.%s' % (self.projnm, ftype)

        nfreq = len(ofreqs)
        if data.ndim != 3:
            raise ValueError('Data must be of shape (nrec, nsrc, nfreq)')
        assert data.shape[2] == nfreq
        nrec, nsrc = data.shape[0], data.shape[1]

        with io.FortranFile(outfile, 'w') as ff:
            for i, freq in enumerate(ofreqs):
                panel = np.empty((nsrc, nrec + 1), dtype=np.complex64)
                panel[:, :1] = freq
                panel[:, 1:] = data[:, :, i].T
                ff.write_record(panel.ravel())


def utoutRead(filename, nrec):
    'Read a .utout file back: returns (freqs_complex, data (nrec,nsrc,nf)).'

    freqs, panels = [], []
    with io.FortranFile(filename, 'r') as ff:
        while True:
            try:
                rec = ff.read_record(np.complex64)
            except Exception:
                break
            panel = rec.reshape((-1, nrec + 1))
            freqs.append(panel[0, 0])
            panels.append(panel[:, 1:].T)
    data = np.stack(panels, axis=-1) if panels else \
        np.zeros((nrec, 0, 0), np.complex64)
    return np.array(freqs), data


class BaseDatastore(object):

    def __init__(self, projnm):
        pass

    @property
    def systemConfig(self):
        raise NotImplementedError


class FullwvDatastore(BaseDatastore):
    '''
    OMEGA/FULLWV project reader (parity: db.py:81-278): scans the working
    directory for project files matching the regex registry, wraps each in
    a SEGYFile, and assembles the full simulation systemConfig from the
    .ini plus model files.
    '''

    def __init__(self, projnm):

        self.projnm = projnm
        inifile = '%s.ini' % projnm
        if not os.path.isfile(inifile):
            raise IOError('Project file %s does not exist' % (inifile,))

        self.ini = readini(inifile)

        redict = compileDict(projnm, ftypeRegex)
        keepers = {key: {} for key in redict}
        for fn in glob.glob('*'):
            for key in redict:
                match = redict[key].match(fn)
                if match is not None:
                    keepers[key][fn] = match.groupdict()
                    break
        self.keepers = keepers

        handled = {}
        for ftype in self.keepers:
            for fn in self.keepers[ftype]:
                handled[fn] = self.handle(ftype, fn)
        self.handled = handled

    @staticmethod
    def sfWrapper(filename):
        return SEGYFile(filename)

    def handle(self, ftype, filename):
        return self.sfWrapper(filename)

    def __getitem__(self, item):
        if isinstance(item, str):
            key, sl = item, slice(None)
        elif isinstance(item, tuple):
            assert len(item) == 2
            key, sl = item
        else:
            raise TypeError(type(item))

        if not key.startswith(self.projnm):
            key = self.projnm + key
        if key in self:
            return self.handled[key][sl]
        raise KeyError(key)

    def __contains__(self, key):
        if not key.startswith(self.projnm):
            key = self.projnm + key
        return key in self.handled

    def keys(self):
        return list(self.handled.keys())

    def __repr__(self):
        return '<%s(%s) comprising %d files>' % (
            self.__class__.__name__, self.projnm, len(self.handled))

    @property
    def systemConfig(self):
        'Assemble the simulation config from ini + SEG-Y files (parity).'

        transferKeys = {
            'nx':       None,
            'nz':       None,
            'dx':       None,
            'dz':       None,
            'xorig':    None,
            'zorig':    None,
            'freqs':    None,
            'nky':      None,
            'isreg':    'ireg',
            'freqbase': 'freqBase',
        }

        sc = {(transferKeys[key] or key): self.ini[key]
              for key in transferKeys}

        # tau sentinel 999.999 -> no damping
        sc['tau'] = self.ini['tau'] \
            if abs(float(self.ini['tau']) - 999.999) > 1e-2 else np.inf

        sc['freeSurf'] = (self.ini['fst'], self.ini['fsr'],
                          self.ini['fsb'], self.ini['fsl'])

        srcs, recs = self.ini['srcs'], self.ini['recs']
        if srcs.shape[1] <= 3:
            srcGeom, recGeom = srcs[:, :2], recs[:, :2]
        elif srcs.shape[1] == 4:
            srcGeom, recGeom = srcs[:, ::2], recs[:, ::2]
        else:
            raise ValueError('unexpected source table width %d'
                             % srcs.shape[1])

        sc['geom'] = {'src': srcGeom, 'rec': recGeom, 'mode': 'fixed'}

        for fn, key, xform in (('.vp', 'c', lambda a: a.T),
                               ('.qp', 'Q', lambda a: 1. / a.T),
                               ('.rho', 'rho', lambda a: a.T),
                               ('.eps2d', 'eps', lambda a: a.T),
                               ('.del2d', 'delta', lambda a: a.T),
                               ('.theta', 'theta', lambda a: a.T)):
            if fn in self:
                sc[key] = xform(self[fn])

        if '.src' in self:
            src = self['.src']
            nsrc = srcGeom.shape[0]
            tm = TimeMachine(sc)
            if src.shape[0] != 1 and src.shape[0] != nsrc:
                print('Source nsrc does not match project nsrc; using '
                      'first term for all sources')
                src = src[:1, :]
            assert src.shape[1] == tm.ns, \
                'Source ns does not match computed ns'
            sterms = tm.dft(src)
            sc['sterms'] = sterms[:, 1:tm.ns // 2 + 1].T

        sc['projnm'] = self.projnm
        return sc

    def dataFiles(self, ftype):
        dKeep = self.keepers['data']
        fns = [fn for fn in dKeep if fn.find(ftype) > -1]
        ffreqs = [float(dKeep[fn]['freq']) for fn in fns]
        order = np.argsort(ffreqs)
        return [fns[i] for i in order], [ffreqs[i] for i in order]

    def spoolData(self, fid=slice(None), ftype='utobs'):
        'Stream observed data per frequency from interleaved-real SEG-Y.'
        ifreqs = self.ini['freqs'][fid]
        fns, ffreqs = self.dataFiles(ftype)
        sffreqs = ['%0.3f' % freq for freq in ffreqs]
        try:
            finds = [sffreqs.index('%0.3f' % freq) for freq in ifreqs]
        except ValueError as e:
            raise ValueError('Could not find data from all requested '
                             'frequencies: %s' % e)
        for fi in finds:
            fdata = self[fns[fi]]
            yield fdata[::2].T + 1j * fdata[1::2].T

    def utoutWrite(self, data, fid=slice(None), ftype='utout'):
        UtoutWriter(self.systemConfig)(data, fid, ftype)


class FlatDatastore(BaseDatastore):
    'Get systemConfig from a projnm.py file (parity: db.py:280-298).'

    def __init__(self, projnm):
        infile = '%s.py' % (projnm,)
        with open(infile, 'r') as fp:
            contents = fp.read()
        namespace = {}
        exec(contents, namespace)
        self.systemConfig = namespace['systemConfig']

    @property
    def systemConfig(self):
        return self._systemConfig

    @systemConfig.setter
    def systemConfig(self, value):
        self._systemConfig = value


class PickleDatastore(BaseDatastore):
    'Get systemConfig from a pickle file (parity: db.py:301-310).'

    def __init__(self, projnm):
        infile = '%s.pickle' % (projnm,)
        with open(infile, 'rb') as fp:
            self.systemConfig = pickle.Unpickler(fp).load()

    @property
    def systemConfig(self):
        return self._systemConfig

    @systemConfig.setter
    def systemConfig(self, value):
        self._systemConfig = value


class HDF5Datastore(BaseDatastore):
    '''
    HDF5-backed systemConfig store — planned but never implemented in the
    reference (db.py:313-327). Requires h5py; arrays are stored as
    datasets, scalars as attributes.
    '''

    def __init__(self, projnm):
        try:
            import h5py
        except ImportError as e:
            raise ImportError('HDF5Datastore requires h5py') from e

        candidates = glob.glob('%s.h*5' % projnm)
        h5file = candidates[0] if candidates else '%s.hdf5' % projnm
        self._h5py = h5py
        self.db = h5py.File(h5file, 'a')
        self.projnm = projnm

    @property
    def systemConfig(self):
        sc = {}
        for key, value in self.db.attrs.items():
            sc[key] = value
        for key in self.db:
            sc[key] = np.asarray(self.db[key])
        return sc

    def write(self, systemConfig):
        for key, value in systemConfig.items():
            value = np.asarray(value) if not np.isscalar(value) else value
            if isinstance(value, np.ndarray):
                if key in self.db:
                    del self.db[key]
                self.db[key] = value
            else:
                try:
                    self.db.attrs[key] = value
                except TypeError:
                    pass  # non-serializable entries (classes) are skipped
        self.db.flush()
