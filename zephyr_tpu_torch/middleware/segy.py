'''
A copy of ``zephyr_tpu.middleware.segy`` (host only: numpy), kept
in the port so that it never imports the JAX package.

Minimal SEG-Y reader/writer for zephyr_tpu_torch.

The reference reads OMEGA project model/data files through pygeo's
SEGYFile (zephyr/middleware/db.py:13,112-120). This standalone
implementation covers the surface the datastore layer uses: open a file,
expose ``ntr``/``ns``, and slice traces as a (ntr, ns) float array.
Supports IBM float (format 1), int32 (2), int16 (3), IEEE float32 (5)
and int8 (8), big- or little-endian, with a writer that emits IEEE
big-endian files.
'''

import struct

import numpy as np

TEXT_HEADER_BYTES = 3200
BIN_HEADER_BYTES = 400
TRACE_HEADER_BYTES = 240

_SAMPLE_BYTES = {1: 4, 2: 4, 3: 2, 5: 4, 8: 1}


def ibm2ieee(raw_uint32):
    'Vectorized IBM 360 float -> IEEE double conversion.'

    raw = raw_uint32.astype(np.uint32)
    sign = 1.0 - 2.0 * ((raw >> 31) & 0x01).astype(np.float64)
    exponent = ((raw >> 24) & 0x7f).astype(np.float64)
    mantissa = (raw & 0x00ffffff).astype(np.float64) / float(1 << 24)
    return sign * mantissa * np.power(16.0, exponent - 64.0)


def ieee2ibm(values):
    'Vectorized IEEE -> IBM 360 float conversion (for the writer).'

    values = np.asarray(values, dtype=np.float64)
    out = np.zeros(values.shape, dtype=np.uint32)
    nonzero = values != 0
    v = values[nonzero]
    sign = (v < 0).astype(np.uint32)
    v = np.abs(v)
    # v = m * 16^(e-64), 1/16 <= m < 1
    e = np.ceil(np.log2(v) / 4.0).astype(np.int64)
    m = v / np.power(16.0, e.astype(np.float64))
    # ensure m < 1 (log edge cases)
    over = m >= 1.0
    e[over] += 1
    m[over] /= 16.0
    mant = np.round(m * (1 << 24)).astype(np.uint32)
    cap = mant >= (1 << 24)
    mant[cap] >>= 4
    e[cap] += 1
    res = (sign << 31) | (((e + 64).astype(np.uint32) & 0x7f) << 24) \
        | (mant & 0x00ffffff)
    out[nonzero] = res
    return out


class SEGYFile(object):
    '''
    Read-only SEG-Y file with trace slicing: ``sf[:]`` -> (ntr, ns) float
    array; ``sf[i]`` / ``sf[a:b]`` -> trace subsets.
    '''

    def __init__(self, filename, endian=None):

        self.filename = filename
        with open(filename, 'rb') as fp:
            self._data = fp.read()

        if len(self._data) < TEXT_HEADER_BYTES + BIN_HEADER_BYTES:
            raise ValueError('%s: too short to be a SEG-Y file'
                             % (filename,))

        self.thead = self._data[:TEXT_HEADER_BYTES]
        bhead = self._data[TEXT_HEADER_BYTES:
                           TEXT_HEADER_BYTES + BIN_HEADER_BYTES]

        if endian is None:
            endian = self._sniff_endian(bhead)
        self.endian = endian

        pre = '>' if endian == 'big' else '<'
        self.ns = struct.unpack(pre + 'H', bhead[20:22])[0]
        self.format = struct.unpack(pre + 'H', bhead[24:26])[0]

        if self.format not in _SAMPLE_BYTES:
            raise ValueError('%s: unsupported SEG-Y data format %d'
                             % (filename, self.format))
        if self.ns == 0:
            # fall back to the first trace header (bytes 115-116)
            off = TEXT_HEADER_BYTES + BIN_HEADER_BYTES
            self.ns = struct.unpack(pre + 'H',
                                    self._data[off + 114:off + 116])[0]

        tr_bytes = TRACE_HEADER_BYTES + self.ns * _SAMPLE_BYTES[self.format]
        payload = len(self._data) - TEXT_HEADER_BYTES - BIN_HEADER_BYTES
        self.ntr = payload // tr_bytes
        self._tr_bytes = tr_bytes

    @staticmethod
    def _sniff_endian(bhead):
        'Choose the endianness that yields a sane format code.'
        fmt_be = struct.unpack('>H', bhead[24:26])[0]
        if fmt_be in _SAMPLE_BYTES:
            return 'big'
        fmt_le = struct.unpack('<H', bhead[24:26])[0]
        if fmt_le in _SAMPLE_BYTES:
            return 'little'
        return 'big'

    def _decode(self, raw):
        pre = '>' if self.endian == 'big' else '<'
        if self.format == 1:
            u = np.frombuffer(raw, dtype=pre + 'u4')
            return ibm2ieee(u)
        if self.format == 2:
            return np.frombuffer(raw, dtype=pre + 'i4').astype(np.float64)
        if self.format == 3:
            return np.frombuffer(raw, dtype=pre + 'i2').astype(np.float64)
        if self.format == 5:
            return np.frombuffer(raw, dtype=pre + 'f4').astype(np.float64)
        if self.format == 8:
            return np.frombuffer(raw, dtype=np.int8).astype(np.float64)
        raise ValueError('unsupported format %d' % self.format)

    def trace(self, i):
        'Read one trace as a float array of length ns.'
        if i < 0:
            i += self.ntr
        base = TEXT_HEADER_BYTES + BIN_HEADER_BYTES + i * self._tr_bytes
        raw = self._data[base + TRACE_HEADER_BYTES:base + self._tr_bytes]
        return self._decode(raw)

    def trace_header(self, i):
        'Raw 240-byte trace header.'
        base = TEXT_HEADER_BYTES + BIN_HEADER_BYTES + i * self._tr_bytes
        return self._data[base:base + TRACE_HEADER_BYTES]

    def readTraces(self, indices=None):
        if indices is None:
            # full-file decode: use the native codec when available
            from . import segy_native
            payload = self._data[TEXT_HEADER_BYTES + BIN_HEADER_BYTES:
                                 TEXT_HEADER_BYTES + BIN_HEADER_BYTES
                                 + self.ntr * self._tr_bytes]
            native = segy_native.decode_traces(
                payload, self.ntr, self.ns, self.format,
                self.endian == 'big')
            if native is not None:
                return native
            indices = range(self.ntr)
        return np.array([self.trace(i) for i in indices])

    def __len__(self):
        return self.ntr

    def __getitem__(self, sl):
        if isinstance(sl, (int, np.integer)):
            return self.trace(int(sl))
        if isinstance(sl, slice):
            return self.readTraces(range(*sl.indices(self.ntr)))
        return self.readTraces(sl)

    def __repr__(self):
        return '<SEGYFile %s: %d traces x %d samples, format %d (%s)>' % (
            self.filename, self.ntr, self.ns, self.format, self.endian)


def writeSEGY(filename, traces, dt=1000, format=5, endian='big'):
    '''
    Write a (ntr, ns) array as a minimal SEG-Y file (IEEE float32 by
    default; format=1 writes IBM floats).
    '''

    traces = np.atleast_2d(np.asarray(traces, dtype=np.float64))
    ntr, ns = traces.shape
    pre = '>' if endian == 'big' else '<'

    with open(filename, 'wb') as fp:
        fp.write(b' ' * TEXT_HEADER_BYTES)
        bhead = bytearray(BIN_HEADER_BYTES)
        struct.pack_into(pre + 'H', bhead, 16, min(dt, 65535))
        struct.pack_into(pre + 'H', bhead, 20, ns)
        struct.pack_into(pre + 'H', bhead, 24, format)
        fp.write(bytes(bhead))

        for i in range(ntr):
            thead = bytearray(TRACE_HEADER_BYTES)
            struct.pack_into(pre + 'i', thead, 0, i + 1)
            struct.pack_into(pre + 'H', thead, 114, ns)
            fp.write(bytes(thead))
            if format == 1:
                fp.write(ieee2ibm(traces[i]).astype(pre + 'u4').tobytes())
            elif format == 5:
                fp.write(traces[i].astype(pre + 'f4').tobytes())
            else:
                raise ValueError('writer supports formats 1 and 5')
