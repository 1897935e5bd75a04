'''
A copy of ``zephyr_tpu.middleware.util`` (host only: numpy), kept
in the port so that it never imports the JAX package.

OMEGA project-file utilities.

Reference parity: zephyr/middleware/util.py — the fixed-layout OMEGA
(FULLWV) ``.ini`` parser and the regex table compiler for project files.
The .ini format is a line-positional Fortran-era layout; the field layout
below follows the format specification embodied in the reference parser
(util.py:21-157) and the sample project notebooks/Time Comprehensive/
xhlayr.ini.
'''

import re

import numpy as np


def str2bool(v):
    'Map common truthy strings to bool.'
    return str(v).lower() in ('yes', 'true', 't', '1')


class _Cursor(object):
    'Line cursor over the ini file contents.'

    def __init__(self, lines):
        self.lines = lines

    def tokens(self, i, strip_quotes=False):
        line = self.lines[i]
        if strip_quotes:
            line = line.replace("'", '')
        return line.strip().split()

    def floats_block(self, start, count):
        'Read ``count`` floats laid out five per line starting at start.'
        vals = []
        rows = count // 5 + (1 if count % 5 else 0)
        for i in range(start, start + rows):
            vals.extend(float(tok) for tok in self.tokens(i))
        return np.array(vals), start + rows

    def table(self, start, count, drop_first=True):
        'Read a numbered table of ``count`` rows of floats.'
        rows = []
        for i in range(start, start + count):
            toks = self.tokens(i)
            if drop_first:
                toks = toks[1:]
            rows.append([float(tok) for tok in toks])
        return np.array(rows), start + count


def readini(infile):
    'Parse a (2.5D) OMEGA ini file into a settings dictionary.'

    with open(infile, 'r') as fp:
        cur = _Cursor(fp.readlines())

    d = {}

    toks = cur.tokens(1)
    d['comment'] = int(toks[0])
    d['lessfiles'] = str2bool(toks[1])

    toks = cur.tokens(3)
    d['nx'], d['nz'] = int(toks[0]), int(toks[1])
    d['dx'], d['dz'] = float(toks[2]), float(toks[3])
    d['xorig'], d['zorig'] = float(toks[4]), float(toks[5])

    toks = cur.tokens(5, strip_quotes=True)
    d['inv'] = str2bool(toks[0])
    d['datain'], d['dataout'] = toks[1], toks[2]
    d['waveout'] = int(toks[3])
    d['usescratch'] = str2bool(toks[4])
    d['nom'] = int(toks[5])
    d['nsam'] = int(toks[6])
    d['tau'] = float(toks[7])
    d['nftout'] = int(toks[8])

    toks = cur.tokens(7, strip_quotes=True)
    d['we'] = toks[0]
    d['param'] = int(toks[1])
    d['nky'] = int(toks[2])
    d['method'] = int(toks[3])
    d['vmin'] = float(toks[4])
    d['deltatt'] = float(toks[5])
    d['src'] = int(toks[6])
    d['wavscale'] = str2bool(toks[7])
    d['aniso'] = float(toks[8])
    d['freqbase'] = float(toks[9])

    toks = cur.tokens(9)
    d['reduce'] = str2bool(toks[0])
    d['redvel'] = float(toks[1])
    d['tbegin'] = float(toks[2])
    d['fst'] = str2bool(toks[3])
    d['fsr'] = str2bool(toks[4])
    d['fsb'] = str2bool(toks[5])
    d['fsl'] = str2bool(toks[6])
    d['sponge'] = str2bool(toks[7])
    d['isufx'] = int(toks[8])

    d['freqs'], nxt = cur.floats_block(11, d['nom'])

    d['kys'], nxt = cur.floats_block(nxt + 1, d['nky'])

    d['nslices'] = int(cur.tokens(nxt + 1)[0])
    slices = []
    start = nxt + 3
    for i in range(start, start + d['nslices']):
        toks = cur.tokens(i)
        slices.append([int(toks[0]), int(toks[1]), float(toks[2])])
        d['slices'] = slices
    nxt = start + d['nslices']

    toks = cur.tokens(nxt + 1)
    d['ns'] = int(toks[0])
    d['isreg'] = int(toks[1])
    d['sspread'] = float(toks[2])
    d['useswt'] = str2bool(toks[3])
    d['srcs'], nxt = cur.table(nxt + 3, d['ns'])

    toks = cur.tokens(nxt + 1)
    d['nr'] = int(toks[0])
    d['irreg'] = int(toks[1])
    d['rspread'] = float(toks[2])
    d['userwt'] = str2bool(toks[3])
    d['recs'], nxt = cur.table(nxt + 3, d['nr'])

    toks = cur.tokens(nxt + 1)
    d['ng'] = int(toks[0])
    d['igreg'] = int(toks[1])
    d['gspread'] = float(toks[2])
    d['usegwt'] = str2bool(toks[3])
    d['geos'], nxt = cur.table(nxt + 3, d['ng'])

    toks = cur.tokens(nxt + 1)
    d['sghost'] = str2bool(toks[0])
    d['rghost'] = str2bool(toks[1])
    d['gghost'] = str2bool(toks[2])
    d['zgg'] = float(toks[3])

    d['zero1'] = [int(tok) for tok in cur.tokens(nxt + 3)]
    d['zero2'] = [int(tok) for tok in cur.tokens(nxt + 4)]

    return d


def compileDict(projnm, exprdict):
    '''
    Compile a dict of filename regular-expression templates against a
    project name (parity: util.py:159-178).
    '''

    redict = {}
    for key, expr in exprdict.items():
        try:
            redict[key] = re.compile(expr % projnm)
        except TypeError:
            redict[key] = re.compile(expr)
    return redict
