'''
Forward modelling of a shot line at one frequency: the operator is
prepared once (as a survey amortises it), then the window solves batches
of shots back to back through the port's restarted chunked solver:

    b = inject(source stamps of the batch)           ops.kaiser
    x, iters, relres = solver(op, b)                 solver.helmholtz
    d = extract(conj(x), receiver stamps)            ops.kaiser

The shots are dealt into batches by stride (batch i holds shots i,
i + nbatch, ...), so every batch spans the whole line, and the window
takes the batches in turn, cycling. The run's seed draws the order of
the shots within each batch: every seed gets the same work in another
order (a seeded medium or seeded shot places change the iterations,
PERF.md §2). A solve counts as done when its true
relative residual ends at or below the configuration's tol; a batch
whose worst one ends above it has each of its residuals taken with the
program's operator.

The check runs the reference's direct solve (float64) over every shot
the window solved and compares each solve's receiver data with it; it
also gives the worst relative residual the solver returned, which the
configuration's tol bounds.
'''

import math
import sys
import time

import numpy as np
import torch

from harness import line, medium, sync
from reference import modelling
from reference.blocksolve import bf16_control as control_quantize  # noqa

from zephyr_tpu_torch.backend.source import SparseKaiserSource
from zephyr_tpu_torch.ops.kaiser import extract, inject, pad_stamps
from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
from zephyr_tpu_torch.ops.stencil import apply_block_stencil_fast
from zephyr_tpu_torch.solver.helmholtz import (make_chunked_solver,
                                               prepare_operator,
                                               resolve_panels,
                                               resolve_solver_config,
                                               shifted_velocity)


def stamps(shape, pos, ireg, device, receiver=False):
    '''
    The port's padded Kaiser stamps on a grid of spacing 1 (receiver
    stamps without the 1 / (dx dz) of a source, which is 1 here).
    '''
    src = SparseKaiserSource({'nx': shape[1], 'nz': shape[0], 'dx': 1.0,
                              'dz': 1.0, 'ireg': ireg})
    rows, cols, vals = src.stamps(pos)
    cols, vals = pad_stamps(rows, cols, vals, len(pos))
    return (torch.as_tensor(cols, device=device).long(),
            torch.as_tensor(vals, device=device).to(torch.complex64))


#: the direct solve's own true relative residual, float64
REFERENCE_RELRES = 1e-9


class Cell:
    '''Set-up on construction; ``window`` runs the timed batches.'''

    def __init__(self, config, traffic, seed, device='cuda'):
        self.config, self.traffic, self.device = config, traffic, device
        t0 = time.perf_counter()
        self.c = medium(config)
        # the program runs in grid units: spacing 1 and the frequency
        # times the spacing give the same discrete operator
        self.freq = traffic['freq_hz'] * config['spacing_m']
        self.src, self.rec = line(config['shots']), line(config['receivers'])
        self.tol = config['solver']['tol']
        nz, nx = self.c.shape
        cfg = resolve_panels(resolve_solver_config(config['solver'],
                                                   torch.complex64), self.c)
        self.cfg = cfg
        c = torch.as_tensor(self.c, device=device).to(torch.complex64)
        rho = torch.ones((nz, nx), dtype=torch.float32, device=device)
        planes = minizephyr_planes(c, rho, self.freq)[None, None]
        pplanes = minizephyr_planes(shifted_velocity(c, cfg.shift), rho,
                                    self.freq,
                                    pml_cap=cfg.pml_cap)[None, None]
        self.op = prepare_operator(planes, pplanes, cfg,
                                   with_transpose=False)
        sync(device)
        t1 = time.perf_counter()
        self.solver = make_chunked_solver(cfg, chunk=traffic['chunk'])
        ireg = config['ireg']
        self.scols, self.svals = stamps((nz, nx), self.src, ireg, device)
        self.rcols, self.rvals = stamps((nz, nx), self.rec, ireg, device,
                                        receiver=True)
        nb = len(self.src) // traffic['batch']
        rng = np.random.default_rng(seed % 2 ** 64)
        self.batches = [rng.permutation(np.arange(i, len(self.src), nb)
                                        [:traffic['batch']])
                        for i in range(nb)]
        self.next = 0
        # warm-up: one capped chunk of a whole batch
        self._solve(self.batches[0], max_chunks=1)
        sync(device)
        #: seconds of set-up after the library: the medium and the
        #: operator's preparation, then the warm-up
        self.setup_parts = {'prepare': t1 - t0,
                            'warm_up': time.perf_counter() - t1}

    def _solve(self, shots, max_chunks=None):
        nz, nx = self.c.shape
        idx = torch.as_tensor(shots, device=self.device)
        b = inject(self.scols[idx], self.svals[idx], nz, nx)[:, None]
        x, iters, relres = self.solver(self.op, b, max_chunks=max_chunks)
        d = extract(torch.conj(x[:, 0]), self.rcols, self.rvals)
        return b, x, iters, relres, d

    def window(self, seconds):
        '''
        Whole batches until ``seconds`` have passed (the last one begun
        before then completes and counts); the record of the window.
        '''
        units, data = [], []
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            shots = self.batches[self.next % len(self.batches)]
            self.next += 1
            t1 = time.perf_counter()
            b, x, iters, relres, d = self._solve(shots)
            ok = np.ones(len(shots), bool)
            if not (math.isfinite(relres) and relres <= self.tol):
                r = b - apply_block_stencil_fast(self.op.planes, x)
                rel = (torch.linalg.vector_norm(r[:, 0], dim=(-2, -1))
                       / torch.linalg.vector_norm(b[:, 0], dim=(-2, -1)))
                rel = rel.cpu().numpy()
                ok = np.isfinite(rel) & (rel <= self.tol)
            data.append(d)
            units.append({'shots': shots.tolist(), 'iters': int(iters),
                          'relres': float(relres), 'ok': int(ok.sum()),
                          'failed': int((~ok).sum()),
                          'seconds': time.perf_counter() - t1})
            del b, x
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        wall = time.perf_counter() - t0
        self.data = data
        return {'window_s': wall, 'units': units,
                'setup_parts': self.setup_parts,
                'solves_ok': sum(u['ok'] for u in units),
                'attempted': sum(len(u['shots']) for u in units),
                'failed': sum(u['failed'] for u in units)}

    def release(self):
        'Free the program state (the data of the window stay).'
        self.data = [d.cpu().numpy() for d in self.data]
        del self.op, self.solver, self.scols, self.svals
        del self.rcols, self.rvals

    def check(self, record, quantize=None, dtype=torch.complex128):
        '''
        {name: value} of the comparison with the reference: the widest
        relative gap of a solve's receiver data from the direct solve's;
        and the worst relative residual the solver returned.
        ``quantize`` and ``dtype`` put the reference's lower-precision
        control in the program's place instead. The direct solve's own
        residual has to be at rounding (REFERENCE_RELRES), or the run
        stops: the yardstick failed, not the program.
        '''
        shots = sorted({s for u in record['units'] for s in u['shots']})
        ref, worst = modelling.receiver_data(
            self.c, self.freq, self.src[shots], self.rec,
            ireg=self.config['ireg'], device=self.device)
        print('reference: worst residual of the direct solve %.3e'
              % worst, file=sys.stderr)
        if not worst <= REFERENCE_RELRES:
            raise RuntimeError('the reference solve is not at rounding: '
                               'residual %.3e' % worst)
        row = {s: i for i, s in enumerate(shots)}
        if quantize is not None:
            got, _ = modelling.receiver_data(
                self.c, self.freq, self.src[shots], self.rec,
                ireg=self.config['ireg'], device=self.device,
                quantize=quantize, dtype=dtype)
            data = [got[[row[s] for s in u['shots']]]
                    for u in record['units']]
        else:
            data = self.data
        gap = 0.0
        for u, d in zip(record['units'], data):
            r = ref[[row[s] for s in u['shots']]]
            g = np.linalg.norm(d - r, axis=1) / np.linalg.norm(r, axis=1)
            gap = max(gap, float(np.max(np.where(np.isfinite(g), g,
                                                 np.inf))))
        rel = [u['relres'] for u in record['units']]
        return {'data_gap': gap,
                'solve_relres': max(rel) if all(map(math.isfinite, rel))
                else math.inf}

