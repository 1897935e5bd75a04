'''
K11: the BiCGStab recurrence of ``solver.krylov`` fused into hand-written
CUDA kernels (``csrc/k11_bicgstab.cu``), and their plain torch twins.

A step of the recurrence is five launches around the preconditioner and
the operator (``solver.krylov._bicgstab_fused`` drives them):

    update_p   p = r + beta (p - omega v), in place
               [phat = M p, v = A phat]
    dot_rv     <rhat, v> and alpha_new
    update_s   s = r - alpha_new v, in place
               [shat = M s, t = A shat]
    dots_ts    <t, t>, <t, s> and omega_new
    update_xr  x += alpha_new phat + omega_new shat, r = s - omega_new t;
               <rhat, r>, <r, r> and the lane's rho, alpha, omega, k,
               down and act

after ``prologue`` (rhat, ||b||, atol, <r, r>) once a solve. Every
per-lane scalar lives in a ``State`` on the fields' device, which the
kernels read and update themselves; the host reads only ``act``, one
step late (``ActReads``), to end the loop. A frozen lane (act 0) is left
as it is.

Each function runs its twin (``*_ref``: the same arguments, state, freeze
and breakdown logic in torch) for CPU tensors and its kernel for CUDA
tensors, which it checks first (device, complex64, shape, contiguity, no
conjugate or negative view, no written field sharing memory with another
operand) and raises on anything else. The kernels are built into the
library of ``cuda_kernels`` (its ``SOURCES``) but launched here and
counted in ``KRYLOV_LAUNCHES``, not in ``cuda_kernels.LAUNCHES``; their
names start with ``zk_``.
'''

import ctypes
import threading

import torch

from . import cuda_kernels

#: launches of each K11 kernel since the last ``reset_launches()``
KRYLOV_LAUNCHES = {'bicgstab_prologue': 0, 'bicgstab_p': 0,
                   'bicgstab_rv': 0, 'bicgstab_s': 0, 'bicgstab_ts': 0,
                   'bicgstab_xr': 0}

#: rows of ``State.sc`` (a complex scalar takes two: re, im) and of
#: ``State.fl``; csrc/k11_bicgstab.cu numbers them the same
RHO, ALPHA, OMEGA, RHON, ALPHAN, OMEGAN = 0, 2, 4, 6, 8, 10
TOL, ATOL, BNORM, RNORM = 12, 13, 14, 15
NSC = 16
ACT, KIT, DOWN, BAD, COUNT = 0, 1, 2, 3, 4
NFL = 5
#: partial sums a block keeps (the most any kernel reduces at once)
NPART = 3

#: threads a block (the kernels' THREADS)
THREADS = 256
#: blocks the launch aims at on each SM, over all lanes
BLOCKS_PER_SM = 8
#: the fewest elements a block takes, and the most blocks a lane
MIN_BLOCK = 1024
MAX_BLOCKS = 1024
#: the most lanes a launch takes (its grid's y extent)
MAX_LANES = 65535

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def reset_launches():
    for k in KRYLOV_LAUNCHES:
        KRYLOV_LAUNCHES[k] = 0


def _ceil(a, b):
    return -(-int(a) // int(b))


def plan(R, N):
    '''
    (G, C): the blocks a lane and the elements a block (a multiple of
    THREADS) for R lanes of N elements: about BLOCKS_PER_SM blocks an SM
    over all lanes, at least MIN_BLOCK elements a block, at most
    MAX_BLOCKS blocks a lane (2304 x 768 x 16: 66 blocks of 26880).
    '''

    blocks = max(1, min(_ceil(cuda_kernels.SM_COUNT * BLOCKS_PER_SM, R),
                        _ceil(N, MIN_BLOCK), MAX_BLOCKS))
    C = _ceil(_ceil(N, blocks), THREADS) * THREADS
    return _ceil(N, C), C


def on_card(b):
    '''
    Whether the kernels serve right-hand sides b: a CUDA complex64 batch.
    ``solver.krylov`` takes K11 for every such batch (or raises where
    ``State`` or ``_check`` cannot serve it) and the eager recurrence for
    anything else (the CPU, complex128).
    '''

    return (isinstance(b, torch.Tensor) and b.device.type == 'cuda'
            and b.dtype == torch.complex64)


class State:
    '''
    The per-lane state of one solve, on b's device: ``sc`` (NSC, R) real
    scalars (rho, alpha, omega, this step's rho_new, alpha_new and
    omega_new, tol, atol, ||b||, ||r||), ``fl`` (NFL, R) int32 (act, k,
    down, this step's breakdown, the kernels' arrival counter), ``part``
    (NPART, R, G) float64 block partial sums; G and C from ``plan``.
    ``tol`` is a float or an (R,) tensor. Raises on a batch the kernels
    cannot serve (no element, or more than MAX_LANES lanes).
    '''

    def __init__(self, b, tol):
        if b.dim() < 1 or b.numel() == 0 or b.shape[0] > MAX_LANES:
            raise ValueError('K11 takes 1 to %d lanes of at least one '
                             'element, not a batch of shape %s'
                             % (MAX_LANES, tuple(b.shape)))
        self.R = int(b.shape[0])
        self.N = int(b[0].numel())
        self.G, self.C = plan(self.R, self.N)
        real = torch.empty((), dtype=b.dtype).real.dtype
        self.sc = torch.zeros((NSC, self.R), dtype=real, device=b.device)
        self.sc[TOL] = tol
        self.fl = torch.zeros((NFL, self.R), dtype=torch.int32,
                              device=b.device)
        self.part = torch.zeros((NPART, self.R, self.G),
                                dtype=torch.float64, device=b.device)

    def act(self):
        'The lanes still iterating, (R,) int32 (the view the host reads).'
        return self.fl[ACT]

    def iters(self):
        return self.fl[KIT].clone()

    def relres(self):
        return self.sc[RNORM] / self.sc[BNORM]


class ActReads:
    '''
    A State's ``act`` row on its way to the host, so that the host can
    read it a step late without draining the stream. ``post()`` queues a
    snapshot of the row as it stands on the stream: on a card a
    non-blocking copy into pinned host memory and an event on the current
    stream, on the CPU a plain copy. ``any()`` waits for the oldest
    snapshot not yet read (on a card for its event only: what was queued
    after it runs on) and says whether any lane was active in it. At most
    DEPTH snapshots wait to be read at once.
    '''

    DEPTH = 2

    def __init__(self, st):
        self._act = st.act()
        self._cuda = self._act.device.type == 'cuda'
        self._host = [torch.empty(st.R, dtype=torch.int32,
                                  pin_memory=self._cuda)
                      for _ in range(self.DEPTH)]
        self._events = ([torch.cuda.Event() for _ in range(self.DEPTH)]
                        if self._cuda else None)
        self._posted = self._read = 0

    def post(self):
        if self._posted - self._read == self.DEPTH:
            raise RuntimeError('ActReads: %d snapshots wait to be read'
                               % self.DEPTH)
        slot = self._posted % self.DEPTH
        self._host[slot].copy_(self._act, non_blocking=self._cuda)
        if self._cuda:
            self._events[slot].record(
                torch.cuda.current_stream(self._act.device))
        self._posted += 1

    def any(self):
        if self._read == self._posted:
            raise RuntimeError('ActReads: no snapshot to read')
        slot = self._read % self.DEPTH
        if self._cuda:
            self._events[slot].synchronize()
        self._read += 1
        return bool(self._host[slot].any())


# --- the kernels ----------------------------------------------------------

def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = cuda_kernels._load()
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fields = {'prologue': 3, 'p': 3, 'rv': 2, 's': 3, 'ts': 2, 'xr': 7}
        extra = {'prologue': [I], 'xr': [I]}
        for name, n in fields.items():
            fn = getattr(lib, 'zk_bicgstab_' + name)
            fn.argtypes = ([P] * (n + 3) + [I, I, L, L]
                           + extra.get(name, []) + [P])
            fn.restype = I
        _lib = lib
        return _lib


def _check(st, read, written):
    'The operands of a launch: raise on anything the kernels do not take.'
    dev = st.sc.device
    for name, t in list(read.items()) + list(written.items()):
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError('%s: expected a tensor on %s' % (name, dev))
        if t.dtype != torch.complex64:
            raise TypeError('%s: dtype %s, the kernels take complex64'
                            % (name, t.dtype))
        if t.is_conj() or t.is_neg():
            raise ValueError('%s: a conjugate or negative view (the '
                             'kernels read raw memory)' % name)
        if not t.is_contiguous():
            raise ValueError('%s: must be contiguous' % name)
        if t.shape[0] != st.R or t.numel() != st.R * st.N:
            raise ValueError('%s: shape %s, expected %d lanes of %d'
                             % (name, tuple(t.shape), st.R, st.N))
    for name, t in written.items():
        for other, u in list(read.items()) + list(written.items()):
            if other != name and u.data_ptr() == t.data_ptr():
                raise ValueError('%s: shares memory with %s' % (name, other))


def _launch(name, st, fields, *ints):
    fn = getattr(_load(), 'zk_' + name)
    with torch.cuda.device(st.sc.device):
        err = fn(*[f.data_ptr() for f in fields], st.sc.data_ptr(),
                 st.fl.data_ptr(), st.part.data_ptr(), st.R, st.G, st.N,
                 st.C, *ints,
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError('zephyr_tpu_torch: %s launch failed with CUDA '
                           'error %d' % (name, err))
    with _count_lock:
        KRYLOV_LAUNCHES[name] += 1


def _on_cpu(t):
    return t.device.type == 'cpu'


def prologue(b, r, st, maxiter):
    '''
    The start of a solve from r = b - A x0: returns rhat (a copy of r)
    and sets every lane's scalars (rho = alpha = omega = 1, rho_new =
    <r, r>, atol = tol ||b||, k = 0, act = ||r|| > atol and 0 <
    maxiter).
    '''

    rhat = torch.empty_like(r)
    if _on_cpu(b):
        prologue_ref(b, r, rhat, st, maxiter)
        return rhat
    _check(st, {'b': b, 'r': r}, {'rhat': rhat})
    _launch('bicgstab_prologue', st, (b, r, rhat), int(maxiter))
    return rhat


def update_p(r, p, v, st):
    'p = r + beta (p - omega v) in place, beta = rho_new alpha / (rho omega).'
    if _on_cpu(r):
        return update_p_ref(r, p, v, st)
    # v may be p itself (an identity preconditioner and operator)
    _check(st, {'r': r}, {'p': p})
    _check(st, {'v': v}, {})
    _launch('bicgstab_p', st, (r, p, v))


def dot_rv(rhat, v, st):
    'alpha_new = rho_new / <rhat, v>, and the breakdown of either.'
    if _on_cpu(rhat):
        return dot_rv_ref(rhat, v, st)
    _check(st, {'rhat': rhat, 'v': v}, {})
    _launch('bicgstab_rv', st, (rhat, v))


def update_s(r, v, s, st):
    's = r - alpha_new v in place.'
    if _on_cpu(r):
        return update_s_ref(r, v, s, st)
    _check(st, {'r': r, 'v': v}, {'s': s})
    _launch('bicgstab_s', st, (r, v, s))


def dots_ts(t, s, st):
    'omega_new = <t, s> / <t, t>.'
    if _on_cpu(t):
        return dots_ts_ref(t, s, st)
    _check(st, {'t': t, 's': s}, {})
    _launch('bicgstab_ts', st, (t, s))


def update_xr(rhat, x, r, s, t, phat, shat, st, maxiter):
    '''
    x += alpha_new phat + omega_new shat and r = s - omega_new t in place,
    then the step's end: rho, alpha, omega = rho_new, alpha_new,
    omega_new; rho_new = <rhat, r> (the next step's); k + 1; down; act =
    ||r|| > atol and k < maxiter and not down.
    '''

    if _on_cpu(r):
        return update_xr_ref(rhat, x, r, s, t, phat, shat, st, maxiter)
    _check(st, {'rhat': rhat, 's': s, 't': t, 'phat': phat, 'shat': shat},
           {'x': x, 'r': r})
    _launch('bicgstab_xr', st, (rhat, x, r, s, t, phat, shat), int(maxiter))


# --- the plain twins ------------------------------------------------------

def _rows(f):
    return f.reshape(f.shape[0], -1)


def _bcast(s, like):
    return s.reshape((-1,) + (1,) * (like.dim() - 1))


def _get_c(st, row):
    return torch.complex(st.sc[row], st.sc[row + 1])


def _set(st, row, value, act):
    st.sc[row] = torch.where(act, value, st.sc[row])


def _set_c(st, row, value, act):
    _set(st, row, value.real, act)
    _set(st, row + 1, value.imag, act)


def _set_flag(st, row, value, act):
    st.fl[row] = torch.where(act, value.to(torch.int32), st.fl[row])


def _safe_div(num, den):
    'num / den, or 0 on (near-)breakdown of the denominator.'
    bad = torch.abs(den) < torch.finfo(den.real.dtype).tiny
    return torch.where(bad, torch.zeros((), dtype=num.dtype,
                                        device=num.device),
                       num / torch.where(bad, torch.ones_like(den), den))


def _lane_sums(st, act, *terms):
    '''
    The block partials of each term (R, N) real (block g sums elements
    [g C, (g + 1) C)) into ``st.part`` for the active lanes, and each
    lane's sum of its partials, in the state's real dtype.
    '''

    out = []
    for k, term in enumerate(terms):
        R, N = term.shape
        pad = st.G * st.C - N
        if pad:
            term = torch.cat([term, term.new_zeros((R, pad))], 1)
        parts = term.reshape(R, st.G, st.C).sum(-1).to(torch.float64)
        st.part[k] = torch.where(act[:, None], parts, st.part[k])
        out.append(st.part[k].sum(-1).to(st.sc.dtype))
    return out


def _sq(a):
    'Elementwise |a|^2 of a field, (R, N) real.'
    a = _rows(a)
    return a.real * a.real + a.imag * a.imag


def _dot_terms(a, b):
    'The real and imaginary parts of conj(a) * b, each (R, N).'
    prod = _rows(a).conj() * _rows(b)
    return prod.real, prod.imag


def prologue_ref(b, r, rhat, st, maxiter):
    'The twin of ``prologue`` (rhat given, written in place).'
    rhat.copy_(r)
    every = torch.ones(st.R, dtype=torch.bool, device=st.sc.device)
    bb, rr = _lane_sums(st, every, _sq(b), _sq(r))
    bnorm = torch.sqrt(bb)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    atol = st.sc[TOL] * bnorm
    rnorm = torch.sqrt(rr)
    for row in (RHO, ALPHA, OMEGA):
        st.sc[row], st.sc[row + 1] = 1, 0
    st.sc[RHON], st.sc[RHON + 1] = rr, 0
    st.sc[ATOL], st.sc[BNORM], st.sc[RNORM] = atol, bnorm, rnorm
    st.fl[KIT] = st.fl[DOWN] = st.fl[BAD] = 0
    st.fl[ACT] = ((rnorm > atol) & (0 < maxiter)).to(torch.int32)


def update_p_ref(r, p, v, st):
    'The twin of ``update_p``.'
    act = st.fl[ACT] != 0
    omega = _get_c(st, OMEGA)
    beta = _safe_div(_get_c(st, RHON) * _get_c(st, ALPHA),
                     _get_c(st, RHO) * omega)
    new = r + _bcast(beta, r) * (p - _bcast(omega, v) * v)
    p.copy_(torch.where(_bcast(act, p), new, p))


def dot_rv_ref(rhat, v, st):
    'The twin of ``dot_rv``.'
    act = st.fl[ACT] != 0
    re, im = _lane_sums(st, act, *_dot_terms(rhat, v))
    denom = torch.complex(re, im)
    rhon = _get_c(st, RHON)
    tiny = torch.finfo(st.sc.dtype).tiny
    _set_c(st, ALPHAN, _safe_div(rhon, denom), act)
    _set_flag(st, BAD, (torch.abs(rhon) < tiny) | (torch.abs(denom) < tiny),
              act)


def update_s_ref(r, v, s, st):
    'The twin of ``update_s``.'
    act = st.fl[ACT] != 0
    new = r - _bcast(_get_c(st, ALPHAN), v) * v
    s.copy_(torch.where(_bcast(act, s), new, s))


def dots_ts_ref(t, s, st):
    'The twin of ``dots_ts``.'
    act = st.fl[ACT] != 0
    tt, re, im = _lane_sums(st, act, _sq(t), *_dot_terms(t, s))
    _set_c(st, OMEGAN, _safe_div(torch.complex(re, im),
                                 torch.complex(tt, torch.zeros_like(tt))),
           act)


def update_xr_ref(rhat, x, r, s, t, phat, shat, st, maxiter):
    'The twin of ``update_xr``.'
    act = st.fl[ACT] != 0
    alpha, omega = _get_c(st, ALPHAN), _get_c(st, OMEGAN)
    xn = x + _bcast(alpha, phat) * phat + _bcast(omega, shat) * shat
    rn = s - _bcast(omega, t) * t
    f = _bcast(act, x)
    x.copy_(torch.where(f, xn, x))
    r.copy_(torch.where(f, rn, r))
    re, im, rr = _lane_sums(st, act, *_dot_terms(rhat, r), _sq(r))
    _set_c(st, RHO, _get_c(st, RHON), act)
    _set_c(st, ALPHA, alpha, act)
    _set_c(st, OMEGA, omega, act)
    _set_c(st, RHON, torch.complex(re, im), act)
    rnorm = torch.sqrt(rr)
    _set(st, RNORM, rnorm, act)
    k = st.fl[KIT] + 1
    down = (st.fl[BAD] != 0) | (torch.abs(omega)
                                < torch.finfo(st.sc.dtype).tiny)
    _set_flag(st, KIT, k, act)
    _set_flag(st, DOWN, down, act)
    _set_flag(st, ACT, (rnorm > st.sc[ATOL]) & (k < maxiter) & ~down, act)
