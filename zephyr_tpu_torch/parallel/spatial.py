'''
Spatial domain decomposition with halo exchange: the port of
``zephyr_tpu.parallel.spatial``.

The reference has NO spatial parallelism; its scaling axes are
frequency, source, and ky fan-out (SURVEY.md section 2.5). For grids
beyond one device's memory, the JAX package adds the missing axis: the
(nz, nx) grid is sharded across one or two mesh axes (x slabs or (z, x)
tiles), the 9-point stencil apply exchanges one-cell halos with its
neighbours, and the Krylov inner products are summed over the shards.

JAX's ``shard_map`` runs one program on every shard. The port holds a
grid as **one shard tensor per mesh coordinate**, a dict {coordinate:
tensor}, each on its coordinate's device, and loops over the shards in
one process (on a virtual mesh, ``['cuda:0'] * 4``, all on one card):

- a halo is a slice of the neighbour shard, copied with ``.to(device)``;
  at the global edges it is zero-filled (fields) or mirror-filled
  (coefficient planes); corners travel with the second exchange;
- the shard-local apply is the sum over the 9 offsets on the halo-grown
  block (JAX's body) on the CPU, and on the card K1
  (``ops.stencil.apply_stencil_batched``; K8 for 2x2 block planes) on
  the halo-grown block, whose planes are grown once by a zero ring;
- inner products are per-right-hand-side local sums, added over the
  shards in a fixed order on the first shard's device;
- the preconditioner is the FULL production hybrid stack built
  shard-locally: each shard runs ``prepare_operator`` and
  ``_make_precond`` on its own (optionally overlapped) slab, an additive
  (restricted additive) Schwarz preconditioner, so DD solves inherit
  every single-device preconditioner improvement; the global coupling is
  carried by the halo-exchanging matvec and the summed inner products of
  the outer BiCGStab.

The operator planes of ``make_dd_dpred`` are built for the whole grid on
the mesh's first device and then split, so set-up holds one grid's
planes on that device.
'''

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.kaiser import extract, pad_stamps
from ..ops.stencil import OFFSETS, apply_block_stencil_fast
from .mesh import Sharding


def _neighbour(coord, axis, i):
    c = list(coord)
    c[axis] = i
    return tuple(c)


def _exchange_axis(shards, mesh, axis_name, dim, width=1, edge='zero'):
    '''
    Exchange ``width``-cell halos along array dimension ``dim`` (-1 for x
    columns, -2 for z rows) across mesh axis ``axis_name``. Returns each
    shard grown by 2*width along ``dim``. At GLOBAL edges the halo is
    zero-filled (``edge='zero'``, the field/residual convention, which
    matches the stencil's zero extension) or mirror-filled with the
    shard's own edge strip (``edge='mirror'``, for operator coefficient
    planes in the overlapped-Schwarz slabs, where zero rows would become
    unit-diagonal rows INSIDE the slab and break the local multigrid's
    two-grid convergence, the failure ``multigrid._mask_ring_planes``
    documents).
    '''

    ax = mesh.axis_names.index(axis_name)
    n = mesh.devices.shape[ax]
    out = {}
    for coord, u in shards.items():
        d = u.dim() + dim
        i = coord[ax]
        own_lo = u.narrow(d, 0, width)
        own_hi = u.narrow(d, u.shape[d] - width, width)
        if i > 0:
            nb = shards[_neighbour(coord, ax, i - 1)]
            lo = nb.narrow(d, nb.shape[d] - width, width).to(u.device)
        else:
            lo = (own_lo.flip(d) if edge == 'mirror'
                  else torch.zeros_like(own_lo))
        if i < n - 1:
            hi = shards[_neighbour(coord, ax, i + 1)].narrow(
                d, 0, width).to(u.device)
        else:
            hi = (own_hi.flip(d) if edge == 'mirror'
                  else torch.zeros_like(own_hi))
        out[coord] = torch.cat([lo, u, hi], dim=d)
    return out


def halo_exchange_x(shards, mesh, axis_name):
    '''
    Exchange one-column halos with the left/right neighbour shards along
    ``axis_name``: each (..., nz, nx_local) shard -> (..., nz,
    nx_local + 2), zero-filled at the global edges.
    '''

    return _exchange_axis(shards, mesh, axis_name, -1)


def halo_exchange_2d(shards, mesh, axis_z, axis_x, width=1, edge='zero'):
    '''
    Two-axis halo exchange for (z, x)-tiled grids: x columns first, then
    z rows of the x-extended blocks, so the corner halos ride the second
    exchange. Returns the blocks grown by 2*width per axis.
    '''

    uh = _exchange_axis(shards, mesh, axis_x, -1, width, edge)
    return _exchange_axis(uh, mesh, axis_z, -2, width, edge)


def _extend_overlap(shards, mesh, axis_z, axis_x, width, edge='zero'):
    '''
    Grow each shard by ``width`` cells per side along the sharded grid
    axes: the overlapped slab of restricted additive Schwarz. Works for
    fields (..., nz, nx) and coefficient planes (B, B, 9, nz, nx) alike;
    ``edge`` controls the global-edge fill (see ``_exchange_axis``).
    '''

    if axis_z is None:
        return _exchange_axis(shards, mesh, axis_x, -1, width, edge)
    return halo_exchange_2d(shards, mesh, axis_z, axis_x, width, edge)


def _crop_overlap(a, axis_z, width):
    'Crop the owned (non-overlap) center of an overlapped-slab result.'

    out = a.narrow(-1, width, a.shape[-1] - 2 * width)
    if axis_z is not None:
        out = out.narrow(-2, width, a.shape[-2] - 2 * width)
    return out


def _halo(shards, mesh, axis_x, axis_z):
    'One-cell halos on every side (z zero-padded for x slabs).'

    if axis_z is None:
        uh = halo_exchange_x(shards, mesh, axis_x)
        return {c: torch.nn.functional.pad(u, (0, 0, 1, 1))
                for c, u in uh.items()}
    return halo_exchange_2d(shards, mesh, axis_z, axis_x)


def _apply_plain(planes, up):
    '''
    The JAX package's shard-local apply: the sum over the 9 offsets of
    ``planes`` (B, B, 9, nz, nx) times the shifted halo-grown block ``up``
    (..., B, nz + 2, nx + 2). Returns (..., B, nz, nx).
    '''

    B = planes.shape[0]
    nz, nx = planes.shape[-2:]
    rows = []
    for i in range(B):
        acc = None
        for j in range(B):
            for k, (dz, dx) in enumerate(OFFSETS):
                term = planes[i, j, k] * up[..., j, 1 + dz:1 + dz + nz,
                                            1 + dx:1 + dx + nx]
                acc = term if acc is None else acc + term
        rows.append(acc)
    return torch.stack(rows, dim=-3)


def _grow_planes(planes):
    'Planes grown by a zero ring: the kernel runs on the halo-grown block.'
    return torch.nn.functional.pad(planes, (1, 1, 1, 1)).contiguous()


def _apply_local(planes, grown, up):
    '''
    A shard's apply on its halo-grown block ``up`` (..., B, nz+2, nx+2):
    the plain sum on the CPU; on the card the kernel (K1 for B=1, K8 for
    B=2) with the zero-ring ``grown`` planes over the grown block, the
    result cropped to the owned (nz, nx).
    '''

    if up.device.type == 'cpu':
        return _apply_plain(planes, up)
    lead = up.shape[:-3]
    u4 = up.reshape((-1,) + tuple(up.shape[-3:]))
    out = apply_block_stencil_fast(grown, u4)
    return out[..., 1:-1, 1:-1].reshape(lead + out.shape[-3:-2]
                                        + planes.shape[-2:])


def apply_stencil_sharded(planes, u, mesh, axis_name=None, axis_z=None,
                          axis_x=None):
    '''
    The 9-point block-stencil apply on a spatially sharded grid, the JAX
    package's sum over the 9 offsets on the halo-grown blocks (on every
    device: the plain version). ``planes`` {coordinate: (B, B, 9, nz_l,
    nx_l)}, ``u`` {coordinate: (..., B, nz_l, nx_l)}; pass ``axis_name``
    (x slabs) or ``axis_x`` and optionally ``axis_z`` for 2D (z, x) tiles.
    Returns {coordinate: (..., B, nz_l, nx_l)}.
    '''

    axis_x = axis_x or axis_name
    up = _halo(u, mesh, axis_x, axis_z)
    return {c: _apply_plain(planes[c], up[c]) for c in u}


class _ShardedApply(object):
    '''
    A sharded operator: the shards' planes and, off the CPU, their
    zero-ring grown copies (made once), applied with halo exchange
    through ``_apply_local``.
    '''

    def __init__(self, planes, mesh, axis_x, axis_z):
        self.planes, self.mesh = planes, mesh
        self.axis_x, self.axis_z = axis_x, axis_z
        self.grown = {c: (None if p.device.type == 'cpu'
                          else _grow_planes(p)) for c, p in planes.items()}

    def __call__(self, u):
        up = _halo(u, self.mesh, self.axis_x, self.axis_z)
        return {c: _apply_local(self.planes[c], self.grown[c], up[c])
                for c in u}


def _grid_sharding(mesh, ndim, axis_x, axis_z):
    'The Sharding of an ndim-dimensional array whose last two axes are z, x.'
    return Sharding(mesh, (None,) * (ndim - 2) + (axis_z, axis_x))


def make_sharded_apply(mesh, axis_name='x', axis_z=None):
    '''
    Build (planes, u) -> A u over a grid sharded along ``axis_name`` (and
    optionally ``axis_z`` for 2D tiles): planes (B, B, 9, nz, nx) and u
    (..., B, nz, nx), numpy arrays or tensors, are split over the mesh,
    applied shard by shard (K1 on the card, the plain sum on the CPU) and
    gathered on the mesh's first device.
    '''

    def fn(planes, u):
        ps = _grid_sharding(mesh, planes.ndim, axis_name, axis_z)
        us = _grid_sharding(mesh, u.ndim, axis_name, axis_z)
        op = _ShardedApply(ps.split(planes), mesh, axis_name, axis_z)
        return us.gather(op(us.split(u)))

    return fn


def _gdot(a, b, coords, dev):
    '''
    Mesh-global per-RHS inner products <a, b> of (R, B, nz_l, nx_l)
    shards: local sums added over the shards in ``coords`` order on
    ``dev``. Returns (R,).
    '''

    total = None
    for c in coords:
        loc = torch.sum((a[c].conj() * b[c]).reshape(a[c].shape[0], -1),
                        dim=1).to(dev)
        total = loc if total is None else total + loc
    return total


def sharded_bicgstab(apply, b, M, mesh, tol=1e-6, maxiter=500):
    '''
    BiCGStab over the spatially sharded domain: ``apply`` exchanges halos,
    inner products are summed over the shards, and the preconditioner
    ``M`` acts shard-locally (additive Schwarz). ``b`` {coordinate: (R,
    B, nz_l, nx_l)}: all right-hand sides iterate in lockstep until the
    worst residual meets tol, a float or an (R,) tensor (the JAX
    package's loop, with its breakdown guards); one host sync an
    iteration. Returns (x {coordinate: shard},
    iterations, worst relres by the recursive residual).
    '''

    coords = [c for c in mesh.coords() if c in b]
    dev = b[coords[0]].device
    cdtype = b[coords[0]].dtype
    R = b[coords[0]].shape[0]

    def norm(a):
        return torch.sqrt(torch.abs(_gdot(a, a, coords, dev)).real)

    def bc(s, like):
        return s.to(like.device).reshape((-1,) + (1,) * (like.dim() - 1))

    bnorm = norm(b)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    atol = tol * bnorm
    tiny = torch.finfo(bnorm.dtype).tiny

    def safe_div(num, den):
        bad = torch.abs(den) < tiny
        return torch.where(bad, torch.zeros((), dtype=cdtype, device=dev),
                           num / torch.where(bad, torch.ones_like(den), den))

    x = {c: torch.zeros_like(b[c]) for c in coords}
    r = b                        # b - A x0 with x0 = 0
    rhat = r
    p = {c: torch.zeros_like(b[c]) for c in coords}
    v = {c: torch.zeros_like(b[c]) for c in coords}
    one = torch.ones(R, dtype=cdtype, device=dev)
    rho, alpha, omega = one, one, one
    down = torch.zeros(R, dtype=torch.bool, device=dev)
    k = 0
    while k < maxiter:
        active = (norm(r) > atol) & ~down
        if not bool(active.any()):      # the one host sync an iteration
            break
        rho_new = _gdot(rhat, r, coords, dev)
        beta = safe_div(rho_new * alpha, rho * omega)
        p = {c: r[c] + bc(beta, r[c]) * (p[c] - bc(omega, v[c]) * v[c])
             for c in coords}
        phat = M(p)
        v = apply(phat)
        denom = _gdot(rhat, v, coords, dev)
        alpha = safe_div(rho_new, denom)
        s = {c: r[c] - bc(alpha, v[c]) * v[c] for c in coords}
        shat = M(s)
        t = apply(shat)
        tt = _gdot(t, t, coords, dev)
        omega_new = safe_div(_gdot(t, s, coords, dev), tt)
        x = {c: x[c] + bc(alpha, phat[c]) * phat[c]
             + bc(omega_new, shat[c]) * shat[c] for c in coords}
        r = {c: s[c] - bc(omega_new, t[c]) * t[c] for c in coords}
        down = ((torch.abs(rho_new) < tiny) | (torch.abs(denom) < tiny)
                | (torch.abs(omega_new) < tiny))
        rho, omega = rho_new, omega_new
        k += 1
    return x, k, float(torch.max(norm(r) / bnorm))


def _closure_mask_1d(n_ext, i, n, overlap, dtype, device):
    '''
    The closure rows of shard ``i`` of ``n`` along one axis of an
    overlapped slab of ``n_ext`` cells: the mirror band and the global
    ring row at the global edges (0), everything else 1.
    '''
    m = torch.ones(n_ext, dtype=dtype, device=device)
    if i == 0:
        m[:overlap + 1] = 0
    if i == n - 1:
        m[n_ext - 1 - overlap:] = 0
    return m


def _local_hybrid_precond(planes, pplanes, cfg, mesh, axis_x=None,
                          axis_z=None, overlap=0):
    '''
    The FULL production preconditioner built on each shard's slab: each
    shard runs prepare_operator on its own planes (stratified/spectral
    interior solve + CSLP multigrid + exact coarse inverse), giving an
    additive-Schwarz hybrid. Returns the application M({coordinate:
    (R, B, nz_l, nx_l)}) -> {coordinate: ...}.

    With ``overlap`` > 0 this becomes restricted additive Schwarz (RAS):
    the slab (planes and, per application, the residual) is grown by
    ``overlap`` cells per sharded side via halo exchange, the local
    preconditioner acts on the extended slab, and only the owned center
    of the result is kept (the JAX package measured 159 -> 107 outer
    iterations at overlap 16 on a 2x2 mesh at 256^2 layered; overlap
    should be ~1 wavelength). Coefficient halos beyond the GLOBAL domain
    edge are mirror-filled; residual halos there stay zero, so the
    mirrored rows solve homogeneous equations whose garbage lives
    entirely in the cropped overlap band. Every row the slab treats as
    closure (the mirror band at global edges plus the true global
    Dirichlet ring row, which now sit INSIDE the slab) is kept out of the
    local coarse-grid correction by ``interior_mask``.

    On shards narrower than 4x the overlap the mirror band dominates the
    slab and RAS is measured harmful in the JAX package (96 wide, 8-way x
    slabs: overlap 12 stalls, overlap 3 diverges, overlap 0 converges), so
    such shards fall back to plain block Schwarz (overlap 0). ``cfg`` is
    passed to each shard unchanged, as in the JAX package: an automatic
    x-panel count (``strat_panels=0``) runs the global per-row solve
    inside every shard.
    '''

    from ..solver.helmholtz import prepare_operator, _make_precond

    coords = list(planes)
    nzl, nxl = planes[coords[0]].shape[-2:]
    extents = [nxl] + ([nzl] if axis_z is not None else [])
    if any(e < 4 * overlap for e in extents):
        overlap = 0
    planes = {c: p.detach() for c, p in planes.items()}
    pplanes = {c: p.detach() for c, p in pplanes.items()}
    masks = {c: None for c in coords}
    if overlap:
        planes = _extend_overlap(planes, mesh, axis_z, axis_x, overlap,
                                 edge='mirror')
        pplanes = _extend_overlap(pplanes, mesh, axis_z, axis_x, overlap,
                                  edge='mirror')
        ax = mesh.axis_names.index(axis_x)
        az = None if axis_z is None else mesh.axis_names.index(axis_z)
        for c in coords:
            p = planes[c]
            nzx, nxx = p.shape[-2:]
            rdtype = p.real.dtype
            mx = _closure_mask_1d(nxx, c[ax], mesh.devices.shape[ax],
                                  overlap, rdtype, p.device)
            mz = (torch.ones(nzx, dtype=rdtype, device=p.device)
                  if az is None else
                  _closure_mask_1d(nzx, c[az], mesh.devices.shape[az],
                                   overlap, rdtype, p.device))
            masks[c] = mz[:, None] * mx[None, :]
    M0 = {c: _make_precond(prepare_operator(planes[c], pplanes[c], cfg,
                                            with_transpose=False,
                                            interior_mask=masks[c]), cfg)
          for c in coords}
    if not overlap:
        return lambda r: {c: M0[c](r[c]) for c in r}

    def M(r):
        r_ext = _extend_overlap(r, mesh, axis_z, axis_x, overlap)
        return {c: _crop_overlap(M0[c](r_ext[c]), axis_z, overlap)
                for c in r}

    return M


#: true-residual restarts of a DD solve whose BiCGStab run stops short of
#: tol by the float32 drift of its recursive residual, and the margin of
#: a restart's target (``make_chunked_solver``'s)
DD_RESTARTS = 4
DD_MARGIN = 0.7


def _norms(a, coords, dev):
    'Per-RHS 2-norms of sharded (R, B, nz_l, nx_l) fields, (R,).'
    return torch.sqrt(torch.abs(_gdot(a, a, coords, dev)).real)


class DDOperator(object):
    '''
    A prepared domain-decomposed Helmholtz operator: the sharded apply
    and the shard-local hybrid preconditioner of ``planes`` and the
    preconditioner planes ``pplanes`` ({coordinate: (B, B, 9, nz_l,
    nx_l)}).
    '''

    def __init__(self, planes, pplanes, cfg, mesh, axis_x, axis_z, overlap):
        self.mesh = mesh
        self.cfg = cfg
        self.apply = _ShardedApply(planes, mesh, axis_x, axis_z)
        self.M = _local_hybrid_precond(planes, pplanes, cfg, mesh,
                                       axis_x=axis_x, axis_z=axis_z,
                                       overlap=overlap)

    def solve(self, b, tol=None, maxiter=None, restarts=DD_RESTARTS):
        '''
        Solve on sharded right-hand sides b {coordinate: (R, B, nz_l,
        nx_l)}: the JAX package's sharded BiCGStab to ``tol`` (default
        ``cfg.tol``; a float or an (R,) tensor), then the TRUE residual
        b - A x. While that misses tol (in float32 the recursive residual
        drifts from it: 9.74e-6 against 1.16e-5 on the CPU at 128^2
        layered, 2x2 tiles, complex64), BiCGStab restarts on it to ``DD_MARGIN`` tol,
        at most ``restarts`` times, within ``maxiter`` (default
        ``cfg.maxiter``) iterations in all, as ``make_chunked_solver``
        restarts; ``restarts=0`` is the JAX package's single run.
        Returns (x {coordinate: shard}, iterations, worst true relres; the
        JAX package returns the recursive one).
        '''
        cfg = self.cfg
        tol = cfg.tol if tol is None else tol
        maxiter = cfg.maxiter if maxiter is None else maxiter
        coords = [c for c in self.mesh.coords() if c in b]
        dev = b[coords[0]].device
        bnorm = _norms(b, coords, dev)
        bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
        x, iters, _ = sharded_bicgstab(self.apply, b, self.M, self.mesh,
                                       tol=tol, maxiter=maxiter)
        for restart in range(restarts + 1):
            ax = self.apply(x)
            r = {c: b[c] - ax[c] for c in coords}
            rnorm = _norms(r, coords, dev)
            worst = torch.max(rnorm / bnorm - tol)
            if (float(worst) <= 0 or restart == restarts
                    or iters >= maxiter):
                break
            tiny = torch.finfo(rnorm.dtype).tiny
            tol_r = DD_MARGIN * tol * bnorm / torch.clamp(rnorm, min=tiny)
            dx, k, _ = sharded_bicgstab(self.apply, r, self.M, self.mesh,
                                        tol=tol_r, maxiter=maxiter - iters)
            x = {c: x[c] + dx[c] for c in coords}
            iters += k
        return x, iters, float(torch.max(rnorm / bnorm))


def make_dd_solver(mesh, config=None, axis_name='x', axis_z=None,
                   overlap=16):
    '''
    Build a domain-decomposed Helmholtz solve:
        (planes, precond_planes, b) -> (x, iters, relres)
    with the grid sharded along ``axis_name`` (x slabs) and optionally
    ``axis_z`` ((z, x) tiles). The preconditioner is the restricted-
    additive-Schwarz hybrid stack built shard-locally on ``overlap``-
    extended slabs (overlap=0 recovers plain block Schwarz); the outer
    Krylov carries the global coupling. ``b`` may be (B, nz, nx) or
    batched (R, B, nz, nx); numpy arrays or tensors. Each call prepares
    the shards' operators, solves (``DDOperator.solve``: the JAX
    package's sharded BiCGStab, restarted on the true residual where
    float32 drift leaves it above tol), and returns x gathered on the
    mesh's first device, the iteration count and the worst true relres.
    '''

    from ..solver.helmholtz import SolverConfig

    cfg = config or SolverConfig()

    def solve(planes, pplanes, b):
        ps = _grid_sharding(mesh, 5, axis_name, axis_z)
        op = DDOperator(ps.split(planes), ps.split(pplanes), cfg, mesh,
                        axis_name, axis_z, overlap)
        bs = _grid_sharding(mesh, 4, axis_name, axis_z)
        b4 = b[None] if b.ndim == 3 else b
        x, iters, relres = op.solve(bs.split(b4))
        x = bs.gather(x)
        return (x[0] if b.ndim == 3 else x), iters, relres

    return solve


def _shard_receivers(R, coord, sharding, dev, dtype):
    '''
    The receivers ``R`` (nrec, nz, nx) inside one shard as padded stamps
    (cols, vals) (nrec, K) of the shard's flattened grid: its nonzeros,
    so the extraction is a gather and a sum, not a matmul.
    '''
    blk = R[sharding.block(R.shape, coord)]
    if isinstance(blk, torch.Tensor):
        blk = blk.detach().cpu().numpy()
    blk = np.asarray(blk).reshape(blk.shape[0], -1)
    rows, cols = np.nonzero(blk)
    cols, vals = pad_stamps(rows, cols, blk[rows, cols], blk.shape[0])
    return (torch.as_tensor(cols, device=dev),
            torch.as_tensor(vals, device=dev).to(dtype))


def make_dd_dpred(mesh, freqs, config=None, axis_name='x', axis_z=None,
                  Q=None, freqBase=0.0, overlap=16, **plane_kwargs):
    '''
    Production forward modelling over a spatially sharded grid:
        dpred(c, rho, q, R) -> (data (nfreq, nsrc, nrec), info)

    c, rho: (nz, nx) model fields; q: (nfreq, nsrc, nz, nx) source
    fields (their dtype is the working precision); R: (nrec, nz, nx)
    receiver extraction fields (the (nrec, nz*nx) matrix reshaped to the
    grid so it shards spatially). Per frequency the operator planes are
    built (``viscous_velocity``, MiniZephyr planes of the true and the
    CSLP-shifted velocity) on the mesh's first device and split, one DD
    solve runs over the source batch, and each shard extracts its
    receivers' share (summed over the shards). ``info`` holds each
    frequency's (iterations, relres). Differentiation is not supported
    here (use multifreq_dpred); reference semantics match survey.dpred
    (zephyr/middleware/survey.py:190-198). The data cube is a tensor on
    the mesh's first device.
    '''

    from ..ops.minizephyr_coeff import minizephyr_planes
    from ..solver.helmholtz import SolverConfig, shifted_velocity
    from .multifreq import (_complex_dtype, _field, _freq_list,
                            viscous_velocity)

    cfg = config or SolverConfig()
    if Q is None:
        Q = np.inf
    freqs = _freq_list(freqs)
    coords = mesh.coords()
    dev0 = resolve_device(mesh.device(coords[0]))

    def dpred(c, rho, q, R):
        cdtype = _complex_dtype(q)
        rdtype = torch.empty((), dtype=cdtype).real.dtype
        c = _field(c, dev0, cdtype)
        rho = _field(rho, dev0, rdtype)
        ps = _grid_sharding(mesh, 5, axis_name, axis_z)
        qs = _grid_sharding(mesh, 4, axis_name, axis_z)
        rs = _grid_sharding(mesh, 3, axis_name, axis_z)
        rx = {co: _shard_receivers(R, co, rs, mesh.device(co), cdtype)
              for co in coords}
        outs, info = [], []
        for i, freq in enumerate(freqs):
            ci = viscous_velocity(c, freq, Q, freqBase)
            planes = minizephyr_planes(ci, rho, freq,
                                       **plane_kwargs)[None, None]
            pplanes = minizephyr_planes(
                shifted_velocity(ci, cfg.shift), rho, freq,
                pml_cap=cfg.pml_cap, **plane_kwargs)[None, None]
            op = DDOperator(ps.split(planes), ps.split(pplanes), cfg, mesh,
                            axis_name, axis_z, overlap)
            del planes, pplanes
            b = qs.split(q[i][:, None], cdtype)   # (nsrc, 1, nz_l, nx_l)
            x, iters, relres = op.solve(b)
            parts = {co: extract(torch.conj(x[co][:, 0]), *rx[co])
                     for co in coords}
            outs.append(mesh.psum(parts).to(dev0))
            info.append((int(iters), float(relres)))
            del op, b, x
        return torch.stack(outs, dim=0), info

    return dpred
