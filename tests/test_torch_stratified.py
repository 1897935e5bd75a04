'''
Port parity: the stratified PCR interior solve of zephyr_tpu_torch
against zephyr_tpu.

- complex128: stratified coefficients, precomputed PCR factors and the
  apply at rel 1e-12 (rounding of the same recurrence);
- complex64: the bf16 re/im factors are bit-identical to the JAX
  package's (round to nearest even, and the same zero signs), and the
  bf16 sweep (the twin of K3) agrees with the JAX package's
  ``_pcr_sweep_bf16_jnp`` path at rel 1e-5 (float32 rounding);
- the x-panel family (layout, weights, per-panel coefficients with the
  'auto' and a fixed shift, ``dst``, the apply for every taper, forward
  and transposed) at rel 1e-12 (layout and weights exactly);
- the DFT-matmul x-transform: against the FFT path at rel 1e-12, and its
  matrices against ``torch.fft`` in complex64 at 2048 to 1e-5, where the
  JAX package's miss by ~1e-3 (fault F2, not inherited);
- K3's packed factor layout, which unpacks to the bf16 planes (and so to
  the JAX package's) bit for bit, and K3's launch plans (exact values at
  the main path's depths, limits over every depth it takes).
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zephyr_tpu.ops.minizephyr_coeff import minizephyr_planes as jplanes
from zephyr_tpu.solver import multigrid as jmg
from zephyr_tpu.solver import stratified as jsr
from zephyr_tpu.solver.helmholtz import shifted_velocity as jshift
from zephyr_tpu_torch.convert import tensor_from_numpy
from zephyr_tpu_torch.solver import stratified as tsr

NZ, NX, FREQ = 48, 40, 150.


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _coarse_pair(layered, lateral=False):
    '''
    Galerkin-coarsened true and shifted planes (the fused cycle input);
    ``lateral`` adds a velocity step in x (a laterally heterogeneous
    medium, the panel family's case).
    '''
    c = np.full((NZ, NX), 1500. + 0j)
    if layered:
        c[NZ // 2:] = 2400.
    if lateral:
        c[:, NX // 2:] *= 1.4
    c = jnp.asarray(c)
    rho = jnp.ones((NZ, NX))
    tp = jplanes(c, rho, FREQ)[None, None]
    pp = jplanes(jshift(c, 0.5j), rho, FREQ, pml_cap=1.0)[None, None]
    mask = jmg._ring_mask(NZ, NX, jnp.float64)
    co = lambda p: jmg._fix_empty_rows(jmg.galerkin_coarsen(
        jmg._mask_ring_planes(p, mask)))
    return np.array(co(tp)), np.array(co(pp))


@pytest.mark.parametrize('layered', [False, True])
@pytest.mark.parametrize('fft_shift', ['auto', 0.25j])
def test_stratified_coeffs_parity(layered, fft_shift):
    ct, cp = _coarse_pair(layered)
    ldu_j = jsr.stratified_coeffs(jnp.asarray(ct), jnp.asarray(cp), 0.5j,
                                  fft_shift)
    ldu_t = tsr.stratified_coeffs(torch.from_numpy(ct),
                                  torch.from_numpy(cp), 0.5j, fft_shift)
    for a_t, a_j in zip(ldu_t, ldu_j):
        assert _rel(a_t, a_j) < 1e-12


def _ldu(layered=True):
    ct, cp = _coarse_pair(layered)
    return [np.array(a) for a in jsr.stratified_coeffs(
        jnp.asarray(ct), jnp.asarray(cp), 0.5j, 'auto')]


def test_pcr_precompute_and_apply_complex128():
    l, d, u = _ldu()
    p_j = jsr.pcr_precompute(*map(jnp.asarray, (l, d, u)))
    p_t = tsr.pcr_precompute(*map(torch.from_numpy, (l, d, u)))
    assert p_t.alphas.dtype == torch.complex128
    for name in ('alphas', 'gammas', 'dinv', 'ldu'):
        assert _rel(getattr(p_t, name), getattr(p_j, name)) < 1e-12
    rng = np.random.default_rng(4)
    r = rng.standard_normal((3, 1) + l.shape) \
        + 1j * rng.standard_normal((3, 1) + l.shape)
    x_j = jax.vmap(lambda rr: jsr.stratified_apply(p_j, rr))(jnp.asarray(r))
    x_t = tsr.stratified_apply(p_t, torch.from_numpy(r))
    assert _rel(x_t, x_j) < 1e-12
    # PCR exactness: T x = b per column (the reduction is a direct solve)
    b = torch.from_numpy(r[:, 0])
    x = tsr.tridiag_pcr_solve(*map(torch.from_numpy, (l, d, u)), b)
    Tx = (torch.from_numpy(l) * tsr._shift_z(x, -1)
          + torch.from_numpy(d) * x + torch.from_numpy(u)
          * tsr._shift_z(x, +1))
    assert _rel(Tx, b) < 1e-10


def _bits(t):
    'uint16 bit patterns of a bf16 tensor or an ml_dtypes bf16 array.'
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def test_bf16_factors_bit_identical_complex64():
    l, d, u = [a.astype(np.complex64) for a in _ldu()]
    p_j = jsr.pcr_precompute(*map(jnp.asarray, (l, d, u)))
    p_t = tsr.pcr_precompute(*map(torch.from_numpy, (l, d, u)))
    assert p_t.alphas.dtype == torch.bfloat16
    assert p_t.alphas.shape == (5, 2, NZ // 2, NX // 2)
    for name in ('alphas', 'gammas', 'dinv'):
        assert np.array_equal(_bits(getattr(p_t, name)),
                              _bits(getattr(p_j, name))), name
    # the converter carries bf16 leaves bit for bit
    assert np.array_equal(_bits(tensor_from_numpy(np.asarray(p_j.alphas),
                                             device='cpu')),
                          _bits(p_j.alphas))


def test_bf16_pack_rounds_to_nearest_even():
    'Exact ties between two bf16 values round to the even one, as in JAX.'
    base = np.array([1.0, 1.5, -3.0, 2.0 ** -20, 7.0], np.float32)
    ulp = base * 2.0 ** -8                  # one bf16 ulp at each value
    vals = np.concatenate([base + ulp / 2, base + 1.5 * ulp,
                           base + ulp / 3, base - ulp / 2]).astype(
                               np.float32)
    x = (vals + 1j * vals[::-1]).astype(np.complex64)
    b_j = _bits(jsr._pack_bf16(jnp.asarray(x)))
    b_t = _bits(tsr._pack_bf16(torch.from_numpy(x)))
    assert np.array_equal(b_t, b_j)


def test_bf16_sweep_complex64_matches_jax():
    'The K3 twin against the JAX reference sweep, complex64.'
    l, d, u = [a.astype(np.complex64) for a in _ldu()]
    p_j = jsr.pcr_precompute(*map(jnp.asarray, (l, d, u)))
    p_t = tsr.pcr_precompute(*map(torch.from_numpy, (l, d, u)))
    rng = np.random.default_rng(5)
    b = (rng.standard_normal((4,) + l.shape)
         + 1j * rng.standard_normal((4,) + l.shape)).astype(np.complex64)
    x_j = jsr._pcr_sweep_bf16_jnp(p_j.alphas, p_j.gammas, p_j.dinv,
                                  jnp.asarray(b))
    x_t = tsr.pcr_sweep_batched(p_t.alphas, p_t.gammas, p_t.dinv,
                                torch.from_numpy(b))
    assert x_t.dtype == torch.complex64
    assert _rel(x_t, x_j) < 1e-5
    # and the whole apply, through the fft (rel 1e-5, float32 rounding)
    r = b[:, None]
    y_j = jax.vmap(lambda rr: jsr.stratified_apply(p_j, rr))(jnp.asarray(r))
    y_t = tsr.stratified_apply(p_t, torch.from_numpy(r))
    assert _rel(y_t, y_j) < 1e-5


PANEL_LAYOUTS = [(20, 2, 4), (20, 3, 2), (40, 4, 4), (37, 3, 16), (5, 4, 3),
                 (1536, 8, 32)]


def test_panel_layout_and_weights_match_jax():
    for nx, P, ov in PANEL_LAYOUTS:
        assert tsr.panel_layout(nx, P, ov) == jsr.panel_layout(nx, P, ov)
        w_t = tsr.panel_weights(nx, P, ov)
        assert w_t.dtype == np.float32
        assert np.array_equal(w_t, jsr.panel_weights(nx, P, ov))
    assert tsr.panel_layout(1024, 8, 32)[1] == 192


def _panel_pair():
    ct, cp = _coarse_pair(True, lateral=True)
    return ct, cp, jnp.asarray(ct), jnp.asarray(cp)


@pytest.mark.parametrize('npanels', [2, 3])
@pytest.mark.parametrize('fft_shift', ['auto', 0.25j])
@pytest.mark.parametrize('dst', [False, True])
def test_stratified_coeffs_panels_parity(npanels, fft_shift, dst):
    ct, cp, jct, jcp = _panel_pair()
    ldu_j = jsr.stratified_coeffs_panels(jct, jcp, 0.5j, fft_shift,
                                         npanels, 4, dst=dst)
    ldu_t = tsr.stratified_coeffs_panels(torch.from_numpy(ct),
                                         torch.from_numpy(cp), 0.5j,
                                         fft_shift, npanels, 4, dst=dst)
    W = tsr.panel_layout(NX // 2, npanels, 4)[1]
    for a_t, a_j in zip(ldu_t, ldu_j):
        assert a_t.shape == (NZ // 2, npanels * W * (2 if dst else 1))
        assert _rel(a_t, a_j) < 1e-12


@pytest.mark.parametrize('taper', ['in', 'out', 'sym', 'dst'])
def test_stratified_apply_panels_parity(taper):
    '''
    Forward (precomputed factors) and transposed (the port's transposed
    family reduced once by ``transpose_pcr``; the JAX package reduces it
    on the fly) applications of each taper, P = 3.
    '''
    ct, cp, jct, jcp = _panel_pair()
    ldu = [np.array(a) for a in jsr.stratified_coeffs_panels(
        jct, jcp, 0.5j, 'auto', 3, 4, dst=taper == 'dst')]
    p_j = jsr.pcr_precompute(*map(jnp.asarray, ldu))
    p_t = tsr.pcr_precompute(*map(torch.from_numpy, ldu))
    rng = np.random.default_rng(6)
    r = (rng.standard_normal((2, 1, NZ // 2, NX // 2))
         + 1j * rng.standard_normal((2, 1, NZ // 2, NX // 2)))
    for transpose in (False, True):
        x_j = jax.vmap(lambda rr: jsr.stratified_apply_panels(
            p_j, rr, 3, 4, transpose=transpose, taper=taper))(
                jnp.asarray(r))
        strat = tsr.transpose_pcr(p_t) if transpose else p_t
        x_t = tsr.stratified_apply_panels(strat, torch.from_numpy(r), 3, 4,
                                          transpose=transpose, taper=taper)
        assert x_t.shape == r.shape
        assert _rel(x_t, x_j) < 1e-12


def test_dft_path_matches_fft_path():
    '''
    The DFT-matmul x-transform (StratPCR.dft) against the FFT path of the
    port and against the JAX package's DFT path, for the global family
    (forward and transposed) and the panel family.
    '''
    rng = np.random.default_rng(7)
    r = (rng.standard_normal((2, 1, NZ // 2, NX // 2))
         + 1j * rng.standard_normal((2, 1, NZ // 2, NX // 2)))
    rt = torch.from_numpy(r)
    l, d, u = _ldu()
    fft = tsr.pcr_precompute(*map(torch.from_numpy, (l, d, u)))
    dft = tsr.pcr_precompute(*map(torch.from_numpy, (l, d, u)), dft=True)
    assert dft.dft[0].shape == (NX // 2, NX // 2)
    p_j = jsr.pcr_precompute(*map(jnp.asarray, (l, d, u)), dft=True)
    x_j = jax.vmap(lambda rr: jsr.stratified_apply(p_j, rr))(jnp.asarray(r))
    x_t = tsr.stratified_apply(dft, rt)
    assert _rel(x_t, tsr.stratified_apply(fft, rt)) < 1e-12
    assert _rel(x_t, x_j) < 1e-12
    for s in (fft, dft):
        assert _rel(tsr.stratified_apply(tsr.transpose_pcr(s), rt,
                                         transpose=True),
                    jax.vmap(lambda rr: jsr.stratified_apply(
                        p_j, rr, transpose=True))(jnp.asarray(r))) < 1e-12
    _, _, jct, jcp = _panel_pair()
    ldu = [np.array(a) for a in jsr.stratified_coeffs_panels(
        jct, jcp, 0.5j, 'auto', 2, 4)]
    W = tsr.panel_layout(NX // 2, 2, 4)[1]
    pf = tsr.pcr_precompute(*map(torch.from_numpy, ldu))
    pd = tsr.pcr_precompute(*map(torch.from_numpy, ldu), dft=W)
    for transpose in (False, True):
        f, g = ((tsr.transpose_pcr(pf), tsr.transpose_pcr(pd)) if transpose
                else (pf, pd))
        assert _rel(tsr.stratified_apply_panels(g, rt, 2, 4, transpose,
                                                'in'),
                    tsr.stratified_apply_panels(f, rt, 2, 4, transpose,
                                                'in')) < 1e-12


def test_dft_mats_reduce_the_phase_mod_w():
    '''
    Fault F2: at w = 2048 in complex64 the port's DFT matrix is the
    transform to f32 rounding; the JAX package's (unreduced phase formed
    in f32) is ~1e-3 off.
    '''
    w = 2048
    exact = torch.fft.fft(torch.eye(w, dtype=torch.complex128), dim=-1)
    F, Fi = tsr.dft_mats(w)
    assert F.dtype == torch.complex64
    assert float((F - exact).abs().max()) < 1e-5
    assert float((Fi - torch.fft.ifft(torch.eye(w, dtype=torch.complex128),
                                      dim=-1)).abs().max()) < 1e-5 / w
    F_j = np.asarray(jsr.dft_mats(w, jnp.complex64)[0])
    assert float(np.abs(F_j - exact.numpy()).max()) > 1e-4


def _packed_case(family):
    '''
    (port StratPCR, JAX bf16 planes or None) of a complex64 family: the
    global one, the 8-panel one, a JAX state carried by the converter,
    and an odd depth.
    '''
    if family == 'global':
        l, d, u = [a.astype(np.complex64) for a in _ldu()]
        return (tsr.pcr_precompute(*map(torch.from_numpy, (l, d, u))),
                jsr.pcr_precompute(*map(jnp.asarray, (l, d, u))))
    if family == 'panels8':
        ct, cp, jct, jcp = _panel_pair()
        ldu = [np.array(a).astype(np.complex64)
               for a in jsr.stratified_coeffs_panels(jct, jcp, 0.5j, 'auto',
                                                     8, 2)]
        return (tsr.pcr_precompute(*map(torch.from_numpy, ldu)),
                jsr.pcr_precompute(*map(jnp.asarray, ldu)))
    if family == 'converted':
        from zephyr_tpu_torch.convert import operator_from_numpy
        from zephyr_tpu.solver import helmholtz as jh
        cfg = jh.SolverConfig(fft_mode='strat', fft_scale=2,
                              hybrid_comp='fused', mg_min_size=8)
        c = jnp.asarray(np.full((NZ, NX), 1500. + 0j))
        rho = jnp.ones((NZ, NX))
        p = jplanes(c, rho, FREQ)[None, None]
        pp = jplanes(jshift(c, 0.5j), rho, FREQ, pml_cap=1.0)[None, None]
        op = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.complex64) if jnp.iscomplexobj(a) else a,
            jh.prepare_operator(p, pp, cfg, with_transpose=False))
        op = op._replace(strat=jsr.pcr_precompute(*op.strat.ldu))
        t = operator_from_numpy(jax.tree_util.tree_map(np.asarray, op),
                                device='cpu')
        return t.strat, op.strat
    rng = np.random.default_rng(8)                      # 'odd'
    l, d, u = ((rng.standard_normal((37, 29)) + 1j * rng.standard_normal(
        (37, 29))).astype(np.complex64) for _ in range(3))
    return tsr.pcr_precompute(*map(torch.from_numpy, (l, d + 4, u))), None


@pytest.mark.parametrize('family', ['global', 'panels8', 'converted', 'odd'])
def test_packed_factors_unpack_to_planes(family):
    '''
    K3's packed factor layout (built once per prepared operator) holds
    the (nsteps, 2, nz, nx) bf16 planes bit for bit: plain torch unpacks
    it to the planes, which are the JAX package's.
    '''
    p_t, p_j = _packed_case(family)
    nsteps, _, nz, nx = p_t.alphas.shape
    assert p_t.packed.dtype == torch.bfloat16
    assert p_t.packed.shape == (nsteps + 1, nx, nz, 4)
    assert p_t.packed.is_contiguous()
    for name, plane in zip(('alphas', 'gammas', 'dinv'),
                           tsr.unpack_pcr_factors(p_t.packed)):
        assert np.array_equal(_bits(plane), _bits(getattr(p_t, name))), name
        if p_j is not None:
            assert np.array_equal(_bits(plane), _bits(getattr(p_j, name)))
    # the fourth part of the dinv level is zero, and one word per point
    assert not p_t.packed[-1, ..., 2:].view(torch.int16).any()
    if family == 'panels8':
        assert nx == 8 * tsr.panel_layout(NX // 2, 8, 2)[1]


def test_pcr_packed_only_for_bf16_and_needed_on_the_card():
    l, d, u = (torch.from_numpy(a) for a in _ldu())
    assert tsr.pcr_precompute(l, d, u).packed is None          # complex128
    assert tsr.transpose_pcr(tsr.pcr_precompute(
        l.to(torch.complex64), d.to(torch.complex64),
        u.to(torch.complex64))).packed is None
    p = tsr.pcr_precompute(l.to(torch.complex64), d.to(torch.complex64),
                           u.to(torch.complex64))
    b = torch.ones((2,) + tuple(l.shape), dtype=torch.complex64)
    # on the CPU the twin runs on the planes, with or without the layout
    assert torch.equal(tsr.pcr_apply(p, b),
                       tsr._pcr_sweep_bf16_ref(p.alphas, p.gammas, p.dinv,
                                               b))


@pytest.mark.parametrize('nz,R,plan', [
    (1024, 16, (16, 2, 2, 4)),      # the production half grid
    (2048, 16, (16, 2, 4, 4)),      # the default config, full resolution
    (1024, 1, (16, 1, 2, 4)),
    (512, 3, (16, 2, 1, 4)),
    (256, 17, (8, 4, 1, 4)),
    (1, 1, (1, 1, 1, 4)),
    (33, 3, (2, 2, 1, 4)),
    (4096, 16, (16, 2, 8, 2)),
    (12800, 16, (16, 1, 25, 1)),
])
def test_k3_plan(nz, R, plan):
    '''
    K3's launch plan (slots a lane, RHS a thread, warps a column, columns
    a block) at the main path's depths and at the edges.
    '''
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    assert ck._pcr_plan(nz, R) == plan


def test_k3_plan_limits():
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    for nz in list(range(1, 2100)) + list(range(2100, ck.PCR_MAX_NZ + 1, 97)):
        for R in (1, 2, 3, 16):
            k, g, w, cb = ck._pcr_plan(nz, R)
            threads, nzp = 32 * w * cb, 32 * k * w
            assert nzp >= nz > nzp - 32 * k            # less than a slab pad
            assert w == 1 or k == 16
            assert 1 <= g <= max(1, min(R, 4)) and g in (1, 2, 4)
            assert threads <= (1024 if (k, g) == (16, 1) else 512)
            assert cb * g * nzp * 8 <= ck.PCR_SMEM_BUDGET
            assert 2 * g * k <= 64                      # state registers
    for nz in (0, ck.PCR_MAX_NZ + 1):
        with pytest.raises(ValueError):
            ck._pcr_plan(nz, 1)
    assert [ck._pcr_levels(n) for n in (1, 2, 3, 4, 5, 1024, 1025)] == \
        [0, 1, 2, 2, 3, 10, 11]
