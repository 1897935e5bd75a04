'''
A Marmousi-class velocity model (after the bench model of zephyr_tpu's
bench.py): folded, dipping thin beds with a lateral trend, three fault
offsets, a low-velocity lens, band-limited 1/k roughness, and a water
layer on top, floored at v_min. The bed table comes from
``structure_seed`` and the roughness from ``seed``: both are the
configuration's, so the medium is the same in every run.
'''

import numpy as np


def roughness(rng, nz, nx, hi=1.0 / 16.0):
    '''Unit-rms band-limited 1/k noise (wavenumbers 2/nz .. hi a cell).'''
    w = rng.standard_normal((nz, nx))
    k = np.hypot(np.fft.fftfreq(nz)[:, None], np.fft.rfftfreq(nx)[None, :])
    lo = 2.0 / nz
    filt = np.where((k >= lo) & (k <= hi), 1.0 / np.maximum(k, lo), 0.0)
    r = np.fft.irfft2(np.fft.rfft2(w) * filt, s=(nz, nx))
    return r / max(r.std(), 1e-30)


def make(nz, nx, spacing_m, seed, structure_seed=42, nbeds=24,
         v_top=1500.0, v_span=2200.0, bed_jitter=220.0, lens_dv=300.0,
         rough_rms=120.0, water_m=32.0, v_water=1500.0, v_min=1400.0):
    z = np.linspace(0.0, 1.0, nz)[:, None]
    x = np.linspace(0.0, 1.0, nx)[None, :]
    horizon = z + 0.15 * x + 0.05 * np.sin(6.0 * np.pi * x) * (0.3 + z)
    for fx, dzo in ((0.3, 0.06), (0.55, -0.08), (0.8, 0.05)):
        horizon = horizon + dzo * (x > fx)
    idx = np.clip(np.floor(horizon * nbeds).astype(int), 0, nbeds + 4)
    srng = np.random.default_rng(structure_seed)
    vels = (v_top + v_span * np.arange(nbeds + 5) / (nbeds + 4)
            + srng.uniform(-bed_jitter, bed_jitter, nbeds + 5))
    vels = np.maximum.accumulate(vels)
    c = vels[idx]
    c = c - lens_dv * np.exp(-((z - 0.45) ** 2 + (x - 0.5) ** 2) / 0.01)
    c = c + rough_rms * roughness(np.random.default_rng(seed), nz, nx)
    c = np.maximum(c, v_min)
    c[:int(round(water_m / spacing_m))] = v_water
    return c.astype(np.float32)
