"""Turbulence stirring: Ornstein-Uhlenbeck-driven Fourier forcing.

Counterpart of sphexa_tpu/physics/turbulence.py (reference: sph/include/
sph/hydro_turb/create_modes.hpp:59-177, driver.hpp:44-80 updateNoise,
phases.hpp computePhases, stirring.hpp:42 stirParticle):

  - the mode set (band or parabolic spectrum between stirMin and
    stirMax, with the 4-fold ky, kz sign multiplicity);
  - the OU phase evolution x' = f x + sigma sqrt(1 - f^2) z;
  - the solenoidal/compressive projection of the phases;
  - the per-particle stirring acceleration, a dense sum over the modes.

The OU state (phases and the RNG) lives on the host in numpy float64,
exactly as in the JAX package, so that a seeded run draws the same
phases bit for bit; it is checkpointable, and `restore` takes the JAX
package's `checkpoint_state()` dict as it is. Only the mode sum runs on
the device (`stir_accelerations`, plain PyTorch: the JAX package
computes it in XLA, with no Pallas kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def turbulence_constants() -> dict:
    """(reference: main/src/init/turbulence_init.hpp TurbulenceConstants)"""
    return dict(solWeight=0.5, stMaxModes=100000, Lbox=1.0,
                stEnergyPrefac=5.0e-3, stMachVelocity=0.3, minDt=1e-4,
                epsilon=1e-15, rngSeed=251299, stSpectForm=1, mTotal=1.0,
                powerLawExp=5.0 / 3.0, anglesExp=2.0, gamma=1.001, mui=0.62,
                u0=1000.0, kcour=0.4, gravConstant=0.0, ng0=100, ngmax=150)


def create_stirring_modes(Lbox: float, stir_min: float, stir_max: float,
                          spect_form: int = 1):
    """Full-sampling band (0) / parabolic (1) spectrum mode set with the
    4-fold (ky, kz sign) multiplicity. Returns (modes [M,3], amplitudes
    [M]), float64."""
    twopi = 2.0 * np.pi
    kc = stir_min if spect_form == 0 else 0.5 * (stir_min + stir_max)
    ikmax = int(stir_max * Lbox / twopi) + 1

    modes, amps = [], []
    parab_prefact = -4.0 / (stir_max - stir_min) ** 2
    for ikx in range(0, ikmax + 1):
        kx = twopi * ikx / Lbox
        for iky in range(0, ikmax + 1):
            ky = twopi * iky / Lbox
            for ikz in range(0, ikmax + 1):
                kz = twopi * ikz / Lbox
                k = np.sqrt(kx * kx + ky * ky + kz * kz)
                if not (stir_min <= k <= stir_max):
                    continue
                amplitude = 1.0
                if spect_form == 1:
                    amplitude = abs(parab_prefact * (k - kc) ** 2 + 1.0)
                amplitude = 2.0 * np.sqrt(amplitude) * (kc / k)  # ndim=3
                for sy, sz in ((1, 1), (-1, 1), (1, -1), (-1, -1)):
                    modes.append((kx, sy * ky, sz * kz))
                    amps.append(amplitude)
    return np.asarray(modes, np.float64), np.asarray(amps, np.float64)


@dataclasses.dataclass
class TurbulenceData:
    """Host-side stirring state (checkpointable; reference:
    hydro_turb/turbulence_data.hpp:47)."""
    modes: np.ndarray        # [M, 3]
    amplitudes: np.ndarray   # [M]
    phases: np.ndarray       # [M, 6] OU phases
    variance: float
    decay_time: float
    sol_weight: float
    sol_weight_norm: float
    rng: np.random.Generator

    @classmethod
    def create(cls, constants: dict | None = None, verbose: bool = False):
        c = dict(turbulence_constants(), **(constants or {}))
        twopi = 2.0 * np.pi
        Lbox = c["Lbox"]
        eps = c["epsilon"]
        velocity = c["stMachVelocity"]
        energy = c["stEnergyPrefac"] * velocity ** 3 / Lbox
        stir_min = (1.0 - eps) * twopi / Lbox
        stir_max = (3.0 + eps) * twopi / Lbox

        decay_time = Lbox / (2.0 * velocity)
        variance = np.sqrt(energy / decay_time)
        ndim = 3
        w = c["solWeight"]
        sol_norm = (np.sqrt(3.0) * np.sqrt(3.0 / ndim)
                    / np.sqrt(1.0 - 2.0 * w + ndim * w * w))

        modes, amps = create_stirring_modes(Lbox, stir_min, stir_max,
                                            int(c["stSpectForm"]))
        if verbose:
            print(f"turbulence: {len(modes)} stirring modes")
        rng = np.random.default_rng(int(c["rngSeed"]))
        return cls(modes=modes, amplitudes=amps,
                   phases=np.zeros((len(modes), 6)), variance=float(variance),
                   decay_time=float(decay_time), sol_weight=float(w),
                   sol_weight_norm=float(sol_norm), rng=rng)

    def update_noise(self, dt: float):
        """OU step (reference: driver.hpp updateNoise)."""
        damp_a = np.exp(-dt / self.decay_time)
        damp_b = np.sqrt(1.0 - damp_a * damp_a)
        z = self.rng.standard_normal(self.phases.shape)
        self.phases = self.phases * damp_a + self.variance * damp_b * z

    def projected_phases(self):
        """Solenoidal/compressive Helmholtz projection (reference:
        phases.hpp computePhases). Returns (real, imag) [M, 3] float32
        numpy arrays."""
        k = self.modes                          # [M, 3]
        ou = self.phases                        # [M, 6]
        ou_re = ou[:, 0::2]                     # [M, 3]
        ou_im = ou[:, 1::2]
        kk = np.sum(k * k, axis=1, keepdims=True)
        ka = np.sum(k * ou_im, axis=1, keepdims=True)
        kb = np.sum(k * ou_re, axis=1, keepdims=True)
        diva = k * ka / kk
        divb = k * kb / kk
        curla = ou_re - divb
        curlb = ou_im - diva
        w = self.sol_weight
        real = w * curla + (1.0 - w) * divb
        imag = w * curlb + (1.0 - w) * diva
        return real.astype(np.float32), imag.astype(np.float32)

    def checkpoint_state(self) -> dict:
        return dict(phases=self.phases.copy(),
                    rng_state=self.rng.bit_generator.state)

    def restore(self, ck: dict):
        """Install a checkpoint_state() dict (this package's or the JAX
        package's: both are numpy phases and a PCG64 state dict)."""
        self.phases = np.array(ck["phases"], dtype=np.float64)
        self.rng.bit_generator.state = ck["rng_state"]

    def device_phases(self, devices) -> list:
        """The projected phases of the current OU state as float32
        tensors, one (real, imag) pair on each device. CUDA copies come
        from pinned memory without waiting, so a caller that enqueues
        work behind them does not stall on the device."""
        pr, pi = self.projected_phases()
        out, made = [], {}
        for dev in devices:
            dev = torch.device(dev)
            if dev not in made:
                host = [torch.from_numpy(a) for a in (pr, pi)]
                if dev.type == "cuda":
                    host = [t.pin_memory() for t in host]
                made[dev] = tuple(t.to(dev, non_blocking=True)
                                  for t in host)
            out.append(made[dev])
        return out


class StirModes:
    """The device-side constants of the mode sum: the modes [M, 3] as
    float32, and per mode the amplitude times the solenoidal weight
    norm's share of each phase component, applied in stir()."""

    def __init__(self, turb: TurbulenceData, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.km = torch.as_tensor(turb.modes.astype(np.float32), **f32)
        self.amp = torch.as_tensor(turb.amplitudes.astype(np.float32), **f32)
        self.norm = float(turb.sol_weight_norm)

    def stir(self, x, y, z, phases_real, phases_imag, chunk: int = 65536):
        return stir_accelerations(x, y, z, self.km, phases_real, phases_imag,
                                  self.amp, self.norm, chunk=chunk)


def stir_accelerations(x, y, z, modes, phases_real, phases_imag, amplitudes,
                       sol_weight_norm: float, chunk: int = 65536):
    """Dense per-particle stirring acceleration (reference:
    stirring.hpp:42-78):

        a_i = solNorm * sum_m A_m (Re_m cos(k_m . x_i) - Im_m sin(k_m . x_i))

    with per-component phase vectors Re_m, Im_m [3]. The angle is formed
    as x kx + y ky + z kz in float32, as in the JAX package; the sum over
    the modes is two [C, M] x [M, 3] products per chunk of C rows (the
    JAX package sums the same terms elementwise: another order, within
    float32 rounding of the rows' scale). Returns (ax, ay, az)."""
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    km = torch.as_tensor(modes, **f32)            # [M, 3]
    amp = torch.as_tensor(amplitudes, **f32)      # [M]
    pr = torch.as_tensor(phases_real, **f32)      # [M, 3]
    pim = torch.as_tensor(phases_imag, **f32)
    a_re = amp[:, None] * pr
    a_im = amp[:, None] * pim
    n = x.shape[0]
    out = torch.empty((n, 3), **f32)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        ang = (x[c0:c1, None] * km[None, :, 0] + y[c0:c1, None] * km[None, :, 1]
               + z[c0:c1, None] * km[None, :, 2])       # [C, M]
        out[c0:c1] = (torch.mm(torch.cos(ang), a_re)
                      - torch.mm(torch.sin(ang), a_im))
    out *= float(np.float32(sol_weight_norm))
    return out[:, 0], out[:, 1], out[:, 2]
