"""Engine-sound synthesizer (HelloEngineSynth capability).

The JAX re-expression of the reference's SDL audio engine synth
(hello-other-exps/hello_engine_synth.cpp): a "W16" engine voice built from

- a firing-order fundamental f0 = rpm/60 * cylinders/2 * 0.5 with
  per-sample jitter (:211-216),
- a 24-harmonic stack whose weights depend on engine load through a
  load-bin table (brightness/exponent ramp, :159-182),
- throttle-colored one-pole low-passed noise + its high-passed "hiss"
  (:228-239),
- gear-shift "crack + thump" bursts (crack/crack*1.55/hp/thump mix,
  :241-257) and a starter-motor whine crossfaded out in the first
  second (:200-207, :262-266),
- softclip drive and a load-tracking output low-pass (:268-273).

Re-design, not a port: the reference computes one sample per audio
callback step with mutable filter state; here the whole voice is a
`lax.scan` over samples (phase accumulators, the three parameter
smoothers, the two one-pole filters and prevNoise are the carry), with
the white-noise stream drawn vectorized from the JAX PRNG outside the
scan and the 24-harmonic stack evaluated as one vectorized sum per
sample.  The load-bin harmonic table is a re-tuned variant of the
reference's harmW (:159-182; see harmonic_table for the deliberate
differences).  The FFT spectrum view (fft_radix2 +
draw_wave, :298-340) maps to jnp.fft.rfft + a rendered PNG.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

H_HARMONICS = 24
LOAD_BINS = 8


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rpm", "throttle", "load", "torque_mul", "shift_burst"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class EngineControls:
    """Per-sample control tracks (any common shape (N,))."""
    rpm: jnp.ndarray
    throttle: jnp.ndarray
    load: jnp.ndarray
    torque_mul: jnp.ndarray
    shift_burst: jnp.ndarray


def harmonic_table(h: int = H_HARMONICS, bins: int = LOAD_BINS):
    """Load-binned harmonic weights — a RE-TUNED variant of the reference's
    harmW table (hello_engine_synth.cpp:159-182), not an exact match: same
    structure (brightness rises with load, rolloff exponent falls, rows
    normalized to unit sum) but 24 harmonics x 8 bins instead of 8 x 32,
    no k>=5/k>=7 damping factors, and an added odd-harmonic boost
    (1 + 0.35*bright) for a richer voice on the wider stack."""
    k = np.arange(1, h + 1, dtype=np.float32)
    rows = []
    for b in range(bins):
        load = b / float(bins - 1)
        bright = 0.18 + 0.70 * load
        expo = 1.25 + 2.60 * (1.0 - bright)
        w = 1.0 / np.power(k, expo)
        w *= np.where(k % 2 == 1, 1.0 + 0.35 * bright, 1.0)
        rows.append(w / w.sum())
    return jnp.asarray(np.stack(rows), jnp.float32)


def _wrap01(x):
    return x - jnp.floor(x)


def _softclip(x, a=1.5):
    return jnp.tanh(a * x) / np.tanh(a)


@partial(jax.jit, static_argnames=("sample_rate", "cylinders"))
def synthesize(controls: EngineControls, noise, sample_rate: int = 48000,
               cylinders: int = 16):
    """Render the engine voice for N samples.  noise: (N,) uniform [-1,1].

    Returns (N,) float32 in [-1, 1].  One lax.scan carries every piece of
    state the reference mutates per sample (EngineSynth::step :184-273)."""
    harm = harmonic_table()
    dt = 1.0 / float(sample_rate)
    ks = jnp.arange(1, H_HARMONICS + 1, dtype=jnp.float32)
    t = jnp.arange(noise.shape[0], dtype=jnp.float32) * dt

    xs = (controls.rpm, controls.throttle, controls.load,
          controls.torque_mul, controls.shift_burst, noise, t)

    def step(carry, x):
        (phase, crack_ph, thump_ph, starter_ph,
         rpm_s, thr_s, load_s, lp_y, prev_n, main_y) = carry
        rpm_in, thr_in, load_in, tmul_in, burst_in, n, tnow = x

        # Parameter smoothers (Smooth a=0.02, :98-102).
        rpm_s = rpm_s + 0.02 * (rpm_in - rpm_s)
        thr_s = jnp.clip(thr_s + 0.02 * (thr_in - thr_s), 0.0, 1.0)
        load_s = jnp.clip(load_s + 0.02 * (load_in - load_s), 0.0, 1.0)
        tmul = jnp.clip(tmul_in, 0.0, 1.15)
        burst = jnp.clip(burst_in, 0.0, 1.0)

        # Starter whine + catch envelope for the first second (:200-207).
        u_st = tnow / 0.55
        wh = 160.0 + 120.0 * u_st
        starter_ph = _wrap01(starter_ph + wh * dt)
        starter = jnp.where(
            tnow < 0.55,
            0.13 * (1.0 - 0.35 * u_st) * jnp.sin(2 * jnp.pi * starter_ph),
            0.0)
        # Deliberate fix of a reference quirk: the C++ computes catchEnv
        # only for t in [0.45, 0.85), so [0.85, 1.0) collapses to the
        # (already silent) starter; clamping catch to 1 past 0.85 keeps
        # the voice continuous instead of reproducing the mute gap.
        catch = jnp.clip((tnow - 0.45) / 0.40, 0.0, 1.0)

        # Firing fundamental with load-scaled jitter (:211-216).
        f0 = (rpm_s / 60.0) * (0.5 * cylinders) * 0.5
        f0 = f0 * (1.0 + (0.0010 + 0.0025 * load_s) * n)
        phase = _wrap01(phase + f0 * dt)

        # Load-binned harmonic stack (:218-226).
        bin_i = jnp.clip(jnp.round(load_s * (LOAD_BINS - 1)), 0,
                         LOAD_BINS - 1).astype(jnp.int32)
        w = harm[bin_i]
        base = jnp.sum(w * jnp.sin(2 * jnp.pi * _wrap01(phase * ks)))

        # Colored noise: one-pole LP + first-difference HP (:228-235).
        lp_a = 0.025 + 0.14 * thr_s
        lp_y = lp_y + lp_a * (n - lp_y)
        hp = lp_y - prev_n
        prev_n = lp_y

        rpm_norm = jnp.minimum(rpm_s / 7000.0, 1.0)
        drive = 0.24 + 0.76 * jnp.clip(tmul, 0.0, 1.0)
        hiss = (0.006 + 0.040 * thr_s) * (0.25 + 0.75 * rpm_norm)

        # Shift crack + thump burst voices (:241-257).
        crack_hz = 900.0 + 550.0 * thr_s + 350.0 * rpm_norm
        crack_ph = _wrap01(crack_ph + crack_hz * dt)
        crack_tone = jnp.sin(2 * jnp.pi * crack_ph)
        crack_tone2 = jnp.sin(2 * jnp.pi * _wrap01(crack_ph * 1.55))
        thump_hz = 90.0 + 40.0 * thr_s + 20.0 * rpm_norm
        thump_ph = _wrap01(thump_ph + thump_hz * dt)
        thump = jnp.sin(2 * jnp.pi * thump_ph)
        crack = burst * (0.060 * crack_tone + 0.030 * crack_tone2
                         + 0.030 * hp + 0.085 * thump)

        amp = (0.050 + 0.30 * load_s + 0.15 * thr_s
               + 0.07 * rpm_norm) * drive
        noise_gain = (hiss + 0.020 * thr_s * (0.3 + 0.7 * load_s)) * drive
        x_out = amp * base + noise_gain * lp_y + crack

        # Starter crossfade (:262-266).
        x_out = jnp.where(tnow < 1.0,
                          (1.0 - catch) * starter + catch * x_out, x_out)

        # Drive + softclip + output LP (:268-273).
        grit = 0.62 + 1.05 * load_s
        x_out = _softclip(x_out * grit)
        main_a = 0.022 + 0.28 * (0.25 + 0.75 * load_s)
        main_y = main_y + main_a * (x_out - main_y)

        carry = (phase, crack_ph, thump_ph, starter_ph,
                 rpm_s, thr_s, load_s, lp_y, prev_n, main_y)
        return carry, main_y

    z = jnp.float32(0.0)
    init = (z, z, z, z, jnp.float32(900.0), z, z, z, z, z)
    _, y = jax.lax.scan(step, init, xs)
    return y


def drive_cycle(seconds: float = 6.0, sample_rate: int = 48000, seed: int = 0):
    """A scripted idle -> full-throttle -> upshift x2 -> lift-off run
    (the headless stand-in for the reference's W/S keyboard vehicle sim
    :343-520): returns (EngineControls, noise)."""
    n = int(seconds * sample_rate)
    t = np.arange(n, dtype=np.float32) / sample_rate

    thr = np.clip((t - 0.8) / 0.4, 0.0, 1.0) * (t < seconds - 1.2) \
        + np.clip(1.0 - (t - (seconds - 1.2)) / 0.8, 0.0, 1.0) \
        * (t >= seconds - 1.2)
    thr = np.clip(thr, 0.0, 1.0).astype(np.float32)

    # RPM ramps per gear with instant drops at upshifts.
    rpm = np.full(n, 900.0, np.float32)
    shift_burst = np.zeros(n, np.float32)
    shifts = [2.6, 4.2]
    seg_start = 0.8
    base_rpm = 900.0
    for s_end in shifts + [seconds]:
        seg = (t >= seg_start) & (t < s_end)
        u = (t[seg] - seg_start) / max(s_end - seg_start, 1e-3)
        rpm[seg] = base_rpm + (6800.0 - base_rpm) * np.clip(u, 0, 1)
        if s_end in shifts:
            burst = np.exp(-np.clip(t - s_end, 0, None) / 0.12) \
                * (t >= s_end)
            shift_burst = np.maximum(shift_burst, burst.astype(np.float32))
            base_rpm = 3800.0
            seg_start = s_end
    rpm[t < 0.8] = 900.0
    lift = t >= seconds - 1.2
    rpm[lift] = np.maximum(900.0, rpm[lift] - (t[lift] - (seconds - 1.2))
                           * 4000.0)

    load = (thr * 0.8 + 0.2 * np.clip(rpm / 6800.0, 0, 1)).astype(np.float32)
    torque_mul = (0.3 + 0.7 * thr).astype(np.float32)

    key = jax.random.PRNGKey(seed)
    noise = jax.random.uniform(key, (n,), jnp.float32, -1.0, 1.0)
    controls = EngineControls(
        rpm=jnp.asarray(rpm), throttle=jnp.asarray(thr),
        load=jnp.asarray(load), torque_mul=jnp.asarray(torque_mul),
        shift_burst=jnp.asarray(shift_burst))
    return controls, noise


def spectrum_image(samples, sample_rate: int = 48000, width: int = 512,
                   height: int = 256, fmax: float = 4000.0):
    """Spectrogram PNG image (u8 RGB) — the analog of the reference's FFT
    visualizer (fft_radix2 + draw_spectrum :298-340), rendered offline:
    column = |rfft| of a Hann window, log-amplitude colormap."""
    x = jnp.asarray(samples, jnp.float32)
    win = 2048
    hop = max(1, (x.shape[0] - win) // width)
    starts = jnp.arange(width) * hop
    hann = jnp.asarray(np.hanning(win), jnp.float32)

    def col(s):
        seg = jax.lax.dynamic_slice(x, (s,), (win,)) * hann
        mag = jnp.abs(jnp.fft.rfft(seg))
        return mag

    mags = jax.vmap(col)(starts)                       # (width, win//2+1)
    n_bins = int(fmax / sample_rate * win)
    mags = mags[:, :n_bins]
    db = 20.0 * jnp.log10(jnp.maximum(mags, 1e-6))
    db = jnp.clip((db + 60.0) / 60.0, 0.0, 1.0)
    img = jax.image.resize(db.T[::-1], (height, width), "bilinear")
    r = jnp.clip(img * 3.0, 0, 1)
    g = jnp.clip(img * 3.0 - 1.0, 0, 1)
    b = jnp.clip(img * 3.0 - 2.0, 0, 1)
    rgb = jnp.stack([r, g, b], axis=-1)
    return np.asarray(jnp.round(rgb * 255).astype(jnp.uint8))
