"""HelloEngineSynth analog: engine-sound synthesis, headless.

The reference demo (hello-other-exps/hello_engine_synth.cpp) synthesizes a
W16 engine voice into an SDL audio stream with a keyboard vehicle sim and
an FFT visualizer window.  The JAX analog runs the same voice as a
lax.scan program over a scripted drive cycle and writes the edge-of-world
artifacts headlessly: out/hello_engine_synth.wav (the audio) and
out/hello_engine_synth_spectrum.png (the visualizer frame).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main():
    from lsr_tpu.audio.engine_synth import (
        drive_cycle, spectrum_image, synthesize)
    from lsr_tpu.io.png import write_png
    from lsr_tpu.io.wav import write_wav

    rate = 48000
    controls, noise = drive_cycle(seconds=6.0, sample_rate=rate)
    y = np.asarray(synthesize(controls, noise, sample_rate=rate))
    peak = float(np.abs(y).max())
    rms = float(np.sqrt(np.mean(y ** 2)))
    print(f"rendered {y.shape[0]} samples  peak={peak:.3f}  rms={rms:.3f}")

    out_dir = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out_dir, exist_ok=True)
    wav_path = os.path.join(out_dir, "hello_engine_synth.wav")
    write_wav(wav_path, y / max(peak, 1e-6) * 0.9, rate)
    print("wrote", wav_path)

    img = spectrum_image(y, rate)
    png_path = os.path.join(out_dir, "hello_engine_synth_spectrum.png")
    write_png(png_path, img)
    print("wrote", png_path)


if __name__ == "__main__":
    main()
