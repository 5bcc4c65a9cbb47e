"""hello-shaders family: 8 procedural fragment shaders -> one contact sheet.

Parity targets: HelloColorGradient/HSB/HSBPolar/Mix, HelloFractalBrownianMotion,
HelloGreenNoise, HelloMongolianFlag, HelloWormHole (hello-shaders/*.cpp).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

import numpy as _np
from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.shading.procedural import PROCEDURAL_SHADERS


def main():
    w, h = 320, 320
    tiles = []
    for name, fn in PROCEDURAL_SHADERS.items():
        raw = np.asarray(fn(w, h, 2.0))
        img = _np.clip(_np.floor(_np.clip(raw,0,1)*255+0.5),0,255).astype(_np.uint8)
        tiles.append(img)
        print(f"  {name}: mean={img.mean():.1f}")
    grid = np.concatenate(
        [np.concatenate(tiles[i * 4:(i + 1) * 4], axis=1) for i in range(2)],
        axis=0,
    )
    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_shaders.png")
    save_canvas_png(path, grid)
    print(f"wrote {path} {grid.shape}")


if __name__ == "__main__":
    main()
