"""Device->host transfer helpers."""

from __future__ import annotations

import numpy as np


def fetch_image(x) -> np.ndarray:
    """Device image -> numpy (waits for the device)."""
    return np.asarray(x)
