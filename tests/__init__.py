"""Test package (a package, so `tests.*` imports resolve to this tree)."""
