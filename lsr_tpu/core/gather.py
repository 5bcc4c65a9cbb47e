"""Row gathers.

The fast gather is the ordinary row gather `table[flat_idx]`, fed FLAT
int32 indices (2D index arrays can de-optimize the lowering) and reshaped
back afterwards.  The 1D-table + slice_sizes=(lanes,) formulation of
lax.gather — superficially "layout proof" — lowers to a scalar slice loop
and must not be used.

Layout caveat: the gather is only fast when the table is physically
row-major.  Tables that cross a jit boundary (jit arguments) always are;
tables packed in the same program normally are too, but if a regression
appears, check the dumped HLO for a `{0,1}` parameter layout first.
"""

from __future__ import annotations

import jax.numpy as jnp


def take_rows(table, idx):
    """table[idx] for row tables, reshaped to idx.shape + table.shape[1:].

    table: (R, ...) array; idx: any-shape int array of row ids (caller
    guarantees in-range; out-of-range clamps per XLA gather semantics).
    """
    flat_idx = idx.reshape(-1).astype(jnp.int32)
    out = table[flat_idx]
    return out.reshape(idx.shape + table.shape[1:])
