"""Rank / LF-mapping structures.

The reference answers rank queries with a succinct bit-parallel structure
(dna_string_n.hpp:152-185) and LF as C[c] + rank_c(i) (dna_bwt_n.hpp:78-101).
On the device the same information is one exclusive prefix-sum per symbol — the
vectorised form of the external-memory variant's tableOcc + vectorOcc two-level
counts (decode.cpp:87-235).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bfqzip_tpu import alphabet


def counts(bwt: jax.Array, valid: jax.Array) -> jax.Array:
    """Symbol counts [SIGMA] over the valid prefix."""
    one = valid.astype(jnp.int32)
    return jnp.stack([jnp.sum((bwt == c) * one, dtype=jnp.int32) for c in range(alphabet.SIGMA)])


def lf_array(bwt: jax.Array, valid: jax.Array) -> jax.Array:
    """LF[i] = C[bwt[i]] + rank_{bwt[i]}(i) for every valid position.

    TERM and padding positions get LF[i] = i (the reference never applies LF to
    a terminator, bfq_int.cpp LF assert at dna_bwt_n.hpp:84).
    """
    n_pad = bwt.shape[0]
    cnt = counts(bwt, valid)
    cbase = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt, dtype=jnp.int32)[:-1]])

    lf = jnp.arange(n_pad, dtype=jnp.int32)
    for c in range(1, alphabet.SIGMA):
        is_c = (bwt == c) & valid
        occ_incl = jnp.cumsum(is_c.astype(jnp.int32), dtype=jnp.int32)
        lf = jnp.where(is_c, cbase[c] + occ_incl - 1, lf)
    return lf
