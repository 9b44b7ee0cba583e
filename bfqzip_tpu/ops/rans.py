"""Interleaved rANS entropy coder with static context models.

A JAX replacement for the reference's step-5 compressors (7z PPMd and
libbsc, BFQzip.py:22-23,253-275).  Design:

  * rans32: 32-bit states, 16-bit renormalisation, 12-bit quantised
    frequencies — at most one renorm per symbol, so each scan step emits or
    consumes a masked u16 per lane.
  * LANES-way interleaving with *striped* lane assignment: the stream is cut
    into LANES contiguous chunks, one per lane, so context-model history stays
    lane-local and decode remains a vectorised lax.scan (symbol-interleaved
    lanes would serialise context computation).
  * models are static two-pass tables per context (models/context.py) — the
    explicit, vectorisable counterpart of PPMd's adaptive contexts.

Both encode and decode are jax.lax.scan programs; they run on the accelerator or the CPU.
The container is self-describing (tables + final states in the header).
"""

from __future__ import annotations

import struct

import jax
import jax.numpy as jnp
import numpy as np

from bfqzip_tpu.models.context import ContextSpec, Order0Spec, Order1Spec, Order2Spec, spec_by_id

PRECISION = 12
M = 1 << PRECISION
RANS_L = 1 << 16  # lower bound of the state interval
MAGIC = b"BQZR"
DEFAULT_LANES = 1024


def choose_spec(data: np.ndarray) -> ContextSpec:
    """Pick a context order by alphabet size (table size stays bounded)."""
    k = np.unique(data).size
    if k <= 8:
        return Order2Spec
    if k <= 128:
        return Order1Spec
    return Order1Spec if k <= 256 else Order0Spec


def quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Scale per-context counts to sum M, every present symbol >= 1."""
    c, k = counts.shape
    total = counts.sum(axis=1, keepdims=True)
    empty = total[:, 0] == 0
    freq = np.floor(counts * (M / np.maximum(total, 1))).astype(np.int64)
    freq[(counts > 0) & (freq == 0)] = 1
    # fix drift on the most frequent symbol of each context
    drift = M - freq.sum(axis=1)
    top = np.argmax(freq, axis=1)
    freq[np.arange(c), top] += drift
    # unseen contexts: uniform (never exercised, but tables must be valid)
    if empty.any():
        base = M // k
        u = np.full(k, base, np.int64)
        u[0] += M - base * k
        freq[empty] = u
    assert (freq.sum(axis=1) == M).all()
    return freq.astype(np.uint16)


def _prepare(data: np.ndarray, spec: ContextSpec, lanes: int):
    n = data.size
    uniq = np.unique(data) if n else np.array([0], np.uint8)
    k = uniq.size
    dense_map = np.zeros(256, np.uint8)
    dense_map[uniq] = np.arange(k, dtype=np.uint8)

    chunk = max((n + lanes - 1) // lanes, 1)
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[:n] = data
    if n:
        padded[n:] = data[-1]  # repeat last symbol; excluded via n on decode
    rows = dense_map[padded].reshape(lanes, chunk)
    ctx = spec.contexts(rows, k)

    counts = np.zeros((spec.num_contexts(k), k), np.int64)
    np.add.at(counts, (ctx.reshape(-1), rows.reshape(-1).astype(np.int64)), 1)
    freq = quantize_freqs(counts)
    cum = np.zeros((freq.shape[0], k + 1), np.uint32)
    cum[:, 1:] = np.cumsum(freq, axis=1, dtype=np.uint32)
    return uniq, k, chunk, rows, ctx, freq, cum


def _encode_scan(rows, ctx, freq, cum, lanes, chunk):
    """Reverse scan over chunk positions; returns final states + emissions."""
    freq_j = jnp.asarray(freq.astype(np.uint32))
    cum_j = jnp.asarray(cum)
    rows_j = jnp.asarray(rows.astype(np.int32))
    ctx_j = jnp.asarray(ctx.astype(np.int32))

    def body(state, t):
        s = rows_j[:, t]
        c = ctx_j[:, t]
        f = freq_j[c, s]
        start = cum_j[c, s]
        # shift-compare form: f << (32-PRECISION) overflows u32 when f == M
        need = (state >> (32 - PRECISION)) >= f
        emit = (state & jnp.uint32(0xFFFF)).astype(jnp.uint16)
        x = jnp.where(need, state >> 16, state)
        x = ((x // f) << PRECISION) + (x % f) + start
        return x, (emit, need)

    init = jnp.full((lanes,), RANS_L, jnp.uint32)
    ts = jnp.arange(chunk - 1, -1, -1, dtype=jnp.int32)
    final, (emits, needs) = jax.lax.scan(body, init, ts)
    return np.asarray(final), np.asarray(emits), np.asarray(needs)


def _auto_lanes(n: int, lanes: int) -> int:
    """Shrink the lane count for small inputs (4 bytes of header per lane)."""
    while lanes > 8 and lanes * 512 > max(n, 1):
        lanes //= 2
    return lanes


def encode(data, spec: ContextSpec | None = None, lanes: int = DEFAULT_LANES) -> bytes:
    data = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    spec = spec or choose_spec(data)
    lanes = _auto_lanes(data.size, lanes)
    uniq, k, chunk, rows, ctx, freq, cum = _prepare(data, spec, lanes)

    final, emits, needs = _encode_scan(rows, ctx, freq, cum, lanes, chunk)
    # emission order: steps t=chunk-1..0, lanes high->low within a step, so
    # the reversed payload reads (t=0, lane 0..L-1), (t=1, ...) — the decode
    # consumption order.
    flat_vals = emits[:, ::-1].reshape(-1)
    flat_mask = needs[:, ::-1].reshape(-1)
    payload = flat_vals[flat_mask][::-1].astype("<u2")

    header = b"".join(
        [
            MAGIC,
            struct.pack("<BBBx", 1, spec.spec_id, k - 1),
            struct.pack("<QII", data.size, lanes, payload.size),
            uniq.tobytes(),
            freq.astype("<u2").tobytes(),
            final.astype("<u4").tobytes(),
        ]
    )
    return header + payload.tobytes()


def encode_best(data, lanes: int = DEFAULT_LANES, prefer_native: bool = True) -> bytes:
    """Encode under each affordable context order and keep the smallest blob
    (table overhead vs. conditioning gain depends on stream size/alphabet).
    Uses the native C++ codec when built; the containers are identical."""
    data = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    k = np.unique(data).size if data.size else 1
    specs = [Order0Spec, Order1Spec]
    if k <= 16:
        specs.append(Order2Spec)

    if prefer_native:
        from bfqzip_tpu.utils import native

        if native.available():
            raw = data.tobytes()
            blobs = [
                native.rans_encode(raw, sp.order, _auto_lanes(data.size, lanes)) for sp in specs
            ]
            return min(blobs, key=len)
    blobs = [encode(data, sp, lanes) for sp in specs]
    return min(blobs, key=len)


def encode_blob_best(data, lanes: int = DEFAULT_LANES, pos_reset: int = -1) -> bytes:
    """Best available entropy container for a byte stream: the adaptive
    context-model coder (BQZC, native/cm_codec.cpp) when the native library
    is built, vs the static-table rANS (BQZR); smallest wins.  pos_reset
    enables BQZC's positional contexts for line-structured streams.  Decode
    with decode_blob, which dispatches on the magic."""
    from bfqzip_tpu.utils import native

    blobs = [encode_best(data, lanes)]
    if native.cm_available():
        raw = data if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8).tobytes()
        blobs.append(native.cm_encode(raw, pos_reset=pos_reset))
    return min(blobs, key=len)


def decode_blob(blob: bytes) -> np.ndarray:
    """Decode any bfqzip entropy container (BQZR rANS or BQZC context-model)."""
    if blob[:4] == b"BQZC":
        from bfqzip_tpu.utils import native

        out = native.cm_decode(blob)
        if out is None:
            raise RuntimeError(
                "BQZC container needs the native library (make -C native)"
            )
        return out
    return decode(blob)


def decode(blob: bytes) -> np.ndarray:
    if blob[:4] != MAGIC:
        raise ValueError("not a bfqzip rANS container")
    ver, spec_id, km1 = struct.unpack_from("<BBB", blob, 4)
    if ver != 1:
        raise ValueError(f"unsupported container version {ver}")
    k = km1 + 1
    n, lanes, plen = struct.unpack_from("<QII", blob, 8)
    off = 24
    uniq = np.frombuffer(blob, np.uint8, k, off); off += k
    spec = spec_by_id(spec_id)
    c = spec.num_contexts(k)
    freq = np.frombuffer(blob, "<u2", c * k, off).reshape(c, k).astype(np.uint32); off += 2 * c * k
    states = np.frombuffer(blob, "<u4", lanes, off).astype(np.uint32); off += 4 * lanes
    payload = np.frombuffer(blob, "<u2", plen, off).astype(np.uint32)

    cum = np.zeros((c, k + 1), np.uint32)
    cum[:, 1:] = np.cumsum(freq, axis=1, dtype=np.uint32)
    # slot -> symbol lookup per context: symbol s occupies freq[c, s] slots
    slot_sym = np.repeat(
        np.tile(np.arange(k, dtype=np.uint8), c), freq.reshape(-1).astype(np.int64)
    ).reshape(c, M)

    chunk = max((n + lanes - 1) // lanes, 1)
    out = _decode_scan(states, payload, freq, cum, slot_sym, spec, k, lanes, chunk)
    flat = np.asarray(out).T.reshape(-1)[:n]
    return uniq[flat]


def _decode_scan(states, payload, freq, cum, slot_sym, spec, k, lanes, chunk):
    freq_j = jnp.asarray(freq)
    cum_j = jnp.asarray(cum)
    slot_j = jnp.asarray(slot_sym)
    pay_j = jnp.asarray(np.concatenate([payload, np.zeros(lanes, np.uint32)]))

    kpow = [k**o for o in range(spec.order)]

    def body(carry, _):
        x, offset, hist = carry
        # context from per-lane history: hist[:, o] = symbol at distance o+1
        ctxv = jnp.zeros((lanes,), jnp.int32)
        for o in range(spec.order):
            ctxv = ctxv + hist[:, o].astype(jnp.int32) * kpow[o]
        slot = (x & jnp.uint32(M - 1)).astype(jnp.int32)
        s = slot_j[ctxv, slot].astype(jnp.int32)
        f = freq_j[ctxv, s]
        start = cum_j[ctxv, s]
        x = f * (x >> PRECISION) + slot.astype(jnp.uint32) - start
        need = x < RANS_L
        within = jnp.cumsum(need.astype(jnp.int32), dtype=jnp.int32) - need.astype(jnp.int32)
        vals = pay_j[offset + within]
        x = jnp.where(need, (x << 16) | vals, x)
        offset = offset + jnp.sum(need.astype(jnp.int32), dtype=jnp.int32)
        if spec.order:
            hist = jnp.concatenate([s[:, None].astype(jnp.uint8), hist[:, :-1]], axis=1)
        return (x, offset, hist), s.astype(jnp.uint8)

    hist0 = jnp.zeros((lanes, max(spec.order, 1)), jnp.uint8)
    init = (jnp.asarray(states), jnp.int32(0), hist0)
    (_, _, _), syms = jax.lax.scan(body, init, None, length=chunk)
    return syms  # [chunk, lanes]
