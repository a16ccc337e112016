"""Forward error correction: convolutional (Viterbi) + Reed-Solomon GF(256).

JAX re-implementation of the capabilities of the reference's vendored
libcorrect (core/libcorrect/src/convolutional/*.c, reed-solomon/*.c):

- Convolutional codes: arbitrary rate 1/R, constraint order K<=15, the
  same conventions as libcorrect (message bits MSB-first, shift-register
  shifts left with the new bit in the LSB, poly j's output bit emitted
  j-th; trellis terminated with order+1 zero bits — encode.c:34-57,
  lookup.c:7-20, bit.c:26-46). Encoded output is bit-exact.
- Viterbi decode: the add-compare-select recurrence runs as a lax.scan
  over time with the [2^(K-1)]-state metric vector vectorized; per-step
  decisions feed a reverse traceback scan. Soft decision
  convention: 0 = strong 0, 255 = strong 1 (libcorrect soft convention).
- Reed-Solomon over GF(2^8): configurable primitive polynomial, first
  consecutive root, and generator root gap exactly like
  correct_reed_solomon_create (reed-solomon.c:14-36) — covering CCSDS
  (255,223) fcr=112 gap=11 as used for LRPT. Systematic encode
  (msg || parity, encode.c:3-35); decode via syndromes ->
  Berlekamp-Massey -> Chien search -> Forney; jittable and vmap-able over
  blocks (many RS blocks decode in parallel).

Encoders run in NumPy (host-side framing); decoders are jittable JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "ConvCode", "ReedSolomon", "RS_CCSDS",
    "CONV_R12_6", "CONV_R12_7", "CONV_R12_8", "CONV_R12_9",
]

# Standard polynomial sets (libcorrect correct.h:19-28; octal literals)
CONV_R12_6 = (0o73, 0o61)
CONV_R12_7 = (0o161, 0o127)
CONV_R12_8 = (0o225, 0o373)
CONV_R12_9 = (0o767, 0o545)

RS_CCSDS = 0x187  # x^8+x^7+x^2+x+1 (correct.h correct_rs_primitive_polynomial_ccsds)


def _bits_from_bytes(data) -> np.ndarray:
    """Bytes -> bits MSB-first (libcorrect bit_reader convention)."""
    return np.unpackbits(np.asarray(data, np.uint8))


def _bytes_from_bits(bits) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8))


def _popcount(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    cnt = np.zeros_like(x)
    while np.any(x):
        cnt += x & 1
        x >>= 1
    return cnt


class ConvCode:
    """Convolutional encoder + Viterbi decoder (rate 1/R, order K)."""

    def __init__(self, rate: int, order: int, polys):
        assert len(polys) == rate and rate >= 2 and 2 <= order <= 15
        self.rate = int(rate)
        self.order = int(order)
        self.polys = tuple(int(p) for p in polys)
        self.num_states = 1 << (order - 1)
        # Output table over the 2^order shift-register values
        # (lookup.c fill_table): bit j = parity(reg & poly[j]).
        regs = np.arange(1 << order, dtype=np.int64)
        outs = np.zeros((1 << order, rate), np.uint8)
        for j, p in enumerate(self.polys):
            outs[:, j] = (_popcount(regs & p) & 1).astype(np.uint8)
        self.reg_outputs = outs  # [2^order, rate]

    # ---------- encode (host) ----------

    def encode_len_bits(self, msg_len_bytes: int) -> int:
        return self.rate * (8 * msg_len_bytes + self.order + 1)

    def encode(self, msg) -> np.ndarray:
        """Encode bytes -> encoded bytes (bit-exact vs libcorrect encode.c)."""
        bits = _bits_from_bytes(msg)
        bits = np.concatenate([bits, np.zeros(self.order + 1, np.uint8)])
        mask = (1 << self.order) - 1
        reg = 0
        out_bits = np.zeros(len(bits) * self.rate, np.uint8)
        for i, b in enumerate(bits):
            reg = ((reg << 1) | int(b)) & mask
            out_bits[i * self.rate:(i + 1) * self.rate] = self.reg_outputs[reg]
        pad = (-len(out_bits)) % 8  # bit_writer_flush_byte zero-fill
        out_bits = np.concatenate([out_bits, np.zeros(pad, np.uint8)])
        return _bytes_from_bits(out_bits)

    # ---------- decode (JAX) ----------

    @functools.cached_property
    def _trellis(self):
        """For each next-state n: predecessor states {n>>1, n>>1 + S/2} and
        the corresponding shift-register values (p<<1)|b with b = n&1."""
        S = self.num_states
        n = np.arange(S)
        b = n & 1
        p0 = n >> 1
        p1 = (n >> 1) + S // 2
        r0 = (p0 << 1) | b
        r1 = (p1 << 1) | b
        return (p0.astype(np.int32), p1.astype(np.int32),
                r0.astype(np.int32), r1.astype(np.int32))

    def decode_soft(self, soft_bits: jax.Array,
                    flush_bits: int | None = None) -> jax.Array:
        """Viterbi-decode soft bits (0=strong 0, 255=strong 1).

        soft_bits: [T*rate] covering T trellis steps including the flush
        steps. Returns decoded bits [T - flush_bits] uint8. flush_bits
        defaults to order+1 (this codec's own encode()); zero-terminated
        external streams like M17 use order-1 (K-1 flush bits,
        m17dsp.h:334 decoding 488 encoded -> 240 LSF bits).
        """
        if flush_bits is None:
            flush_bits = self.order + 1
        total = soft_bits.shape[0] // self.rate
        decisions = self.acs_decisions(soft_bits)
        S = self.num_states

        def back(state, dec_t):
            took1 = dec_t[state] != 0
            pred = jnp.where(took1, (state >> 1) + S // 2, state >> 1).astype(jnp.int32)
            bit = (state & 1).astype(jnp.uint8)
            return pred, bit

        _, bits_rev = jax.lax.scan(back, jnp.zeros((), jnp.int32), decisions,
                                   reverse=True)
        return bits_rev[: total - flush_bits]

    def acs_decisions(self, soft_bits: jax.Array) -> jax.Array:
        """Add-compare-select lattice: [T*rate] soft bits -> [T, S]
        decisions (nonzero = took predecessor (n>>1)+S/2)."""
        total = soft_bits.shape[0] // self.rate
        soft = soft_bits.astype(jnp.float32).reshape(total, self.rate)
        return self._acs(soft)[1]

    def _acs(self, soft: jax.Array, pack: bool = False):
        """ACS over [T, R] f32 soft bits -> (final metrics [S],
        decisions). Decisions are [T, S] bool, or with ``pack`` [T, words]
        uint32 with state n's decision at bit n%32 of word n//32."""
        S = self.num_states
        expected = jnp.asarray(self.reg_outputs.astype(np.float32) * 255.0)
        words = -(-S // 32)
        shifts = jnp.asarray(np.arange(32, dtype=np.uint32))

        # Gather-free butterfly: with n = next state, its predecessors
        # are p0 = n>>1 and p1 = (n>>1)+S/2 and the corresponding
        # registers are r0 = n and r1 = n + S. So metrics[p0] is each
        # element of the first half repeated twice, metrics[p1]
        # likewise for the second half, and bm[r0]/bm[r1] are plain
        # halves of the [2S] branch metric vector — pure slices/
        # repeats, no gathers on the hot path.
        def step(metrics, soft_t):
            bm = jnp.sum(jnp.abs(soft_t[None, :] - expected), axis=1)
            m0 = jnp.repeat(metrics[: S // 2], 2)
            m1 = jnp.repeat(metrics[S // 2:], 2)
            cand0 = m0 + bm[:S]
            cand1 = m1 + bm[S:]
            take1 = cand1 < cand0
            new_metrics = jnp.where(take1, cand1, cand0)
            new_metrics = new_metrics - jnp.min(new_metrics)
            if pack:
                bits = jnp.pad(take1, (0, words * 32 - S)) \
                    .astype(jnp.uint32).reshape(words, 32)
                take1 = jnp.sum(bits << shifts, axis=1, dtype=jnp.uint32)
            return new_metrics, take1

        init = jnp.full((S,), 1e9, jnp.float32).at[0].set(0.0)
        return jax.lax.scan(step, init, soft)

    def decode_soft_np(self, soft_bits: np.ndarray,
                       flush_bits: int | None = None) -> np.ndarray:
        """Host-facing decode: jitted ACS on device (cached per shape) +
        the native C traceback (utils/native viterbi_traceback) where the
        native library is built, else the whole decode in one jit."""
        if flush_bits is None:
            flush_bits = self.order + 1
        total = len(soft_bits) // self.rate
        from ..utils import native
        lib = native.load()
        if lib is None:
            fn = self._jit_decode(flush_bits)
            return np.asarray(fn(jnp.asarray(soft_bits)))
        dec = np.asarray(self._jit_acs(jnp.asarray(soft_bits)))
        dec = np.ascontiguousarray(dec.astype(np.uint8))
        bits = np.empty(total, np.uint8)
        lib.viterbi_traceback(dec.ctypes.data, total, self.num_states, 0,
                              bits.ctypes.data)
        return bits[: total - flush_bits]

    # most windows one ACS pass runs side by side; a longer stream takes
    # several passes, which bounds the decisions' device memory
    _STREAM_BATCH = 16384

    def decode_soft_stream(self, soft_bits: np.ndarray,
                           chunk_bits: int = 4096,
                           overlap_bits: int = 96) -> np.ndarray:
        """Chunk-parallel truncated Viterbi for LONG soft-bit streams.

        The trellis splits into ``chunk_bits``-step windows extended by
        ``overlap_bits`` of warm-up/warm-down; the windows run side by side
        in ONE jitted program — a vmapped ACS scan, a reverse-scan
        traceback from state 0 at each window's end, and the interior bits
        packed to bytes on device, so only total/8 bytes come back. Standard
        truncated-Viterbi semantics: survivor paths merge within ~5
        constraint lengths, so with the default 96-step overlap (~14 K for
        K=7) the output equals the exact decode except with vanishing
        probability at very low SNR near chunk seams. Inputs no longer than
        one window take the exact decode.
        """
        total = len(soft_bits) // self.rate
        L, W = int(chunk_bits), int(overlap_bits)
        t_w = L + 2 * W
        if total <= t_w:
            return self.decode_soft_np(soft_bits)
        soft_arr = np.asarray(soft_bits)
        # integral soft bits (e.g. LRPT's u8 symbols) go to the device as
        # uint8, a quarter of the f32 bytes; the jit converts in-graph
        if (np.issubdtype(soft_arr.dtype, np.integer)
                or (soft_arr.dtype == np.float32
                    and np.all(soft_arr == np.floor(soft_arr))
                    and soft_arr.min() >= 0 and soft_arr.max() <= 255)):
            soft2 = soft_arr.astype(np.uint8).reshape(total, self.rate)
        else:
            soft2 = soft_arr.astype(np.float32).reshape(total, self.rate)
        n_chunks = -(-total // L)
        G = -(-n_chunks // self._STREAM_BATCH)
        B = -(-n_chunks // G)
        chunk = np.arange(G * B)
        starts = np.clip(chunk * L - W, 0, total - t_w).astype(np.int32)
        offs = (chunk * L - starts).astype(np.int32)
        packed = np.asarray(self._jit_stream(total, L, W, G, B)(
            jnp.asarray(soft2), jnp.asarray(starts), jnp.asarray(offs)))
        bits = np.unpackbits(packed)[:total]
        return bits[: total - (self.order + 1)]

    @functools.lru_cache(maxsize=None)  # noqa: B019 - per-instance cache
    def _jit_stream(self, total: int, L: int, W: int, G: int, B: int):
        S = self.num_states
        t_w = L + 2 * W
        n_pack = -(-total // 8)
        # MSB-first to match np.unpackbits
        pack_w = jnp.asarray((1 << np.arange(7, -1, -1)).astype(np.uint32))

        def window_bits(w):
            # w: [t_w, R] -> [t_w] decoded bits of this window
            _, dec = self._acs(w, pack=True)

            def back(state, dec_t):
                word = dec_t[state >> 5]
                took1 = (word >> (state & 31).astype(jnp.uint32)) & 1
                pred = jnp.where(took1 != 0, (state >> 1) + S // 2,
                                 state >> 1).astype(jnp.int32)
                return pred, (state & 1).astype(jnp.uint8)

            _, bits = jax.lax.scan(back, jnp.zeros((), jnp.int32), dec,
                                   reverse=True)
            return bits

        def run(soft, starts, offs):
            # soft: [total, R]; starts/offs: [G*B] int32
            tw_idx = jnp.arange(t_w, dtype=jnp.int32)

            def group(carry, sg):
                idx = sg[:, None] + tw_idx[None, :]
                w = jnp.take(soft, idx, axis=0).astype(jnp.float32)
                return carry, jax.vmap(window_bits)(w)  # [B, t_w] u8

            _, allbits = jax.lax.scan(group, 0, starts.reshape(G, B))
            allbits = allbits.reshape(G * B, t_w)
            # interior of chunk c lives at [offs[c], offs[c]+L) of its
            # window; the final chunks' tail indices run past t_w (clip —
            # those positions fall beyond ``total`` and are dropped)
            gidx = offs[:, None] + jnp.arange(L, dtype=jnp.int32)[None, :]
            interior = jnp.take_along_axis(allbits, gidx, axis=1,
                                           mode="clip")
            flat = interior.reshape(-1)[:total]
            flat = jnp.pad(flat, (0, n_pack * 8 - total))
            return (flat.reshape(n_pack, 8).astype(jnp.uint32)
                    * pack_w).sum(axis=-1).astype(jnp.uint8)

        return jax.jit(run)

    @functools.cached_property
    def _jit_acs(self):
        return jax.jit(self.acs_decisions)

    @functools.lru_cache(maxsize=None)  # noqa: B019 - per-instance cache
    def _jit_decode(self, flush_bits: int):
        return jax.jit(functools.partial(self.decode_soft,
                                         flush_bits=flush_bits))

    def decode_soft_bytes(self, soft_bits) -> np.ndarray:
        bits = self.decode_soft_np(np.asarray(soft_bits))
        n = (len(bits) // 8) * 8
        return _bytes_from_bits(bits[:n])

    def decode_hard(self, encoded, num_bits: int | None = None) -> np.ndarray:
        bits = _bits_from_bytes(encoded)
        if num_bits is not None:
            bits = bits[:num_bits]
        bits = bits[: (len(bits) // self.rate) * self.rate]
        return self.decode_soft_bytes(bits.astype(np.float32) * 255.0)


# ---------------------------------------------------------------------------
# Reed-Solomon over GF(2^8)
# ---------------------------------------------------------------------------


def _gf_tables(prim_poly: int):
    exp = np.zeros(256, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= prim_poly
    return exp, log


def _gf_mul_np(a, b, exp, log):
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    out = exp[(log[a] + log[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.int32)


def _xor_reduce(x, axis):
    return jax.lax.reduce(x, np.int32(0), lambda a, b: a ^ b, (axis,))


class ReedSolomon:
    """RS(255, 255-nroots) matching libcorrect's parameterization."""

    def __init__(self, prim_poly: int = RS_CCSDS, first_consecutive_root: int = 1,
                 generator_root_gap: int = 1, num_roots: int = 32):
        self.nroots = int(num_roots)
        self.block_len = 255
        self.msg_len = 255 - self.nroots
        self.fcr = int(first_consecutive_root)
        self.gap = int(generator_root_gap)
        self.exp, self.log = _gf_tables(prim_poly)
        # Generator roots alpha^{gap*(fcr+i)} (reed-solomon.c:8-11)
        self.root_pows = (self.gap * (np.arange(self.nroots) + self.fcr)) % 255
        self.roots = self.exp[self.root_pows]
        # Generator polynomial g(x) = prod (x + root), coeffs low->high.
        g = np.zeros(self.nroots + 1, np.int32)
        g[0] = 1
        deg = 0
        for r in self.roots:
            ng = np.zeros_like(g)
            ng[1:deg + 2] = g[0:deg + 1]          # x * g
            ng[:deg + 1] ^= _gf_mul_np(g[:deg + 1], int(r), self.exp, self.log)
            g = ng
            deg += 1
        self.generator = g

    # ---------- encode (host) ----------

    def encode(self, msg) -> np.ndarray:
        """Systematic encode -> msg || parity (255 bytes), parity emitted
        high-order-first (libcorrect encode.c:29-31)."""
        msg = np.asarray(msg, np.uint8)
        assert len(msg) == self.msg_len
        parity = np.zeros(self.nroots, np.int32)  # low->high coefficients
        gtop = self.generator[:-1]
        for byte in msg:
            feedback = int(parity[-1]) ^ int(byte)
            parity[1:] = parity[:-1]
            parity[0] = 0
            if feedback:
                parity ^= _gf_mul_np(gtop, feedback, self.exp, self.log)
        return np.concatenate([msg, parity[::-1].astype(np.uint8)])

    # ---------- decode (JAX) ----------

    @property
    def _jt(self):
        # NOTE: not cached — inside a jit trace these become trace-local
        # constants; caching them would leak tracers across traces.
        return jnp.asarray(self.exp), jnp.asarray(self.log)

    def _mul(self, a, b):
        exp, log = self._jt
        out = exp[(log[a] + log[b]) % 255]
        return jnp.where((a == 0) | (b == 0), 0, out)

    def _inv(self, a):
        exp, log = self._jt
        return exp[(255 - log[jnp.maximum(a, 1)]) % 255]

    def _eval_at_pows(self, coeffs, x_pows):
        """Evaluate poly (coeffs low->high) at x = alpha^{x_pows[k]} for each
        k, vectorized: [len(x_pows)] results."""
        exp, log = self._jt
        j = jnp.arange(coeffs.shape[0])
        expo = (x_pows[:, None] * j[None, :]) % 255
        terms = jnp.where(coeffs[None, :] == 0, 0,
                          exp[(log[jnp.maximum(coeffs, 1)][None, :] + expo) % 255])
        return _xor_reduce(terms, 1)

    def decode(self, block: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Decode one 255-byte block -> (corrected msg bytes, ok flag).

        ``block[0]`` is the highest-order coefficient (first transmitted
        byte). Jit/vmap over a leading axis for batched decode.
        """
        exp, log = self._jt
        r = block.astype(jnp.int32)
        N = self.block_len
        nroots = self.nroots
        L = nroots + 1

        roots = jnp.asarray(self.roots.astype(np.int32))

        # Syndromes S_i = r(alpha^{gap*(fcr+i)}) via Horner (high->low).
        synd, _ = jax.lax.scan(lambda acc, c: (self._mul(acc, roots) ^ c, None),
                               jnp.zeros(nroots, jnp.int32), r)
        no_errors = jnp.all(synd == 0)

        # Berlekamp-Massey -> error locator Lambda (low->high, len L).
        # Carried invariant: Bs = x^m * B (classic Massey's B pre-multiplied
        # by the pending x^m), so each step only ever shifts by one x.
        def bm_step(carry, i):
            Lam, Bs, Llen, b = carry
            idx = i - jnp.arange(L)
            s_at = jnp.where((idx >= 0) & (idx < nroots),
                             synd[jnp.clip(idx, 0, nroots - 1)], 0)
            d = _xor_reduce(self._mul(Lam, s_at), 0)
            db = self._mul(d, self._inv(b))
            d_nz = d != 0
            newLam = jnp.where(d_nz, Lam ^ self._mul(Bs, db), Lam)
            grow = d_nz & (2 * Llen <= i)
            base = jnp.where(grow, Lam, Bs)  # old Lambda on growth, else Bs
            newBs = jnp.concatenate([jnp.zeros(1, jnp.int32), base[:-1]])
            newLlen = jnp.where(grow, i + 1 - Llen, Llen)
            newb = jnp.where(grow, d, b)
            return (newLam, newBs, newLlen, newb), None

        Lam0 = jnp.zeros(L, jnp.int32).at[0].set(1)
        Bs0 = jnp.zeros(L, jnp.int32).at[1].set(1)  # x * 1
        (Lam, _, Llen, _), _ = jax.lax.scan(
            bm_step, (Lam0, Bs0, jnp.int32(0), jnp.int32(1)), jnp.arange(nroots))

        # Chien search: position j (coefficient power; byte r[N-1-j]) has an
        # error iff Lambda(X_j^{-1}) == 0 with X_j = alpha^{gap*j}.
        jpos = jnp.arange(N)
        Xj_pow = (self.gap * jpos) % 255
        Xinv_pow = (255 - Xj_pow) % 255
        lam_at = self._eval_at_pows(Lam, Xinv_pow)
        is_err = lam_at == 0

        # Omega(x) = S(x)*Lambda(x) mod x^nroots
        jj = jnp.arange(L)
        # full product coefficients up to nroots-1
        def omega_coef(k):
            a_idx = jnp.arange(L)
            b_idx = k - a_idx
            valid = (b_idx >= 0) & (b_idx < nroots)
            terms = jnp.where(valid, self._mul(Lam, synd[jnp.clip(b_idx, 0, nroots - 1)]), 0)
            return _xor_reduce(terms, 0)

        Omega = jax.vmap(omega_coef)(jnp.arange(nroots))

        # Lambda'(x): keep odd-power coeffs, shift down one.
        dLam = jnp.where((jj % 2) == 1, Lam, 0)
        dLam = jnp.concatenate([dLam[1:], jnp.zeros(1, jnp.int32)])

        om_at = self._eval_at_pows(Omega, Xinv_pow)
        dl_at = self._eval_at_pows(dLam, Xinv_pow)

        # Forney: e_j = X_j^{1-fcr} * Omega(X_j^{-1}) / Lambda'(X_j^{-1}).
        corr_pow = (((1 - self.fcr) % 255) * Xj_pow) % 255
        num = self._mul(om_at, exp[corr_pow])
        ej = jnp.where(is_err & (dl_at != 0), self._mul(num, self._inv(dl_at)), 0)

        corrections = jnp.zeros(N, jnp.int32).at[N - 1 - jpos].set(ej)
        corrected = jnp.where(no_errors, r, r ^ corrections)

        # Verify: syndromes of the corrected block must vanish and the number
        # of found roots must match the locator degree.
        synd2, _ = jax.lax.scan(lambda acc, c: (self._mul(acc, roots) ^ c, None),
                                jnp.zeros(nroots, jnp.int32), corrected)
        nerr_found = jnp.sum(is_err.astype(jnp.int32))
        ok = jnp.all(synd2 == 0) & (no_errors | (nerr_found == Llen))
        return corrected[: self.msg_len].astype(jnp.uint8), ok


def _rs_decode_with_erasures(self, block, erasure_pos, num_erasures):
    """Decode with known erasure positions (libcorrect
    correct_reed_solomon_decode_with_erasures): correct f erasures plus e
    errors while 2e + f <= nroots.

    ``erasure_pos``: int32 [max_erasures] byte indices into the 255-byte
    block (first ``num_erasures`` valid). Returns (msg, ok).
    """
    exp, log = self._jt
    r = block.astype(jnp.int32)
    N = self.block_len
    nroots = self.nroots
    L = nroots + 1
    max_e = erasure_pos.shape[0]

    roots = jnp.asarray(self.roots.astype(np.int32))
    synd, _ = jax.lax.scan(lambda acc, c: (self._mul(acc, roots) ^ c, None),
                           jnp.zeros(nroots, jnp.int32), r)
    no_errors = jnp.all(synd == 0)

    # Erasure locator Gamma(x) = prod_j (1 ^ X_j x) with X_j = alpha^{gap*jpos}
    # where jpos = N-1-byte_index (coefficient power).
    jpos_e = (N - 1 - erasure_pos) % N
    Xj_e = exp[(self.gap * jpos_e) % 255]

    def gamma_step(g, k):
        # multiply g by (1 + X_k x) when k < num_erasures
        shifted = jnp.concatenate([jnp.zeros(1, jnp.int32), g[:-1]])
        cand = g ^ self._mul(shifted, Xj_e[k])
        return jnp.where(k < num_erasures, cand, g), None

    g0 = jnp.zeros(L, jnp.int32).at[0].set(1)
    Gamma, _ = jax.lax.scan(gamma_step, g0, jnp.arange(max_e))

    # Berlekamp-Massey initialized with the erasure locator; steps start at
    # n = f and the growth condition becomes 2*(L-f) <= n - f.
    f = num_erasures

    def bm_step(carry, i):
        Lam, Bs, Llen, b = carry
        active = i >= f
        idx = i - jnp.arange(L)
        s_at = jnp.where((idx >= 0) & (idx < nroots),
                         synd[jnp.clip(idx, 0, nroots - 1)], 0)
        d = _xor_reduce(self._mul(Lam, s_at), 0)
        db = self._mul(d, self._inv(b))
        d_nz = (d != 0) & active
        newLam = jnp.where(d_nz, Lam ^ self._mul(Bs, db), Lam)
        grow = d_nz & (2 * (Llen - f) <= (i - f))
        base = jnp.where(grow, Lam, Bs)
        newBs = jnp.where(active,
                          jnp.concatenate([jnp.zeros(1, jnp.int32), base[:-1]]),
                          Bs)
        newLlen = jnp.where(grow, i + 1 - (Llen - f), Llen)
        newb = jnp.where(grow, d, b)
        return (newLam, newBs, newLlen, newb), None

    # Bs starts as x * Gamma (the pre-shifted-B invariant seeded with Gamma).
    Bs0 = jnp.concatenate([jnp.zeros(1, jnp.int32), Gamma[:-1]])
    (Lam, _, Llen, _), _ = jax.lax.scan(
        bm_step, (Gamma, Bs0, f.astype(jnp.int32), jnp.int32(1)),
        jnp.arange(nroots))

    jpos = jnp.arange(N)
    Xj_pow = (self.gap * jpos) % 255
    Xinv_pow = (255 - Xj_pow) % 255
    lam_at = self._eval_at_pows(Lam, Xinv_pow)
    is_err = lam_at == 0

    def omega_coef(k):
        a_idx = jnp.arange(L)
        b_idx = k - a_idx
        valid = (b_idx >= 0) & (b_idx < nroots)
        terms = jnp.where(valid, self._mul(Lam, synd[jnp.clip(b_idx, 0, nroots - 1)]), 0)
        return _xor_reduce(terms, 0)

    Omega = jax.vmap(omega_coef)(jnp.arange(nroots))
    jj = jnp.arange(L)
    dLam = jnp.where((jj % 2) == 1, Lam, 0)
    dLam = jnp.concatenate([dLam[1:], jnp.zeros(1, jnp.int32)])
    om_at = self._eval_at_pows(Omega, Xinv_pow)
    dl_at = self._eval_at_pows(dLam, Xinv_pow)
    corr_pow = (((1 - self.fcr) % 255) * Xj_pow) % 255
    num = self._mul(om_at, exp[corr_pow])
    ej = jnp.where(is_err & (dl_at != 0), self._mul(num, self._inv(dl_at)), 0)
    corrections = jnp.zeros(N, jnp.int32).at[N - 1 - jpos].set(ej)
    corrected = jnp.where(no_errors, r, r ^ corrections)
    synd2, _ = jax.lax.scan(lambda acc, c: (self._mul(acc, roots) ^ c, None),
                            jnp.zeros(nroots, jnp.int32), corrected)
    ok = jnp.all(synd2 == 0)
    return corrected[: self.msg_len].astype(jnp.uint8), ok


ReedSolomon.decode_with_erasures = _rs_decode_with_erasures
del _rs_decode_with_erasures
