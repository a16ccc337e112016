"""Chunk-parallel Mueller-Müller clock recovery (the stream-Viterbi trick
applied to the timing loop).

Reference semantics: core/src/dsp/clock_recovery/mm.h:100-156 — one
sequential loop whose input stride is data-dependent (offset +=
floor(phase)), one dependent step per symbol however wide the device is.
Here the stream splits into K overlapping lanes that each re-acquire
timing over a W-sample warm-up window, batched as ONE vectorized
lax.scan over symbol-steps (plain XLA, no kernel). The two problems
specific to a TIMING loop, and their fixes:

1. **Per-lane dynamic sample addresses** (each lane interpolates at its
   own data-dependent offset — a gather per lane and symbol). Locked
   lanes all track the SAME transmitted symbol clock, so at
   symbol-step s their window starts differ by at most ~omega + jitter
   (their start phases are spread over one symbol, and omega_rel_limit
   caps drift): a group of M symbols x K lanes all interpolate from ONE
   shared [R, K] slice whose start row is the across-lane minimum — a
   dynamic-START static-SIZE slice. Within it, symbol m's rows sit in a
   narrow band at the STATIC baseline floor(m*fmin), so per-symbol
   windows are static slices and the offset/phase selection is small
   one-hots over a ~20-row local band + a [M*K,128] x [128,T] bank
   matmul — no gathers anywhere.

2. **Seam symbol accounting** (a symbol straddling a lane boundary could
   be emitted twice or dropped if neighboring lanes' timing estimates
   disagree by a hair). Lanes OVERLAP their emission ranges by
   ceil(omega) samples, so a boundary symbol is always emitted by at
   least one lane (usually both); a duplicate can only be claimed by
   ADJACENT lanes, so the merge is SORT-FREE: emissions stay lane-major
   [K, msc] (chronological within a lane, lanes ordered by their
   disjoint position ranges) and lane k masks out emissions within
   omega/2 of lane k-1's LAST emitted position (one per-lane max + one
   elementwise compare) instead of a global argsort + prefix
   compaction, so ``valid`` is a boolean MASK, not a prefix; consumers
   boolean-index. Block seams need no dedup at all:
   lane 0 seeds from the carried exact symbol grid.

Approximation contract (tests/test_clock_recovery_chunked.py): on a
timing-locked stream with W >> the loop's convergence time, the emitted
symbol sequence matches the sequential loop's (same count, same values
to interpolation tolerance); SDRPP_TPU_LOOPS=exact (or a short block)
falls back to the sequential scan bit-identically.

Noise contract (tests/test_chunked_stress.py, measured bounds): with
AWGN at Eb/N0 = 5 dB (the top of the LRPT operating band; below ~4 dB
the EXACT loop itself leaves its envelope), windowed SER degradation vs
the exact loop is <= 1% absolute with <= 2 timing slips per 2^18
samples. A clock-rate error of 0.8% with omega_rel_limit = 1% pulls in
identically to the exact loop (same count, 100% matching decisions). A
squelched (all-zero) stretch covering several lane warm-up windows
produces no NaNs; post-gap lanes re-seed data-aided and the tail
re-locks to zero errors, though symbol COUNTS inside the gap region may
differ from the exact loop's free-run by a few.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .clock_recovery import MMClockRecovery

__all__ = ["MMClockRecoveryChunked", "mm_symbols_chunked"]

_GROUP = 32  # symbols evolved per scan step (group-predictive)


def _emit_lanes(x, hist, K, W, T, extra=0):
    """[n] stream + [W+T-1] history -> [K, W + L + T - 1 + extra]
    overlapping lanes (payload L = ceil(n/K), replicate-padded; ``extra``
    zero columns keep end-of-lane symbols inside the shared interpolation
    window without clipping its start row) + (L, pad)."""
    n = x.shape[-1]
    L = -(-n // K)
    pad = K * L - n
    assert W <= L, (W, L)
    if pad:
        x = jnp.concatenate([x, jnp.broadcast_to(x[-1:], (pad,))])
    ext = jnp.concatenate([hist, x])  # [W + T - 1 + K*L]
    cols = W + L + T - 1 + int(extra)
    if extra:
        ext = jnp.concatenate([ext, jnp.zeros(int(extra), ext.dtype)])
    # lane j = ext[j*L : j*L + cols]
    idx = jnp.arange(K)[:, None] * L + jnp.arange(cols)[None, :]
    return ext[idx], L, pad


def mm_symbols_chunked(x, hist, offset0, phase0, freq0, err0, bank,
                       mu_gain, omega_gain, min_freq, max_freq,
                       lanes_k: int, warmup: int):
    """Run the M&M recurrence chunk-parallel over K lanes.

    ``x``: [n] complex64 (or float32) block. ``hist``: the previous
    block's last ``warmup + tap_count - 1`` raw samples. ``offset0`` /
    ``phase0`` / ``freq0`` / ``err0``: the carried loop state (err0 =
    (p1, p2, c1, c2) complex for complex MM, scalar ``last`` otherwise).
    Returns (syms, valid, positions, carry) with syms/valid/positions
    flattened [K * msc] LANE-MAJOR (valid entries are in global position
    order by construction), ``valid`` a boolean MASK (not a prefix —
    boolean-index to extract symbols), and carry the lane-(K-1) final
    loop state mapped back to block coordinates.
    """
    cplx = jnp.iscomplexobj(x)
    P, T = bank.shape
    K, W = int(lanes_k), int(warmup)
    n = x.shape[-1]
    bank = jnp.asarray(bank, jnp.float32)

    omega = float((min_freq + max_freq) / 2.0)
    pad_e = int(np.ceil(omega))
    # M symbols evolve per scan step GROUP-PREDICTIVELY (r3): positions
    # are predicted affinely from the carried (pos, freq) ignoring the
    # intra-group error feedback, all M symbols interpolate batched, the
    # errors are computed vectorized, and the loop recurrence given those
    # errors is integrated in CLOSED FORM (it is affine in the errors):
    #   pos_m = pos + m*freq + og*sum_{j<m}(m-j)e_j + mu*sum_{j<m}e_j
    # The neglected term is the intra-group position feedback, bounded by
    # mu*sum|e| <= 0.01*M samples worst case (~0.02 typical in lock) —
    # below the interpolation jitter. Validated: post-lock decisions
    # match the exact per-symbol loop 100% at M in {8,16,32}
    # (tests/test_clock_recovery_chunked.py, tests/test_chunked_stress.py).
    # vs a per-symbol scan this cuts the sequential steps by M, and each
    # step's time is mostly fixed loop overhead.
    # adaptive group: the warm-up must span SEVERAL groups so the
    # between-group feedback can re-converge a data-aided seed (a lane
    # whose whole warm-up fits in one group would re-acquire open-loop)
    warm_syms = max(int(W / float(omega)), 1)
    M = _GROUP
    while M > 8 and warm_syms // M < 6:
        M //= 2
    stride_max = int(np.ceil(max_freq))
    # lane start positions spread over ONE symbol (+ warm-up jitter +
    # lane 0's own-integrator wander relative to the ensemble pack)
    spread = stride_max + 6
    # shared-window height: lane start spread + the M-1 strides the
    # group advances + taps + margin
    R = spread + (M - 1) * stride_max + T + 8
    R = -(-R // 8) * 8

    # lanes carry `extra` zero columns past the payload so the shared
    # window's start row never has to clip below the laggard lane near
    # the lane end (min offset <= cols - R always holds)
    lanes, L, _ = _emit_lanes(x, hist, K, W, T,
                              extra=stride_max + R - T + 1)
    cols = lanes.shape[-1]
    lre = lanes.real.astype(jnp.float32).T if cplx else \
        lanes.astype(jnp.float32).T                      # [cols, K]
    lim = lanes.imag.astype(jnp.float32).T if cplx else None

    # --- seeding: every lane must start ON the symbol grid ------------
    # The M&M loop SLEWS timing at only mu_gain*err (<= 0.01 samples per
    # symbol at the reference gains, mm.h:42-45) — it is a tracker, not
    # an acquirer, so a W-sample warm-up cannot pull in a half-symbol
    # seed error. Lanes therefore seed data-aided: the Oerder-Meyr
    # square-law estimator over each lane's warm-up window
    # (tau = -omega/2pi * arg sum_i |x_i|^2 e^{-2pi i j/omega}) lands
    # within ~0.1 symbol of true timing non-iteratively. Lane 0 instead
    # continues the CARRIED grid exactly (base class: buf = tail[T-1]+x,
    # next symbol at buf offset0 + phase0; ext = buf + W), so block
    # seams need no dedup.
    p0 = (offset0.astype(jnp.float32) + phase0) + np.float32(W)
    warm = lanes[:, :W]
    pw = (warm.real * warm.real + warm.imag * warm.imag) if cplx \
        else warm.astype(jnp.float32) ** 2
    rot = jnp.exp(np.complex64(-2j * np.pi)
                  * jnp.arange(W, dtype=jnp.float32) / freq0)
    c = jnp.sum(pw.astype(jnp.complex64) * rot, axis=-1)  # [K]
    t_hat = -jnp.arctan2(c.imag, c.real) * freq0 / np.float32(2 * np.pi)
    # symbol CENTER -> interpolation window START (bank group delay)
    pj_om = jnp.mod(t_hat - np.float32((T - 1) / 2.0), freq0)
    base = jnp.arange(K, dtype=jnp.float32) * np.float32(L)  # lane ext starts
    pj_grid = jnp.mod(p0 - base, freq0)
    pj = jnp.where(jnp.arange(K) == 0, pj_grid, pj_om)  # in [0, freq0)
    off_j = jnp.floor(pj).astype(jnp.int32)
    ph_j = (pj - jnp.floor(pj)).astype(jnp.float32)
    fr_j = jnp.broadcast_to(freq0.astype(jnp.float32), (K,))

    # error state seeds to zeros everywhere: p1/p2/c1/c2 are just the two
    # previous symbols and refresh within two warm-up steps, so threading
    # the carried err0 into a lane (whose start is mid-history, not at
    # the carried stream position) would be WRONG, not merely needless.
    del err0
    nerr = 8 if cplx else 1
    err_init = tuple(jnp.zeros((K,), jnp.float32) for _ in range(nerr))

    # lane-local emission window [emit_lo, W + L): buf index jL + o - W in
    # [0, n), lanes j > 0 reaching back pad_e extra samples so seam
    # symbols are always claimed by at least one locked lane. Lane K-1's
    # ceiling excludes the replicate-padding (its payload tail holds
    # pad = K*L - n copies of x[-1], not stream data): without this the
    # carry freezes at W + L and maps to buf n + pad, silently skipping
    # pad/omega REAL symbols at every block seam (measured: 41 lost
    # symbols per 62500-sample meteor block at pad = 86). Lane 0's
    # threshold is POSITIONAL, anchored on the CARRIED grid origin p0
    # with a small drift allowance: its first grid symbol sits exactly AT
    # p0, and the warm-up's error feedback can realize it at p0 - eps —
    # an integer floor() threshold would then drop it (a knife edge
    # measured as ~1 lost symbol per block). The allowance must stay
    # well under one symbol: lane 0's backward warm-up grid always has a
    # point one symbol below p0 (the previous block's last emission),
    # which a looser threshold would re-emit as a cross-block duplicate
    # the dedup pass cannot see. 0.4 symbols accepts the realization
    # jitter of the shared-freq warm-up (which can exceed the old
    # 0.24-symbol margin at meteor's omega ~2.08 — measured as the first
    # cold-start symbol landing at p0 - 0.52 and being dropped) while
    # still rejecting the p0 - omega point with a 0.6-symbol margin.
    allow = np.float32(0.4 * omega)
    emit_lo_f = jnp.where(jnp.arange(K) == 0, p0 - allow,
                          np.float32(W - pad_e))
    pad = K * L - n
    emit_hi = jnp.where(jnp.arange(K) == K - 1,
                        np.int32(W + L - pad), np.int32(W + L))  # [K]
    lane_goff = (jnp.arange(K, dtype=jnp.float32) * L
                 - np.float32(W))  # ext-local offset -> buf index

    mu = np.float32(mu_gain)
    og = np.float32(omega_gain)
    fmin = np.float32(min_freq)
    fmax = np.float32(max_freq)
    one = np.float32(1.0)
    iota_p = jnp.arange(P, dtype=jnp.int32)                # [P]
    mvec = jnp.arange(M, dtype=jnp.float32)[:, None]       # [M, 1]
    m1vec = jnp.arange(1, M + 1, dtype=jnp.float32)[:, None]
    iota_g2 = jnp.arange(M + 2, dtype=jnp.int32)[:, None]  # [M+2, 1]
    iota_g1 = jnp.arange(M + 1, dtype=jnp.int32)[:, None]  # [M+1, 1]

    # static per-symbol row baselines inside the shared window: symbol m's
    # offset rel[m, k] sits in a NARROW band around m*omega (lane start
    # spread + the group's freq-limit drift), so the interpolation
    # one-hot only needs a local J-row window at static baseline
    # gstat[m] instead of the full R rows — J ~ 20 vs R ~ 120, and the
    # per-symbol windows are STATIC slices (no gathers)
    # rel[m,k] - floor(m*fmin) = (pos_k - r0) + (m*freq_k - floor(m*fmin))
    # is non-negative and bounded by spread + m*(fmax-fmin) + 1
    J = spread + int(np.ceil(M * (float(max_freq) - float(min_freq)))) \
        + 2 + T
    J = min(J, R)
    gstat = np.floor(np.arange(M) * float(min_freq)).astype(int)
    gstat = np.minimum(gstat, R - J)
    iota_j = jnp.arange(J - T + 1, dtype=jnp.int32)[None, :, None]

    def step(carry, _):
        offset, phase, freq = carry[0], carry[1], carry[2]
        err_state = carry[3:]
        pos = offset.astype(jnp.float32) + phase           # [K]

        # window anchor = min offset over lanes still below their emit
        # ceiling: a lane that froze early (lane K-1 stops `pad` samples
        # before the others) must not drag the anchor down and push the
        # active pack out of its per-symbol band
        active = offset < emit_hi
        r0 = jnp.clip(jnp.min(jnp.where(active,
                                        jnp.clip(offset, 0, cols - T),
                                        np.int32(cols - T))), 0, cols - R)
        win_re = jax.lax.dynamic_slice(lre, (r0, 0), (R, K))
        win_im = jax.lax.dynamic_slice(lim, (r0, 0), (R, K)) if cplx else None
        win = jnp.stack([win_re, win_im]) if cplx else win_re[None]

        cat = lambda h, a: jnp.concatenate(                # noqa: E731
            [jnp.stack(h), a], axis=0)

        # [p, M, J, K]: symbol m's local window rows (static slices)
        vstat = jnp.stack([win[:, g:g + J, :] for g in gstat], axis=1)

        def evaluate(Pm, coarse=False):
            """Interpolate the M group symbols at positions Pm, compute
            the M&M errors (vectorized with the carried 2-symbol
            history), and integrate the affine recurrence in closed form:
            pos_m = pos + m*freq + og*sum_{j<m}(m-j)e_j + mu*sum_{j<m}e_j.

            ``coarse`` (the PREDICTOR pass): 2-tap linear interpolation
            at the bank's measured effective delay (3 + ph for the
            128x8 windowed-sinc bank) instead of the full one-hot phase
            select + bank matmul — the budget's dominant stage. Pass-1
            outputs only steer the corrected trajectory through the
            loop gains (og, mu <= 0.01/symbol), so its few-percent
            interpolation error moves positions by well under the
            interpolation jitter; symbol VALUES and the carried error
            state always come from the full-quality pass.
            """
            o_int = jnp.floor(Pm).astype(jnp.int32)
            rel = o_int - r0
            ok = (rel >= 0) & (rel <= R - T) \
                & (rel >= jnp.asarray(gstat)[:, None]) \
                & (rel <= jnp.asarray(gstat + J - T)[:, None])
            rel2 = jnp.clip(rel - jnp.asarray(gstat)[:, None], 0, J - T)
            ph = Pm - jnp.floor(Pm)
            sel = (iota_j == rel2[:, None, :]).astype(jnp.float32)
            w2 = jnp.zeros((M, J, K), jnp.float32)
            if coarse:
                span = J - T + 1
                # the bank's effective group delay: (T-1)//2 + ph rows
                # into the window (3 + ph for the default 128x8
                # windowed-sinc bank; derived, not hardcoded, so a
                # non-default interp_tap_count keeps the predictor
                # aligned — d+1+span <= J holds for every T >= 2)
                d = (T - 1) // 2
                w2 = w2.at[:, d:d + span, :].add(
                    sel * (1.0 - ph)[:, None, :])
                w2 = w2.at[:, d + 1:d + 1 + span, :].add(
                    sel * ph[:, None, :])
            else:
                ph_idx = jnp.clip(jnp.floor(ph * P).astype(jnp.int32),
                                  0, P - 1)
                taps = jnp.matmul(
                    (ph_idx[..., None] == iota_p).astype(jnp.float32),
                    bank,
                    precision=jax.lax.Precision.HIGHEST)   # [M, K, T]
                # combined interpolation weights over the LOCAL window:
                # w2[m, j, k] = taps[m, k, j - rel2[m, k]] — T one-hot
                # shifted accumulations over J rows, no gathers
                for t in range(T):
                    w2 = w2.at[:, t:t + (J - T + 1), :].add(
                        sel * taps[:, None, :, t])
            y = jnp.einsum("mjk,pmjk->pmk", w2, vstat,
                           precision=jax.lax.Precision.HIGHEST)
            outr = y[0]                                    # [M, K]
            outi = y[1] if cplx else None

            if cplx:
                p1r, p1i, p2r, p2i, c1r, c1i, c2r, c2i = err_state
                c0r = jnp.where(outr > 0, one, -one)
                c0i = jnp.where(outi > 0, one, -one)
                yr1 = cat([p1r], outr[:-1])
                yi1 = cat([p1i], outi[:-1])
                yr2 = cat([p2r, p1r], outr[:-2])
                yi2 = cat([p2i, p1i], outi[:-2])
                cr1 = cat([c1r], c0r[:-1])
                ci1 = cat([c1i], c0i[:-1])
                cr2 = cat([c2r, c1r], c0r[:-2])
                ci2 = cat([c2i, c1i], c0i[:-2])
                error = ((outr - yr2) * cr1 + (outi - yi2) * ci1) \
                    - ((c0r - cr2) * yr1 + (c0i - ci2) * yi1)
            else:
                c0r = c0i = None
                yr1 = cat([err_state[0]], outr[:-1])
                error = jnp.where(yr1 > 0, one, -one) * outr \
                    - yr1 * jnp.where(outr > 0, one, -one)
            error = jnp.clip(error, -one, one)             # [M, K]

            # SHARED (ensemble) freq integrator for lanes 1..K-1: every
            # lane samples the same transmitted symbol clock, so the og
            # accumulator integrates the ACROSS-LANE MEAN error — one
            # clock-rate estimate with K-fold less noise than any single
            # loop. This is also what keeps the shared interpolation
            # window sound: with per-lane integrators, data-driven freq
            # bias (M&M self-noise — the exact loop itself wanders
            # ~0.25% on a realistic RRC/QPSK stream) made lane offsets
            # spread ~1 sample per 32-symbol step until leader lanes
            # exited the static J-row band and silently stopped emitting
            # (measured: 149 dropped symbols per 62.5k-sample meteor
            # block). Differential drift is now structurally zero;
            # per-lane phase pull-in still runs through the mu term.
            # Lane 0 keeps its OWN integrator: its role is re-tracing
            # the carried grid through the warm-up (exactly on a cold
            # start, where zero history gives zero errors), and the
            # ensemble's acquisition transients would wobble it off that
            # grid (measured: first cold-start symbol realized at
            # p0 + 0.53 instead of p0, costing one symbol of parity).
            A = jnp.cumsum(error, axis=0)                  # [M, K]
            B = jnp.cumsum(mvec * error, axis=0)
            ebar = jnp.mean(error, axis=1, keepdims=True)  # [M, 1]
            Abar = jnp.cumsum(ebar, axis=0)
            Bbar = jnp.cumsum(mvec * ebar, axis=0)
            lane0 = (jnp.arange(K) == 0)[None, :]
            pos_m = jnp.where(
                lane0,
                pos[None] + m1vec * freq[None]
                + og * (m1vec * A - B) + mu * A,
                pos[None] + m1vec * freq[None]
                + og * (m1vec * Abar - Bbar) + mu * A)
            freq_m = jnp.clip(
                jnp.where(lane0, freq[None] + og * A,
                          freq[None] + og * Abar), fmin, fmax)
            return o_int, ok, outr, outi, c0r, c0i, pos_m, freq_m

        # PREDICT: open-loop positions from the carried (pos, freq) —
        # then CORRECT: re-evaluate at the pass-1 feedback-corrected
        # trajectory (one Gauss-Seidel sweep). The corrector matters
        # during (re)acquisition and under a persistent clock-rate error,
        # where errors are biased and the open-loop prediction goes stale
        # within the group; in lock both passes coincide.
        Pm0 = pos[None, :] + mvec * freq[None, :]          # [M, K]
        _, _, _, _, _, _, pos_m1, _ = evaluate(Pm0, coarse=True)
        Pm = jnp.concatenate([pos[None], pos_m1[:-1]], axis=0)
        o_int, ok, outr, outi, c0r, c0i, pos_m, freq_m = evaluate(Pm)

        # freeze: carry advances to the LAST group symbol below the
        # emission ceiling (parity with the per-symbol loop's stop);
        # valid_m is a prefix since positions are monotone
        valid_m = o_int < emit_hi                          # [M, K]
        nv = jnp.sum(valid_m.astype(jnp.int32), axis=0)    # [K] in [0, M]
        sel1 = (iota_g1 == nv[None, :]).astype(jnp.float32)   # [M+1, K]
        sel2a = (iota_g2 == nv[None, :]).astype(jnp.float32)  # [M+2, K]
        sel2b = (iota_g2 == (nv + 1)[None, :]).astype(jnp.float32)
        pick1 = lambda stk: jnp.sum(stk * sel1, axis=0)    # noqa: E731
        picka = lambda stk: jnp.sum(stk * sel2a, axis=0)   # noqa: E731
        pickb = lambda stk: jnp.sum(stk * sel2b, axis=0)   # noqa: E731

        new_pos = pick1(cat([pos], pos_m))
        new_freq = pick1(cat([freq], freq_m))
        if cplx:
            p1r, p1i, p2r, p2i, c1r, c1i, c2r, c2i = err_state
            yr_e = cat([p2r, p1r], outr)
            yi_e = cat([p2i, p1i], outi)
            cr_e = cat([c2r, c1r], c0r)
            ci_e = cat([c2i, c1i], c0i)
            new_err = (pickb(yr_e), pickb(yi_e),           # p1 = sym[nv-1]
                       picka(yr_e), picka(yi_e),           # p2 = sym[nv-2]
                       pickb(cr_e), pickb(ci_e),
                       picka(cr_e), picka(ci_e))
        else:
            new_err = (pick1(cat([err_state[0]], outr)),)

        emit = ok & valid_m & (Pm >= emit_lo_f[None, :])
        gpos = lane_goff[None, :] + Pm
        emit = emit & (gpos < np.float32(n))
        out = (jnp.where(emit, outr, 0.0),
               (jnp.where(emit, outi, 0.0) if cplx else None),
               jnp.where(emit, gpos, np.float32(np.inf)),
               emit)
        new_off = jnp.floor(new_pos)
        carry = (new_off.astype(jnp.int32),
                 new_pos - new_off, new_freq) + new_err
        return carry, out

    msc = int(np.ceil((L + W + T) / float(min_freq))) + 1
    msc = M * (-(-msc // M))
    carry0 = (off_j, ph_j, fr_j) + err_init
    carry_f, (sr, si, pos, emit) = jax.lax.scan(
        step, carry0, None, length=msc // M)

    # SORT-FREE seam merge: no global argsort + prefix compaction of the
    # K*msc symbol slots is needed: per-lane emissions are already
    # chronological, lanes cover
    # disjoint position ranges overlapping only at seams, and a seam
    # duplicate can only be claimed by ADJACENT lanes — so ordering is
    # lane-major [K, msc] by construction, and dedup is "lane k drops
    # emissions within omega/2 of lane k-1's LAST emitted position"
    # (a per-lane max + one elementwise mask). ``valid`` is therefore a
    # boolean MASK, not a prefix — consumers boolean-index (the exact
    # fallback kernels still return prefix masks, which boolean indexing
    # also handles).
    to_lanes = lambda a: a.reshape(-1, K).T            # noqa: E731
    pos = to_lanes(pos)                                # [K, msc]
    emit = to_lanes(emit)
    syms = to_lanes((jax.lax.complex(sr, si) if cplx else sr).reshape(-1, K))
    lastpos = jnp.max(jnp.where(emit, pos, -np.inf), axis=1)  # [K]
    prev = jnp.concatenate([jnp.full((1,), -np.inf, jnp.float32),
                            lastpos[:-1]])
    valid = emit & (pos > prev[:, None] + np.float32(omega / 2.0))
    syms, valid, pos = syms.reshape(-1), valid.reshape(-1), pos.reshape(-1)

    # carried loop state: lane K-1's final, mapped to next-block coords
    off_f = (carry_f[0][-1].astype(jnp.float32) + lane_goff[-1]
             - np.float32(n)).astype(jnp.int32)
    carry = {"offset": off_f, "phase": carry_f[1][-1], "freq": carry_f[2][-1]}
    if cplx:
        e = carry_f[3:]
        carry.update({
            "p1": jax.lax.complex(e[0][-1], e[1][-1]),
            "p2": jax.lax.complex(e[2][-1], e[3][-1]),
            "c1": jax.lax.complex(e[4][-1], e[5][-1]),
            "c2": jax.lax.complex(e[6][-1], e[7][-1])})
    else:
        carry["last"] = carry_f[3][-1]
    return syms, valid, pos, carry


class MMClockRecoveryChunked(MMClockRecovery):
    """MM clock recovery, chunk-parallel for long 1-D blocks (K
    overlapping warm-up lanes + position-dedup symbol merge, plain XLA),
    the sequential scan otherwise. State grows a ``hist`` buffer
    of the last ``warmup + tap_count - 1`` raw samples."""

    def __init__(self, *args, warmup: int = 512, max_lanes: int = 256,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def _hist_len(self):
        return self.warmup + self.tap_count - 1

    def init_state(self):
        st = super().init_state()
        st["hist"] = jnp.zeros(self._hist_len(), self.dtype)
        return st

    def _lanes_for(self, n: int) -> int:
        from .scans_pallas import _chunk_lanes_for
        return _chunk_lanes_for(n, self.warmup, self.max_lanes)

    def _group_for(self) -> int:
        # mirror of mm_symbols_chunked's adaptive group-size computation:
        # the warm-up must span >= 6 groups so the between-group feedback
        # can re-converge a data-aided seed
        omega = float(self.min_freq + self.max_freq) / 2.0
        warm_syms = max(int(self.warmup / omega), 1)
        M = _GROUP
        while M > 8 and warm_syms // M < 6:
            M //= 2
        return M

    def max_symbols(self, n: int) -> int:
        k = self._lanes_for(n)
        if k >= 1:
            L = -(-n // k)
            W = self.warmup
            msc = int(np.ceil((L + W + self.tap_count)
                              / float(self.min_freq))) + 1
            M = self._group_for()  # must agree with the kernel's rounding
            return k * M * (-(-msc // M))
        return super().max_symbols(n)

    def __call__(self, state, x):
        k = self._lanes_for(x.shape[-1])
        if x.ndim != 1 or k < 1:
            sub = {kk: v for kk, v in state.items() if kk != "hist"}
            sub, out = super().__call__(sub, x)
            hist = jnp.concatenate(
                [state["hist"], x.astype(self.dtype)])[-self._hist_len():]
            return {**sub, "hist": hist}, out
        err0 = (state["p1"], state["p2"], state["c1"], state["c2"]) \
            if self.complex_input else state["last"]
        syms, valid, _, carry = mm_symbols_chunked(
            x.astype(self.dtype), state["hist"], state["offset"],
            state["phase"], state["freq"], err0, self.bank,
            self.mu_gain, self.omega_gain, self.min_freq, self.max_freq,
            lanes_k=k, warmup=self.warmup)
        hist = jnp.concatenate(
            [state["hist"], x.astype(self.dtype)])[-self._hist_len():]
        new_state = {"tail": jnp.concatenate(
            [state["tail"], x.astype(self.dtype)])[-(self.tap_count - 1):],
            "hist": hist, **carry}
        return new_state, (syms, valid)
