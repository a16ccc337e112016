"""Measured op-level budget for the chunk-parallel MM (VERDICT r3 #7).

Times the full `mm_symbols_chunked` at the flagship config (meteor
omega ~2.083, n = 2^20, K = 256, W = 512 -> M = 32, ~70 scan steps),
then times each inner stage ISOLATED in a same-shape lax.scan of the
same step count, so the per-stage costs and the scan's fixed overhead
can be attributed:

  A  taps one-hot matmul   [M,K,P] x [P,T]      (MXU)
  B  w2 build              T shifted adds over [M, J-T+1, K]  (VPU)
  C  interpolation einsum  mjk,pmjk->pmk        (VPU)
  D  vstat window stack    M static J-row slices of [p, R, K]
  E  error + closed-form integration (cumsums over [M, K])
  F  empty scan of the same length (fixed overhead floor)

Each isolated stage consumes its inputs via a carried checksum (salted
per iteration) so XLA cannot hoist or DCE it. The full kernel runs
TWO evaluate passes per step (predict + correct), so expect the full
time ~ F + 2*(A+B+C+D+E) + merge/emit bookkeeping.

Usage: python tools/mm_budget.py [--cpu]
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _time_scan(body, args, steps, iters=8):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def prog(salt):
        def step(carry, _):
            c = body(carry, *args)
            return c * np.float32(1e-20) + salt, c
        carry, cs = jax.lax.scan(step, jnp.float32(0.0), None, length=steps)
        return jnp.sum(cs)

    def run(k):
        t0 = time.perf_counter()
        out = None
        for i in range(k):
            out = prog(jnp.float32(i * 1e-9))
        float(out)
        return time.perf_counter() - t0

    run(1)
    t1 = run(1)
    tn = run(iters)
    return max((tn - t1) / (iters - 1), 1e-9)


def main():
    import jax
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sdrpp_tpu.models.digital import MeteorDemod
    from sdrpp_tpu.ops.clock_recovery_chunked import _GROUP
    from sdrpp_tpu.utils.speed_tester import speed_test


    n = 1 << 20
    md = MeteorDemod()
    rec = md.recov
    K = rec._lanes_for(n)
    W = rec.warmup
    T = rec.tap_count
    P = rec.phase_count
    L = -(-n // K)
    fmin, fmax = float(rec.min_freq), float(rec.max_freq)
    M = rec._group_for()
    stride_max = int(np.ceil(fmax))
    spread = stride_max + 6
    R = -(-(spread + (M - 1) * stride_max + T + 8) // 8) * 8
    J = min(spread + int(np.ceil(M * (fmax - fmin))) + 2 + T, R)
    msc = int(np.ceil((L + W + T) / fmin)) + 1
    steps = (M * (-(-msc // M))) // M
    p = 2
    print(f"config: n=2^20 K={K} L={L} M={M} J={J} R={R} T={T} "
          f"steps={steps}")

    # full MM stage alone (not the whole chain): isolate via the class
    full = speed_test(rec, n, iters=5)
    print(f"full MM stage: {full['samples_per_sec'] / 1e6:.1f} Msamp/s "
          f"({full['time_per_block_us'] / 1e3:.2f} ms/2^20-block)", flush=True)

    rng = np.random.default_rng(0)
    bank = jnp.asarray(rng.standard_normal((P, T)).astype(np.float32))
    win = jnp.asarray(rng.standard_normal((p, R, K)).astype(np.float32))
    vstat = jnp.asarray(rng.standard_normal((p, M, J, K)).astype(np.float32))
    sel = jnp.asarray(rng.standard_normal((M, J - T + 1, K))
                      .astype(np.float32))
    taps = jnp.asarray(rng.standard_normal((M, K, T)).astype(np.float32))
    w2c = jnp.asarray(rng.standard_normal((M, J, K)).astype(np.float32))
    ph_idx = jnp.asarray(rng.integers(0, P, (M, K)).astype(np.int32))
    iota_p = jnp.arange(P, dtype=jnp.int32)
    err = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32))
    mvec = jnp.arange(M, dtype=jnp.float32)[:, None]
    gstat = np.minimum(np.floor(np.arange(M) * fmin).astype(int), R - J)

    rows = {}

    def A(c, ph_idx, bank):
        t = jnp.matmul((ph_idx[..., None] == iota_p).astype(jnp.float32),
                       bank, precision=jax.lax.Precision.HIGHEST)
        return c + jnp.sum(t)

    rows["A taps one-hot matmul"] = _time_scan(A, (ph_idx, bank), steps)

    def B(c, sel, taps):
        w2 = jnp.zeros((M, J, K), jnp.float32)
        for t in range(T):
            w2 = w2.at[:, t:t + (J - T + 1), :].add(
                sel * taps[:, None, :, t] + c)
        return jnp.sum(w2)

    rows["B w2 build (T adds)"] = _time_scan(B, (sel, taps), steps)

    def C(c, w2c, vstat):
        y = jnp.einsum("mjk,pmjk->pmk", w2c + c, vstat,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(y)

    rows["C interp einsum"] = _time_scan(C, (w2c, vstat), steps)

    def D(c, win):
        v = jnp.stack([win[:, g:g + J, :] for g in gstat], axis=1)
        return c + jnp.sum(v)

    rows["D vstat window stack"] = _time_scan(D, (win,), steps)

    def E(c, err):
        e = jnp.clip(err + c, -1.0, 1.0)
        Acc = jnp.cumsum(e, axis=0)
        Bcc = jnp.cumsum(mvec * e, axis=0)
        eb = jnp.mean(e, axis=1, keepdims=True)
        Ab = jnp.cumsum(eb, axis=0)
        Bb = jnp.cumsum(mvec * eb, axis=0)
        return jnp.sum(Acc) + jnp.sum(Bcc) + jnp.sum(Ab) + jnp.sum(Bb)

    rows["E error integration"] = _time_scan(E, (err,), steps)

    def F(c):
        return c + np.float32(1.0)

    rows["F empty scan floor"] = _time_scan(F, (), steps)

    print(f"{'stage':<26} {'ms/block':>9} {'x2 (ms)':>9}")
    acct = 0.0
    for name, t in rows.items():
        mult = 2.0 if name[0] in "ABCDE" else 1.0
        acct += t * mult
        print(f"{name:<26} {t * 1e3:>9.3f} {t * mult * 1e3:>9.3f}")
    full_ms = full["time_per_block_us"] / 1e3
    print(f"{'sum (2x A-E + F)':<26} {'':>9} {acct * 1e3:>9.3f}")
    print(f"{'full kernel measured':<26} {'':>9} {full_ms:>9.3f}")
    print(f"unattributed (merge/emit/picks): {full_ms - acct * 1e3:.3f} ms")


if __name__ == "__main__":
    main()
