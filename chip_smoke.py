"""Smoke test of the solver's main path on one GPU, or on four with --four.

Run from the repository root:

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # the sharded path over four GPUs

Everything runs in this one process, which stops at the first failure with
a nonzero exit.  Phases on one GPU:

  device    a GPU is present; x64 and the persistent compile cache are on
  parity    the reference's iteration counts (BASELINE.md) on the two
            shipped CVXQP fixtures, in f64
  flagship  the 1.25M-row banded saddle system solved in f64 through
            ``cpkrylov_tpu.solve`` to a true residual <= 1e-6 ||b|| with the
            native LDL^T factor; solve, preconditioner-apply and
            triangular-solve times
  mixed     the f32 routes: ``solve(dtype=float32)``, ``solve_mixed`` with
            the host loop and the device-resident loop, and the df64
            error-free transforms checked bit-exactly against f64

With --four only the sharded path runs: ``dist_solve`` over a 1-D mesh of
four GPUs against a single-GPU ``solve`` of the same 5M-row system.  The
last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


class SmokeFailure(AssertionError):
    """A phase's result is wrong."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _precond_options(example: bool):
    from cpkrylov_tpu import PrecondOptions

    if not example:
        return PrecondOptions()
    # The example programs' settings (cpk_exprog1.m:79-92).
    return PrecondOptions(residual_update=True, nitref=1, force_itref=True,
                          itref_tol=1e-8)


# Preconditioner options of the flagship solve (the benchmark's settings).
def _flagship_options():
    from cpkrylov_tpu import PrecondOptions

    return PrecondOptions(residual_update=True, nitref=1, force_itref=True)


def _true_rel_residual(sysm, x) -> float:
    """||b - K x|| / ||b||, computed on the host in f64."""
    x = np.asarray(x, np.float64)
    n = sysm.n
    x1, x2 = x[:n], x[n:]
    r = sysm.b - np.concatenate([sysm.A @ x1 + sysm.B.T @ x2,
                                 sysm.B @ x1 - sysm.C @ x2])
    return float(np.linalg.norm(r) / np.linalg.norm(sysm.b))


def _time_jitted(fn, *args, reps: int = 20):
    """(min, median) seconds of ``fn(*args)`` after one warm-up call, each
    call ended by ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), float(np.median(ts))


def phase_device(platform: str = "gpu") -> dict:
    import jax

    from cpkrylov_tpu.utils.runtime import (enable_compile_cache,
                                            nvidia_smi_name_power)

    devs = jax.devices()
    check(devs[0].platform == platform,
          f"no {platform} device: JAX reports {devs[0].platform}")
    jax.config.update("jax_enable_x64", True)
    cache = enable_compile_cache()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    log(f"device: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    smi = nvidia_smi_name_power()
    check(smi is not None or platform != "gpu", "nvidia-smi not found")
    log(f"nvidia-smi name, power.limit: {smi or 'not available'}")
    log(f"compile cache: {cache}")
    return dev


# Iteration counts of BASELINE.md (reference algorithms in scipy, f64),
# with the examples' tolerances atol = rtol = 1e-6, itmax = 500.  The
# tolerance is +-2 iterations: the CSR SpMV's segment_sum lowers to a
# scatter-add on the GPU, whose summation order can change between runs.
PARITY_CASES = (
    # (fixture, label, method, SolverOptions extras, example precond, iters)
    ("cvxqp1_m", "cpminres", "cpminres", {}, True, 53),
    ("cvxqp1_m", "cpminres defaults", "cpminres", {}, False, 54),
    ("cvxqp1_m", "cpcg", "cpcg", {}, True, 55),
    ("cvxqp1_m", "cpcglanczos", "cpcglanczos", {}, True, 54),
    ("cvxqp1_m", "cpsymmlq", "cpsymmlq", {}, True, 54),
    ("cvxqp1_m", "cpdqgmres(2)", "cpdqgmres", {"mem": 2}, True, 54),
    ("cvxqp1_m", "cpdqgmres(50)", "cpdqgmres", {"mem": 50}, True, 54),
    ("cvxqp2_s", "cpgmres(100)", "cpgmres", {"restart": 100}, True, 127),
    ("cvxqp2_s", "cpdqgmres(100)", "cpdqgmres", {"mem": 100}, True, 120),
)


def phase_parity(cases=PARITY_CASES) -> list:
    import scipy.sparse.linalg as spla

    import cpkrylov_tpu as cpk
    from cpkrylov_tpu.utils import fixtures

    results = []
    for fix_name, label, method, extra, example, want in cases:
        fix = fixtures.load_fixture(fix_name)
        opts = cpk.SolverOptions(atol=1e-6, rtol=1e-6, itmax=500, **extra)
        out = cpk.solve(method, fix.b, fix.A, fix.B, fix.C, fix.G, opts=opts,
                        precond_opts=_precond_options(example))
        x_ref = spla.spsolve(fix.K.tocsc(), fix.b)
        rel = float(np.linalg.norm(np.asarray(out.x) - x_ref)
                    / np.linalg.norm(x_ref))
        log(f"parity {fix_name} {label}: iters={out.niters} (reference "
            f"{want}) solved={out.solved} rel_err={rel:.3e}")
        check(out.solved, f"{fix_name} {label} did not converge")
        check(abs(out.niters - want) <= 2,
              f"{fix_name} {label}: {out.niters} iterations, reference "
              f"{want}+-2")
        if fix_name == "cvxqp1_m" and label == "cpminres":
            # BASELINE.md measures 7.8e-7 for the reference algorithm.
            check(rel <= 1e-6, f"cvxqp1_m cpminres rel_err {rel:.3e} > 1e-6")
        results.append((fix_name, label, int(out.niters), rel))
    return results


def phase_flagship(n: int = 1_000_000, m: int = 250_000, *,
                   repeats: int = 3, reps: int = 20) -> dict:
    import jax
    import jax.numpy as jnp

    import cpkrylov_tpu as cpk
    from cpkrylov_tpu import driver
    from cpkrylov_tpu.operators.linop import aslinearoperator
    from cpkrylov_tpu.precond.trisolve import tri_solve
    from cpkrylov_tpu.utils import fixtures

    f64 = np.float64
    t0 = time.perf_counter()
    sysm = fixtures.banded_saddle_system(n, m, bandwidth=3, with_oracle=False)
    fixture_s = time.perf_counter() - t0
    opts = cpk.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    popts = _flagship_options()

    t0 = time.perf_counter()
    M = jax.block_until_ready(cpk.make_preconditioner(
        sysm.G, sysm.B, sysm.C, options=popts, dtype=f64))
    ptime = time.perf_counter() - t0
    check(M.factor_kind == "HostLDL",
          f"flagship factor is {M.factor_kind!r}, not the native LDL^T")

    def run():
        return cpk.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                         opts=opts, precond_opts=popts, M=M)

    t0 = time.perf_counter()
    out = run()
    first_s = time.perf_counter() - t0
    stimes = []
    for _ in range(repeats):
        out = run()
        stimes.append(out.stime)
    rel = _true_rel_residual(sysm, out.x)
    log(f"flagship n={n} m={m} rows={n + m}: iters={out.niters} "
        f"solved={out.solved} true_rel_residual={rel:.3e}")
    log(f"flagship setup: fixture_s={fixture_s:.3f} ptime_s={ptime:.3f} "
        f"first_call_s={first_s:.3f}")
    log(f"flagship warm solve s (each ended by block_until_ready): "
        f"min={min(stimes):.6f} all={[round(s, 6) for s in stimes]}")
    check(out.solved, "flagship solve did not converge")
    check(rel <= 1e-6, f"flagship true residual {rel:.3e} > 1e-6 ||b||")
    log(f"flagship classes: tf1={type(M.factor.tf1).__name__} "
        f"tf2={type(M.factor.tf2).__name__} kp={type(M.kp).__name__} "
        f"factor={M.factor_kind} factor_nitref={M.factor_nitref}")

    # The compiled solve's memory, from XLA, and the device's peak.
    A_op = aslinearoperator(sysm.A, dtype=f64)
    B_op = aslinearoperator(sysm.B, dtype=f64)
    C_op = aslinearoperator(sysm.C, dtype=f64)
    shift = bool(np.any(sysm.b[n:]))
    compiled = driver._solve_core.lower(
        "cpminres", jnp.asarray(sysm.b), A_op, C_op, B_op, M, opts,
        shift).compile()
    ma = compiled.memory_analysis()
    if ma is not None:
        log("flagship compiled memory_analysis: "
            f"argument_bytes={ma.argument_size_in_bytes} "
            f"output_bytes={ma.output_size_in_bytes} "
            f"temp_bytes={ma.temp_size_in_bytes} "
            f"generated_code_bytes={ma.generated_code_size_in_bytes}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"flagship peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not available')}")

    # One preconditioner apply and one triangular solve, each jitted alone:
    # the XLA numbers a hand-written kernel for this factor has to beat.
    z = jnp.asarray(np.random.default_rng(0).standard_normal(n + m))
    state = M.init_state(jnp.float64)
    apply_t = _time_jitted(jax.jit(lambda M_, s, v: M_.apply(s, v)[1]),
                           M, state, z, reps=reps)
    fsolve_t = _time_jitted(jax.jit(lambda f, v: f.solve(v)), M.factor, z,
                            reps=reps)
    tri1_t = _time_jitted(jax.jit(tri_solve), M.factor.tf1, z, reps=reps)
    tri2_t = _time_jitted(jax.jit(tri_solve), M.factor.tf2, z, reps=reps)
    for name, (tmin, tmed) in (("precond apply", apply_t),
                               ("factor solve", fsolve_t),
                               ("trisolve tf1", tri1_t),
                               ("trisolve tf2", tri2_t)):
        log(f"flagship {name} s: min={tmin:.6f} median={tmed:.6f}")
    return {"sysm": sysm, "iters": int(out.niters), "rel": rel,
            "stime_min": min(stimes)}


def _df64_exact(npairs: int, seed: int) -> None:
    import jax

    from cpkrylov_tpu.ops import df64

    rng = np.random.default_rng(seed)

    def draw():
        # Magnitudes 2^[-12, 12]: every sum and product of two such f32
        # values is exact in f64, so f64 is the exact reference.
        mag = rng.uniform(1.0, 2.0, npairs) * 2.0 ** rng.integers(-12, 13,
                                                                   npairs)
        return (mag * rng.choice([-1.0, 1.0], npairs)).astype(np.float32)

    a, b = draw(), draw()
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    s, e = jax.device_get(jax.jit(df64.two_sum)(a, b))
    p, q = jax.device_get(jax.jit(df64.two_prod)(a, b))
    bad_sum = int(np.count_nonzero(
        (s.astype(np.float64) + e.astype(np.float64)) != a64 + b64))
    bad_prod = int(np.count_nonzero(
        (p.astype(np.float64) + q.astype(np.float64)) != a64 * b64))
    log(f"df64 exactness on {npairs} random f32 pairs: two_sum mismatches="
        f"{bad_sum} two_prod mismatches={bad_prod}")
    check(np.array_equal(s, a + b), "two_sum high part is not fl(a + b)")
    check(np.array_equal(p, a * b), "two_prod high part is not fl(a * b)")
    check(bad_sum == 0 and bad_prod == 0,
          "df64 error-free transforms are not exact on this device")


def phase_mixed(sysm, *, npairs: int = 1_000_000, seed: int = 0) -> dict:
    import jax

    import cpkrylov_tpu as cpk

    popts = _flagship_options()
    opts = cpk.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    t0 = time.perf_counter()
    M32 = jax.block_until_ready(cpk.make_preconditioner(
        sysm.G, sysm.B, sysm.C, options=popts, dtype=np.float32))
    log(f"mixed f32 ptime_s={time.perf_counter() - t0:.3f} "
        f"factor={M32.factor_kind} factor_nitref={M32.factor_nitref}")

    out32 = cpk.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                      opts=opts, M=M32, dtype=np.float32)
    x32 = np.asarray(out32.x)
    log(f"f32 solve: iters={out32.niters} istatus={out32.istatus} "
        f"stime_s={out32.stime:.6f} "
        f"true_rel_residual={_true_rel_residual(sysm, x32):.3e}")
    check(x32.shape == (sysm.n + sysm.m,) and np.all(np.isfinite(x32)),
          "f32 solve returned a non-finite solution")

    # Both refinement loops stop on a true residual of 1e-9 ||b||, so that
    # their solutions can be compared at 1e-6: at the 1e-6 contract itself
    # two valid solutions may differ by cond(K) * 1e-6.
    opts_mixed = cpk.SolverOptions(atol=0.0, rtol=1e-9, itmax=200)
    host = cpk.solve_mixed("cpminres", sysm.b, sysm.A, sysm.B, sysm.C,
                           sysm.G, opts=opts_mixed, M=M32,
                           device_resident=False)
    rel_host = _true_rel_residual(sysm, host.x)
    log(f"solve_mixed host loop: solved={host.solved} outer={host.nouter} "
        f"inner={host.inner_niters} stime_s={host.stime:.6f} "
        f"true_rel_residual={rel_host:.3e}")
    check(host.solved and rel_host <= 1e-6,
          f"solve_mixed host loop: true residual {rel_host:.3e} > 1e-6")

    _df64_exact(npairs, seed)

    dev = cpk.solve_mixed("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                          opts=opts_mixed, M=M32, device_resident=True)
    agree = float(np.linalg.norm(dev.x - host.x) / np.linalg.norm(host.x))
    log(f"solve_mixed device-resident: solved={dev.solved} "
        f"outer={dev.nouter} inner={dev.inner_niters} "
        f"stime_s={dev.stime:.6f} rel_diff_vs_host={agree:.3e}")
    check(dev.solved, "device-resident solve_mixed did not converge")
    check(agree <= 1e-6,
          f"device-resident and host loops differ by {agree:.3e} > 1e-6")
    return {"host_rel": rel_host, "agree": agree}


def phase_four(n: int = 4_000_000, m: int = 1_000_000, ndev: int = 4,
               devices=None) -> dict:
    """dist_solve over ``ndev`` devices (the first ones, unless ``devices``
    names them) against a one-device solve."""
    import jax

    import cpkrylov_tpu as cpk
    from cpkrylov_tpu.parallel import bootstrap
    from cpkrylov_tpu.parallel.solve import dist_solve
    from cpkrylov_tpu.utils import fixtures

    devs = list(devices) if devices is not None else jax.devices()
    check(len(devs) >= ndev, f"{ndev} devices needed, {len(devs)} present")
    devs = devs[:ndev]
    mesh = bootstrap.make_mesh(devices=devs)
    sysm = fixtures.banded_saddle_system(n, m, bandwidth=3, with_oracle=False)
    opts = cpk.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    popts = _flagship_options()

    t0 = time.perf_counter()
    res, x1, x2 = jax.block_until_ready(dist_solve(
        mesh, "cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G, opts=opts,
        precond_opts=popts))
    dist_s = time.perf_counter() - t0
    x_dist = np.concatenate([np.asarray(x1), np.asarray(x2)])
    it_dist = int(res.niters)
    # Bytes of live arrays resident on each device after the sharded solve.
    resident = [0] * ndev
    for arr in jax.live_arrays():
        for shard in arr.addressable_shards:
            if shard.device in devs:
                resident[devs.index(shard.device)] += shard.data.nbytes
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
    log(f"four: dist_solve over {ndev} devices n={n} m={m}: iters={it_dist} "
        f"first_call_s={dist_s:.3f} "
        f"true_rel_residual={_true_rel_residual(sysm, x_dist):.3e}")
    log(f"four: peak_bytes_in_use per device: {peaks}")
    log(f"four: resident bytes per device after dist_solve: {resident}")

    out = cpk.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                    opts=opts, precond_opts=popts)
    x_ser = np.asarray(out.x)
    diff = float(np.linalg.norm(x_dist - x_ser) / np.linalg.norm(x_ser))
    log(f"four: single-device solve iters={out.niters} stime_s="
        f"{out.stime:.6f}; rel_diff dist vs single={diff:.3e}")
    check(res.solved and out.solved, "a four-device comparison solve failed")
    check(abs(it_dist - int(out.niters)) <= 1,
          f"iterations differ: dist {it_dist}, single {out.niters}")
    check(diff <= 1e-6, f"dist and single solutions differ by {diff:.3e}")
    # A device that held the whole system would carry nearly all of it.
    check(max(resident) <= 0.5 * sum(resident),
          f"one device holds most of the system: {resident}")
    if all(p is not None for p in peaks):
        check(max(peaks) <= 0.5 * sum(peaks),
              f"one device's peak memory dominates: {peaks}")
    return {"iters": it_dist, "diff": diff, "resident": resident,
            "peaks": peaks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path over four GPUs")
    args = ap.parse_args(argv)
    try:
        dev = phase_device()
        if args.four:
            phase_four()
        else:
            phase_parity()
            flag = phase_flagship()
            phase_mixed(flag["sysm"])
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
