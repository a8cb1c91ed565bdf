"""Time the XLA:CPU cost of JAX package functions that the port's tests
(tests/port/) could call as oracles, to pick oracles that fit the per-file
test budget. Each measurement runs in a fresh child process; the first call
of a jitted function includes its compile.

    python tools/time_jax_oracles.py local_scan  # msm._local_scan, G1/G2
    python tools/time_jax_oracles.py prove       # setup + prove, x^13 circuit
    python tools/time_jax_oracles.py msm         # msm_pippenger, 32 G1 points
    python tools/time_jax_oracles.py ladder      # msm_double_and_add G1/G2,
                                                 # scale_points, the K3 body
    python tools/time_jax_oracles.py setup       # setup (x^7+3), fixed base,
                                                 # ceremony._apply_delta

Prints wall seconds per step and the child's peak RSS; a child still running
after --limit seconds (default 240) is killed and reported as such.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _peak_rss_gb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return 0.0


def _child(what: str):
    sys.path.insert(0, ROOT)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import random

    import jax
    jax.config.update("jax_platforms", "cpu")
    from zksc_tpu.curve import bn254_host as host
    from zksc_tpu.fields.limb import Fp, Fr
    from zksc_tpu.ops import ec, msm

    def step(label, fn):
        t = time.time()
        jax.block_until_ready(fn())
        print(f"{label}: {time.time() - t:.1f} s", flush=True)

    rng = random.Random(3)
    if what == "local_scan":
        g1 = ec.g1_points_to_device(
            Fp, [host.g1_mul(host.G1_GEN, rng.randrange(1, host.R))
                 for _ in range(64)])
        g2 = ec.g2_points_to_device(
            Fp, [host.g2_mul(host.G2_GEN, rng.randrange(1, host.R))
                 for _ in range(64)])
        for name, fops, P in (("G1", ec.G1_OPS, g1), ("G2", ec.G2_OPS, g2)):
            step(f"eager jac_add {name}", lambda: ec.jac_add(fops, P, P))
            for incl in (True, False):
                step(f"_local_scan {name} inclusive={incl}",
                     lambda: msm._local_scan(fops, P, 16, incl))
    elif what == "prove":
        from zksc_tpu.groth16 import ProverContext, setup
        from zksc_tpu.r1cs import compile_circuit, generate_witness

        def define(api, v):
            x, out = v["x"][0], v["out"][0]
            acc = x
            for _ in range(12):
                acc = api.mul(acc, x)
            api.assert_eq(api.add(acc, x, api.constant(41)), out)
            bits = api.to_bits(api.add(x, api.constant(2)), 8)
            api.assert_eq(api.from_bits(bits), api.add(x, api.constant(2)))

        cs = compile_circuit(define, [("out", 1)], [("x", 1)])
        srng = random.Random(23)
        t = time.time()
        pk, vk = setup(cs, rng=lambda: srng.randrange(2, host.R))
        print(f"setup: {time.time() - t:.1f} s", flush=True)
        out = (pow(7, 13, host.R) + 7 + 41) % host.R
        wit = generate_witness(define, [("out", 1)], [("x", 1)],
                               {"out": [[out]]}, {"x": [[7]]}, batch=1)[:, 0]
        ctx = ProverContext(cs, pk)
        z_mont, _, _ = ctx._witnesses_to_device([wit])
        step("compute_h_batch (vmapped H program)",
             lambda: ctx.compute_h_batch(z_mont))
        t = time.time()
        ctx.prove(wit, rng=lambda: 5)
        print(f"prove (H program already compiled): {time.time() - t:.1f} s",
              flush=True)
    elif what == "msm":
        pts = ec.g1_points_to_device(
            Fp, [host.g1_mul(host.G1_GEN, rng.randrange(1, host.R))
                 for _ in range(32)])
        sp = Fr.to_device([rng.randrange(1 << 40) for _ in range(32)],
                          mont=False)
        t = time.time()
        msm.msm_pippenger(ec.G1_OPS, pts, sp, 40)
        print(f"msm_pippenger G1 40-bit: {time.time() - t:.1f} s", flush=True)
    elif what == "ladder":
        import functools

        import jax.numpy as jnp
        from jax.experimental import pallas as pl
        from zksc_tpu.ops import pallas_msm
        g1 = ec.g1_points_to_device(
            Fp, [host.g1_mul(host.G1_GEN, rng.randrange(1, host.R))
                 for _ in range(16)])
        g2 = ec.g2_points_to_device(
            Fp, [host.g2_mul(host.G2_GEN, rng.randrange(1, host.R))
                 for _ in range(16)])
        sp = Fr.to_device([rng.randrange(1 << 32) for _ in range(16)],
                          mont=False)
        bits = ec.scalars_to_bits(Fr, sp, 32)
        for name, fops, P in (("G1", ec.G1_OPS, g1), ("G2", ec.G2_OPS, g2)):
            step(f"msm_double_and_add {name} 16 lanes 32 bits",
                 lambda: ec.msm_double_and_add(fops, P, bits, 32))
            step(f"scale_points {name} 16 lanes 254 bits",
                 lambda: ec.scale_points(fops, P, rng.randrange(host.R)))
        pts = ec.g1_points_to_device(
            Fp, [host.g1_mul(host.G1_GEN, rng.randrange(1, host.R))
                 for _ in range(pallas_msm.TILE)])
        sp = Fr.to_device([rng.randrange(1 << 8)
                           for _ in range(pallas_msm.TILE)], mont=False)
        b8 = ec.scalars_to_bits(Fr, sp, 8)
        T = pallas_msm.TILE
        spec = lambda rows: pl.BlockSpec((rows, T), lambda i: (0, i))
        call = pl.pallas_call(
            functools.partial(pallas_msm._ladder_tile_kernel, n_bits=8),
            grid=(1,), in_specs=[spec(8)] + [spec(16)] * 3,
            out_specs=(spec(16),) * 3,
            out_shape=(jax.ShapeDtypeStruct((16, T), jnp.uint32),) * 3,
            interpret=True)
        step("pallas_msm._ladder_tile_kernel interpret, 256 lanes 8 bits",
             lambda: call(b8, pts.x, pts.y, pts.z))
    elif what == "setup":
        from zksc_tpu.groth16 import ceremony, setup
        from zksc_tpu.r1cs import compile_circuit

        def define(api, v):
            x, out = v["x"][0], v["out"][0]
            acc = x
            for _ in range(6):
                acc = api.mul(acc, x)
            api.assert_eq(api.add(acc, api.constant(3)), out)

        cs = compile_circuit(define, [("out", 1)], [("x", 1)])
        srng = random.Random(7)
        t = time.time()
        pk, vk = setup(cs, rng=lambda: srng.randrange(2, host.R))
        print(f"setup: {time.time() - t:.1f} s", flush=True)
        for g2 in (False, True):
            base = host.G2_GEN if g2 else host.G1_GEN
            t = time.time()
            msm.batch_scalar_mul_fixed_base(
                [rng.randrange(host.R) for _ in range(8)], base, g2=g2)
            print(f"batch_scalar_mul_fixed_base g2={g2} 8 scalars: "
                  f"{time.time() - t:.1f} s", flush=True)
        t = time.time()
        ceremony._apply_delta(pk, vk, 12345, "", "contribution", "")
        print(f"ceremony._apply_delta: {time.time() - t:.1f} s", flush=True)
    else:
        raise SystemExit(f"unknown measurement {what!r}")


def main(argv):
    if argv and argv[0] == "--child":
        return _child(argv[1])
    what = argv[0] if argv else "local_scan"
    limit = float(argv[argv.index("--limit") + 1]) if "--limit" in argv else 240
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--child", what])
    peak = 0.0
    while proc.poll() is None:
        peak = max(peak, _peak_rss_gb(proc.pid))
        if time.time() - t0 > limit:
            proc.kill()
            proc.wait()
            print(f"{what}: killed after {limit:.0f} s, still running")
            break
        time.sleep(1.0)
    print(f"{what}: child wall {time.time() - t0:.1f} s, peak RSS "
          f"{peak:.1f} GB (sampled each second)")
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]) or 0)
