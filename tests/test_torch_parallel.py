"""The port's sharded layer (`ckb_zkp_tpu_torch/parallel/`) on the CPU: four
ranks over gloo, held against the JAX package's single-device functions.

One gloo world of four ranks is started once for the module: this file,
run as a script (`python tests/test_torch_parallel.py <port> <rank> 4
<outdir>`), is a rank. Every rank makes the same inputs from a numpy seed,
runs the sharded four-step transforms on n = 256 (fft_t, ifft_from_t, a
pointwise convolution, coset_eval, coset_interp), a G1 msm_sharded of 37
points (not a multiple of 4) and a G2 msm_sharded whose 16 points are
pow2-wider than its 11 scalars (the reference pads both by a count taken
from the scalars, `ckb_zkp_tpu/parallel/msm.py:66`: here the scalars are
zero-extended first), and two sharded Groth16 proves: the
`square_chain_shape(254)` (m = 512 >= d^2) under the port's own setup,
and Mini (m = 16 = d^2, so n1 = n2 = d) under keys carried by
`convert.params_from_reference` from the JAX package's host-mode setup.
Each rank writes its blocks and points as JSON; the cases compare them. A
fifth process (`... single <outdir>`) makes the port's setup, which the
ranks load, and the port's single-device proofs.

The references are the JAX package's single-device functions (its
`get_domain(fr, 256)` transforms run eagerly, its host-int MSMs, its
host-mode proofs) and the port's single-device proofs, never
`ckb_zkp_tpu.parallel`: its shard_map over the 8-device CPU platform
compiles for minutes (`tests/test_parallel.py`), which is what these
checks must not cost. Tolerance: none (bit for bit, point for point).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

if __name__ != "__main__":  # a rank imports no JAX
    from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)

SEED = 20261018
N_NTT = 256
WORLD = 4
TOXIC = (11, 12, 13, 14, 15)  # alpha, beta, gamma, delta, t
CHAIN = 254
R, S = 3, 4  # the chain proof's randomness; Mini's is 0, 0 (no b_g1 MSM)
MINI = (2, 3, 10)
G1_POINTS, G2_POINTS, G2_SCALARS = 37, 16, 11
CHILD_TIMEOUT_S = 240


def _inputs(fr, g1, g2, g1_gen, g2_gen):
    """The seeded inputs, the same on every rank and in the parent: two
    length-N_NTT vectors, the G1 points and scalars, the G2 points and
    scalars (host ints)."""
    rng = np.random.default_rng(SEED)

    def ints(k):
        words = rng.integers(0, 1 << 63, size=(k, 5), dtype=np.int64).tolist()
        return [sum(w << (63 * i) for i, w in enumerate(row)) % fr for row in words]

    x, y = ints(N_NTT), ints(N_NTT)
    k1, s1 = ints(G1_POINTS), ints(G1_POINTS)
    k2, s2 = ints(G2_POINTS), ints(G2_SCALARS)
    p1 = [g1.mul(g1_gen, k) for k in k1]
    p2 = [g2.mul(g2_gen, k) for k in k2]
    return x, y, p1, s1, p2, s2


def _aff(p):
    return None if p.infinity else [p.x, p.y]


def _load_when_written(path: str):
    """The Parameters another process saves at `path` (written whole, then
    renamed), once they are there."""
    import torch

    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


# ---------------------------------------------------------------- a rank
def _rank_main(port: int, rank: int, world: int, outdir: str) -> None:
    """One rank: every sharded computation, its blocks and points to
    `outdir/rank<rank>.json`."""
    import torch

    torch.set_num_threads(1)
    from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
    from ckb_zkp_tpu_torch.circuits import Mini
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops.field import device_field
    from ckb_zkp_tpu_torch.ops.msm import device_group
    from ckb_zkp_tpu_torch.parallel import (get_sharded_domain, global_mesh, init_multihost,
                                            msm_sharded, shard_put)
    from ckb_zkp_tpu_torch.r1cs import SynthesisMode, synthesize
    from ckb_zkp_tpu_torch.schemes import groth16

    init_multihost(f"localhost:{port}", world, rank, "gloo", device="cpu",
                   timeout_s=CHILD_TIMEOUT_S)
    mesh = global_mesh(device="cpu")
    assert mesh.size == world and mesh.rank == rank and mesh.device.type == "cpu"
    curve = get_curve("bn254")
    fr = curve.fr
    df = device_field(fr, "cpu")
    x, y, p1, s1, p2, s2 = _inputs(fr.modulus, curve.g1, curve.g2, curve.g1_gen, curve.g2_gen)
    out = {}

    sd = get_sharded_domain(fr, N_NTT, mesh)
    assert get_sharded_domain(fr, N_NTT, mesh) is sd
    xb, yb = (shard_put(df.encode(v), mesh) for v in (x, y))
    bx, by = sd.fft_t(xb), sd.fft_t(yb)
    out["fft_t"] = df.decode(bx)
    out["ifft_from_t"] = df.decode(sd.ifft_from_t(bx))
    out["conv"] = df.decode(sd.ifft_from_t(df.mul(bx, by)))
    out["coset_eval"] = df.decode(sd.coset_eval(xb))
    out["coset_interp"] = df.decode(sd.coset_interp(xb))

    for g, pts, sc in (("g1", p1, s1), ("g2", p2, s2)):
        dg = device_group(curve, g, "cpu")
        acc = msm_sharded(dg, dg.encode_points(pts), dg.encode_scalars(sc), mesh)
        out[f"msm_{g}"] = _aff(dg.decode_point(acc))

    # Mini first: its keys come first (the parent's), the chain's from the fifth process
    for name, params_file, shp, r, s in (
        ("mini", "mini_params.pt",
         synthesize(Mini.power_on(*MINI), fr.modulus, SynthesisMode.PROVE), 0, 0),
        ("chain", "chain_params.pt", square_chain_shape(CHAIN, fr.modulus), R, S),
    ):
        prms = _load_when_written(os.path.join(outdir, params_file))
        stages: dict = {}
        before = dict(mesh.stats)
        proof = groth16.create_proof_from_shape(prms, shp, r, s, timings=stages, mesh=mesh)
        pvk = groth16.prepare_verifying_key(curve, prms.vk)
        out[name] = {
            "proof": [_aff(proof.a), _aff(proof.b), _aff(proof.c)],
            "verifies": groth16.verify_proof(curve, pvk, proof, shp.input_assignment[1:]),
            "stages": sorted(stages), "collectives": mesh.stats["calls"] - before["calls"],
        }
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _single_main(outdir: str) -> None:
    """The port's single-device proofs of the same two proves, to
    `outdir/single.json` (a process of its own, beside the ranks)."""
    import torch

    torch.set_num_threads(1)
    from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
    from ckb_zkp_tpu_torch.circuits import Mini
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.r1cs import SynthesisMode, synthesize
    from ckb_zkp_tpu_torch.schemes import groth16

    curve = get_curve("bn254")
    fr = curve.fr.modulus
    shape = square_chain_shape(CHAIN, fr)
    chain_params = groth16.generate_parameters_from_shape(shape, curve, *TOXIC, device="cpu")
    path = os.path.join(outdir, "chain_params.pt")
    torch.save(chain_params, path + ".part")
    os.replace(path + ".part", path)  # the ranks read the port's setup from here
    out = {}
    for name, params, shp, r, s in (
        ("chain", chain_params, shape, R, S),
        ("mini", _load_when_written(os.path.join(outdir, "mini_params.pt")),
         synthesize(Mini.power_on(*MINI), fr, SynthesisMode.PROVE), 0, 0),
    ):
        proof = groth16.create_proof_from_shape(params, shp, r, s)
        out[name] = [_aff(proof.a), _aff(proof.b), _aff(proof.c)]
    with open(os.path.join(outdir, "single.json"), "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------- the cases
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Starts the four ranks, computes the single-device references while
    they run, returns (the ranks' outputs, the references)."""
    import torch

    from ckb_zkp_tpu.circuits import Mini as RefMini
    from ckb_zkp_tpu.host.pairing import get_curve
    from ckb_zkp_tpu.r1cs import SynthesisMode as RefMode
    from ckb_zkp_tpu.r1cs import synthesize as ref_synthesize
    from ckb_zkp_tpu.schemes import groth16 as ref_groth16
    from ckb_zkp_tpu_torch.convert import params_from_reference

    outdir = str(tmp_path_factory.mktemp("parallel"))
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(os.path.dirname(__file__)),
                                         env.get("PYTHONPATH", "")])
    procs = []
    for name, args in [(f"rank{r}", [str(port), str(r), str(WORLD)]) for r in range(WORLD)] + [
            ("single", ["single"])]:
        log = open(os.path.join(outdir, f"{name}.log"), "w")
        procs.append((name, subprocess.Popen([sys.executable, __file__, *args, outdir], env=env,
                                             stdout=log, stderr=subprocess.STDOUT), log))
    try:
        curve = get_curve("bn254")
        fr = curve.fr.modulus
        mini_shape = ref_synthesize(RefMini.power_on(*MINI), fr, RefMode.PROVE)
        mini_ref = ref_groth16.generate_parameters_from_shape(
            ref_synthesize(RefMini.power_off(), fr, RefMode.SETUP), curve, *TOXIC,
            host_mode=True)
        path = os.path.join(outdir, "mini_params.pt")
        torch.save(params_from_reference(mini_ref, "cpu"), path + ".part")
        os.replace(path + ".part", path)  # the carried keys, read by the ranks at their end
        refs = _references(curve, mini_ref, mini_shape)
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        for _, proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for _, proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    outs = {}
    for name, proc, _ in procs:
        with open(os.path.join(outdir, f"{name}.log")) as f:
            tail = f.read()[-3000:]
        assert proc.returncode == 0, f"{name} failed:\n{tail}"
        with open(os.path.join(outdir, f"{name}.json")) as f:
            outs[name] = json.load(f)
    for name in ("chain", "mini"):
        refs[name]["port"] = outs["single"][name]
    outs = [outs[f"rank{r}"] for r in range(WORLD)]
    return outs, refs


def _references(curve, mini_ref, mini_shape):
    """The JAX package's single-device results on the same inputs."""
    from ckb_zkp_tpu.bench_circuits import square_chain_shape
    from ckb_zkp_tpu.ops.field import device_field
    from ckb_zkp_tpu.ops.ntt import get_domain
    from ckb_zkp_tpu.schemes import groth16 as ref_groth16
    from ckb_zkp_tpu.schemes.groth16.qap import QapMatrices as RefQap

    fr = curve.fr
    x, y, p1, s1, p2, s2 = _inputs(fr.modulus, curve.g1, curve.g2, curve.g1_gen, curve.g2_gen)
    refs = {"x": x, "y": y}
    df = device_field(fr)
    dom = get_domain(fr, N_NTT)
    ex = df.encode(x)
    refs["ntt_x"] = df.decode(dom.ntt(ex))
    refs["coset_eval"] = df.decode(dom.coset_ntt(dom.intt(ex)))
    refs["coset_interp"] = df.decode(dom.coset_intt(ex))
    refs["msm_g1"] = _aff(curve.g1.msm(p1, s1))
    refs["msm_g2"] = _aff(curve.g2.msm(p2[:G2_SCALARS], s2))

    chain = square_chain_shape(CHAIN, fr.modulus)
    chain_ref = ref_groth16.generate_parameters_from_shape(chain, curve, *TOXIC, host_mode=True)
    for name, ref_params, shape, r, s in (("chain", chain_ref, chain, R, S),
                                          ("mini", mini_ref, mini_shape, 0, 0)):
        want = ref_groth16.create_proof_from_shape(
            ref_params, shape, r, s, qap=RefQap(shape, fr, host_mode=True))
        refs[name] = {"jax": [_aff(want.a), _aff(want.b), _aff(want.c)]}
    return json.loads(json.dumps(refs))  # the ranks' form: G2 coordinates as lists


def _concat(outs, key):
    return [v for o in outs for v in o[key]]


def test_sharded_fft_t_round_trip_and_convolution(world):
    """fft_t is the JAX package's single-device NTT in the transposed
    layout (X[k1 + n1 k2] = B[k1, k2], rows k1 split over the ranks),
    ifft_from_t brings it back, and fft_t -> pointwise -> ifft_from_t is
    the cyclic convolution of the host ints."""
    outs, refs = world
    from ckb_zkp_tpu.host.pairing import get_curve

    fr = get_curve("bn254").fr.modulus
    x, y = refs["x"], refs["y"]
    n1 = 1 << ((N_NTT.bit_length()) // 2)
    n2 = N_NTT // n1
    X = refs["ntt_x"]
    assert _concat(outs, "fft_t") == [X[k1 + n1 * k2] for k1 in range(n1) for k2 in range(n2)]
    assert _concat(outs, "ifft_from_t") == x
    conv = [sum(x[i] * y[(k - i) % N_NTT] for i in range(N_NTT)) % fr for k in range(N_NTT)]
    assert _concat(outs, "conv") == conv


def test_sharded_coset_transforms(world):
    """coset_eval and coset_interp, natural order, equal the JAX package's
    coset_ntt(intt(x)) and coset_intt(x)."""
    outs, refs = world
    assert _concat(outs, "coset_eval") == refs["coset_eval"]
    assert _concat(outs, "coset_interp") == refs["coset_interp"]


def test_sharded_msms(world):
    """G1 over 37 points (blocks of 10, the last padded) and G2 over 16
    points with 11 scalars: every rank's point equals the host-int MSM."""
    outs, refs = world
    for g in ("g1", "g2"):
        assert all(o[f"msm_{g}"] == refs[f"msm_{g}"] for o in outs), g


def test_sharded_square_chain_proof(world):
    """The sharded prove of square_chain_shape(254) (m = 512: the sharded
    witness map and the sharded MSMs) under the port's setup: the same
    proof on every rank, equal to the port's single-device proof and to
    the JAX package's host-mode proof, verifying; collective stages kept
    apart from the named ones."""
    outs, refs = world
    _check_proof(outs, refs, "chain")


def test_sharded_mini_proof_with_carried_keys(world):
    """Mini (m = 16 = d^2: n1 = n2 = 4, one row a rank) under the JAX
    package's host-mode keys carried by `convert.params_from_reference`
    (the exact layout: l_query pairs the aux scalars only): the same checks."""
    outs, refs = world
    _check_proof(outs, refs, "mini")


def _check_proof(outs, refs, name):
    want = refs[name]
    assert want["port"] == want["jax"]
    for o in outs:
        got = o[name]
        assert got["proof"] == want["jax"]
        assert got["verifies"] is True
        assert {"witness_map", "msm_a", "msm_b_g2", "msm_h", "msm_l",
                "witness_map_collectives", "msm_a_collectives"} <= set(got["stages"])
        assert ("msm_b_g1" in got["stages"]) == (name == "chain")  # Mini: r = 0
        assert got["collectives"] > 0


if __name__ == "__main__":
    if sys.argv[1] == "single":
        _single_main(sys.argv[2])
    else:
        _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
