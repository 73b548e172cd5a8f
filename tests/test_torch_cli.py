"""The port's CLI, curve registry, Edwards curves, framework codec and
native verifiers on the CPU, against the JAX package.

- A Groth16 Mini round trip over BN254 through the port's CLI with
  `--device cpu` (setup, prove, verify, a changed public input refused);
  the JAX package's `verify_cmd` accepts the port's files, and the port's
  `verify_cmd` accepts files that the JAX package's serializers wrote for
  keys and a proof from its host-int pipeline.
- The native C++ verifier on the port CLI's Groth16 cells (0, 2, 1 as the
  JAX package's test expects; skipped without g++, as that test skips).
- `tests/test_jubjub.py`'s Edwards case through the port's CLI.
- The argument refusals, and no `auto` device.
- jubjub and baby jubjub: points and their ark `PT` bytes equal the JAX
  package's.
- `struct_codec` bytes equal the JAX package's for ints, points of every
  group and dataclasses; Marlin's `.ipk` bytes equal the JAX CLI's, made
  on the host, and decode back to the port's classes on the device asked.
- `_read_artifact` takes the second format only when the ark codec refuses
  the bytes.

No JAX CLI prove and no jitted JAX call. Tolerance: none (bytes, points
and verdicts are exact)."""

import contextlib
import dataclasses
import importlib
import json
import random

import pytest
import torch
from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)

from ckb_zkp_tpu.circuits import Mini as RefMini
from ckb_zkp_tpu.cli import verify_cmd as ref_verify_cmd
from ckb_zkp_tpu.host import edwards_groups as ref_edwards
from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.host.ristretto import Curve25519 as RefCurve25519
from ckb_zkp_tpu.r1cs import SynthesisMode as RefMode
from ckb_zkp_tpu.r1cs import synthesize as ref_synthesize
from ckb_zkp_tpu.schemes import groth16 as ref_groth16
from ckb_zkp_tpu.schemes.groth16 import serialize as ref_ser
from ckb_zkp_tpu.schemes.groth16.qap import QapMatrices as RefQap
from ckb_zkp_tpu.schemes.marlin import ahp as ref_ahp
from ckb_zkp_tpu.schemes.marlin import pc as ref_pc
from ckb_zkp_tpu.serialize import ark_schemes as ref_ark
from ckb_zkp_tpu.serialize import struct_codec as ref_codec
from ckb_zkp_tpu_torch import contracts, native
from ckb_zkp_tpu_torch.circuits import Mini
from ckb_zkp_tpu_torch.curve import SUPPORTED, Curve, curves
from ckb_zkp_tpu_torch.host import edwards_groups
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.host.ristretto import Curve25519
from ckb_zkp_tpu_torch.schemes.marlin import ahp, pc
from ckb_zkp_tpu_torch.serialize import ark_schemes, struct_codec

torch.set_num_threads(1)
# the module (the package's `main` attribute is the function)
cli = importlib.import_module("ckb_zkp_tpu_torch.cli.main")


def _tamper(proof_file):
    """A copy of the proof JSON with the first public input's low bit flipped."""
    payload = json.loads(proof_file.read_text())
    raw = bytearray(bytes.fromhex(payload["params"]))
    raw[0] ^= 1
    payload["params"] = bytes(raw).hex()
    out = proof_file.with_name("tampered-" + proof_file.name)
    out.write_text(json.dumps(payload))
    return out


@pytest.fixture(scope="module")
def g16(tmp_path_factory):
    """The port CLI's Groth16 Mini files over BN254 on the CPU (setup seed 5,
    prove seed 6 and the publics 2, 3, 10, as tests/test_cli.py runs it)."""
    d = tmp_path_factory.mktemp("g16")
    with contextlib.chdir(d):
        assert cli.main(["--device", "cpu", "setup", "groth16", "bn254", "mini",
                         "--seed", "5"]) == 0
        assert cli.main(["--device", "cpu", "prove", "groth16", "bn254", "mini",
                         "2", "3", "10", "--seed", "6"]) == 0
    return d, d / "proof_files" / "groth16-bn254-mini.proof.json"


def test_groth16_mini_round_trip_on_the_cpu(g16):
    d, proof_file = g16
    assert sorted(p.name for p in (d / "setup_files").iterdir()) == [
        "groth16-bn254-mini.pk", "groth16-bn254-mini.vk"]
    payload = json.loads(proof_file.read_text())
    assert sorted(payload) == ["circuit", "curve", "params", "proof", "scheme"]
    assert (payload["circuit"], payload["scheme"], payload["curve"]) == (
        "mini", "groth16", "bn254")
    with contextlib.chdir(d):
        assert cli.main(["--device", "cpu", "verify", str(proof_file)]) == 0
        assert cli.main(["--device", "cpu", "verify", str(_tamper(proof_file))]) == 1


def test_the_reference_cli_verifies_the_port_files(g16):
    d, proof_file = g16
    with contextlib.chdir(d):
        assert ref_verify_cmd(str(proof_file))
        assert not ref_verify_cmd(str(_tamper(proof_file)))


def test_the_port_cli_verifies_the_reference_serializer_files(tmp_path, monkeypatch):
    """Keys from the JAX package's host-int setup and a proof from its
    host-int prover, in the files its serializers write."""
    rc = ref_curve("bn254")
    rng = random.Random(42)
    toxic = [rng.randrange(1, rc.fr.modulus) for _ in range(5)]
    shape = ref_synthesize(RefMini.power_off(), rc.fr.modulus, RefMode.SETUP)
    params = ref_groth16.generate_parameters_from_shape(shape, rc, *toxic, host_mode=True)
    pshape = ref_synthesize(RefMini.power_on(2, 3, 10), rc.fr.modulus, RefMode.PROVE)
    proof = ref_groth16.create_proof_from_shape(params, pshape, 7, 8,
                                                qap=RefQap(pshape, rc.fr, host_mode=True))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "setup_files").mkdir()
    (tmp_path / "setup_files" / "groth16-bn254-mini.vk").write_bytes(
        ref_ser.vk_to_bytes(rc, params.vk))
    proof_file = tmp_path / "mini.proof.json"
    proof_file.write_text(json.dumps({
        "circuit": "mini", "scheme": "groth16", "curve": "bn254",
        "params": (10).to_bytes(32, "little").hex(),
        "proof": ref_ser.proof_to_bytes(rc, proof).hex()}))
    assert cli.verify_cmd(str(proof_file), device="cpu")
    assert not cli.verify_cmd(str(_tamper(proof_file)), device="cpu")


def test_native_verifiers_on_the_cli_cells(g16):
    if not native.available():
        pytest.skip("g++ unavailable")
    assert native.selftest() == 0 and native.marlin_selftest() == 0
    d, proof_file = g16
    vk = (d / "setup_files" / "groth16-bn254-mini.vk").read_bytes()
    payload = json.loads(proof_file.read_text())
    proof, publics = bytes.fromhex(payload["proof"]), bytes.fromhex(payload["params"])
    wrong = (11).to_bytes(32, "little")
    assert native.groth16_verify_bn254(vk, proof, publics) == 0
    assert native.groth16_verify_bn254(vk, proof, wrong) == 2
    assert native.groth16_verify_bn254(vk, proof[:-4], publics) == 1
    assert native.groth16_verify_bn254(vk[:-9], proof, publics) == 1
    for cells in ((vk, proof, publics), (vk, proof, wrong), (vk, proof[:-4], publics)):
        assert contracts.universal_groth16_verifier("bn254", *cells) == \
            native.groth16_verify_bn254(*cells)


def test_the_native_library_builds_into_the_port_build_dir():
    if not native.available():
        pytest.skip("g++ unavailable")
    from ckb_zkp_tpu_torch.ops.cuda_build import BUILD_DIR

    assert str(native._build()).startswith(BUILD_DIR)


def test_cli_accepts_edwards_curves(tmp_path, monkeypatch):
    """tests/test_jubjub.py's CLI case, through the port on the CPU."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--device", "cpu", "setup", "spartan_nizk", "baby_jubjub", "mini"]) == 0
    assert cli.main(["--device", "cpu", "prove", "bulletproofs", "jubjub", "mini",
                     "2", "3", "10"]) == 0
    proof_file = tmp_path / "proof_files" / "bulletproofs-jubjub-mini.proof.json"
    assert cli.main(["--device", "cpu", "verify", str(proof_file)]) == 0
    assert cli.main(["--device", "cpu", "verify", str(_tamper(proof_file))]) == 1


@pytest.mark.parametrize("call", [
    lambda: cli._resolve_curve("jubjub", "groth16"),
    lambda: cli._resolve_curve("curve25519", "marlin"),
    lambda: cli._resolve_curve("secp256k1"),
    lambda: cli._circuit("sha", get_curve("bn254"), [], False),
    lambda: cli.prove_cmd("groth17", "bn254", "mini", ["2", "3", "10"], device="cpu"),
    lambda: cli.setup_cmd("bulletproofs", "bn254", "mini", device="cpu"),
    lambda: cli._plonk_composer(get_curve("bn254"), "sha", [], False),
    lambda: cli.main(["--device", "auto", "verify", "x.json"]),
    lambda: cli.main(["--device", "tpu", "verify", "x.json"]),
], ids=["edwards-for-groth16", "curve25519-for-marlin", "unknown-curve", "unknown-circuit",
        "unknown-scheme", "no-setup", "plonk-circuit", "auto-device", "tpu-device"])
def test_arguments_refused(call, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        call()


def test_verify_refuses_an_unknown_scheme(tmp_path):
    f = tmp_path / "p.json"
    f.write_text(json.dumps({"scheme": "groth17", "curve": "bn254", "circuit": "mini",
                             "params": "", "proof": ""}))
    with pytest.raises(SystemExit):
        cli.verify_cmd(str(f), device="cpu")


def test_cli_defaults_to_the_card():
    ns = cli._parser().parse_args(["verify", "x.json"])
    assert ns.device == "cuda"
    assert cli._parser()._option_string_actions["--device"].choices == ("cuda", "cpu")


# ---- the Edwards curves ----

EDWARDS = ("jubjub", "baby_jubjub")


@pytest.mark.parametrize("name", EDWARDS)
def test_edwards_points_and_pt_bytes_equal_the_reference(name):
    c, rc = edwards_groups.get_edwards_curve(name), ref_edwards.get_edwards_curve(name)
    g, rg = c.g1, rc.g1
    assert (g.q, g.order, c.fr.modulus, c.fq.modulus) == (rg.q, rg.order, rc.fr.modulus,
                                                         rc.fq.modulus)
    rng = random.Random(5)
    ks = [0, 1, 2, g.order - 1] + [rng.randrange(g.order) for _ in range(4)]
    pts = [g.mul(c.g1_gen, k) for k in ks]
    assert [(p.x, p.y) for p in pts] == [(p.x, p.y) for p in (rg.mul(rc.g1_gen, k) for k in ks)]
    PT, VPT = ark_schemes.PT, ark_schemes.Vec(ark_schemes.PT)
    want = ref_ark.ark_encode(rc, [rg.mul(rc.g1_gen, k) for k in ks], ref_ark.Vec(ref_ark.PT))
    got = ark_schemes.ark_encode(c, pts, VPT)
    assert got == want and len(got) == 8 + 32 * len(ks)
    assert ark_schemes.ark_decode(c, got, VPT, device="cpu") == pts
    assert [ark_schemes.ark_encode(c, p, PT) for p in pts] == [g.point_to_bytes(p) for p in pts]
    with pytest.raises(ValueError):  # a y with no x on the curve, or a short cell
        bad = next(bytes([i]) + bytes(31) for i in range(2, 255)
                   if g.point_from_bytes(bytes([i]) + bytes(31)) is None)
        ark_schemes.ark_decode(c, bad, PT, device="cpu")
    with pytest.raises(ValueError):
        ark_schemes.ark_decode(c, got[:-1], VPT, device="cpu")


# ---- the framework codec ----

@dataclasses.dataclass
class Pair:
    left: object
    right: object


def _codec_values(pkg):
    """One value of each kind the codec writes, from `pkg`'s host layers."""
    field = importlib.import_module(f"{pkg}.host.field")
    pairing = importlib.import_module(f"{pkg}.host.pairing")
    ristretto = importlib.import_module(f"{pkg}.host.ristretto")
    edwards = importlib.import_module(f"{pkg}.host.edwards_groups")
    bn, bls = pairing.get_curve("bn254"), pairing.get_curve("bls12_381")
    c25519, jj = ristretto.Curve25519(), edwards.get_jubjub()
    ints = [0, 1, 255, 256, 2**64, bn.fr.modulus - 1]
    return [
        (bn, ints + [None, True, False, b"", b"\x00\xff", "label", (1, [2, 3]), {4: 5}]),
        (bn, [bn.g1_gen, bn.g1.mul(bn.g1_gen, 7), bn.g1.infinity, bn.g2_gen,
              bn.g2.mul(bn.g2_gen, 3), bn]),
        (bls, [bls.g1.mul(bls.g1_gen, 9), bls.g2_gen]),
        (c25519, [c25519.g1_gen, c25519.g1.mul(c25519.g1_gen, 11), c25519]),
        (jj, [jj.g1_gen, jj.g1.mul(jj.g1_gen, 13), jj]),
        (bn, Pair([1, Pair(b"x", None)], (2, 3))),
        (bls, (bls.fr, [field.FieldSpec("f", 97, 5)], Pair(7, None))),
    ]


@pytest.mark.parametrize("i", range(7))
def test_struct_codec_bytes_equal_the_reference(i):
    """The copy's bytes and the JAX package's; a port dataclass (the last
    case's `FieldSpec`) goes through the CLI's stand-ins."""
    (rc, want_v), (c, got_v) = _codec_values("ckb_zkp_tpu")[i], _codec_values(
        "ckb_zkp_tpu_torch")[i]
    want = ref_codec.encode(rc, want_v)
    assert cli.struct_encode(c, got_v) == want
    if i < 6:  # no port dataclass: the copy itself writes the same bytes
        assert struct_codec.encode(c, got_v) == want
        assert struct_codec.encode(c, struct_codec.decode(c, want)) == want
    else:
        assert cli.struct_decode(c, want, device="cpu") == got_v


def test_stand_ins_carry_the_reference_fields():
    """Every dataclass of the codec's modules has the JAX package's name
    and fields (the port's `device` aside), so each CLI reads the other's
    framework-codec files."""
    classes = cli._codec_classes()
    assert len(classes) >= 30
    for cls in classes:
        ref = getattr(importlib.import_module(
            "ckb_zkp_tpu" + cls.__module__[len("ckb_zkp_tpu_torch"):]), cls.__name__)
        stand_in = cli._stand_in(cls)
        assert f"{stand_in.__module__}:{stand_in.__name__}" == ref_codec._qualname(ref)
        assert [f.name for f in dataclasses.fields(stand_in)] == [
            f.name for f in dataclasses.fields(ref)]


def test_marlin_ipk_bytes_equal_the_reference_cli():
    """`(index, index_rands, supported_degree)` of Mini's index as the
    JAX CLI writes `.ipk` (`cli/main.py:266-272`): the index polynomials
    take no hiding or degree bound, so their randomness is empty."""
    rc, c = ref_curve("bn254"), get_curve("bn254")
    ridx = ref_ahp.index(rc.fr, RefMini.power_off())
    idx = ahp.index(c.fr, Mini.power_off(), "cpu")
    assert all(p.hiding_bound is None and p.degree_bound is None for p in idx.iter_polys())
    want = ref_codec.encode(rc, (ridx, [ref_pc.Randomness([], None) for _ in ridx.iter_polys()],
                                 ridx.max_degree()))
    value = (idx, [pc.Randomness([], None) for _ in idx.iter_polys()], idx.max_degree())
    assert cli.struct_encode(c, value) == want
    back = cli.struct_decode(c, want, device="cpu")
    assert back == value and back[0].device == torch.device("cpu")
    assert type(back[0]) is ahp.Index and type(back[1][0]) is pc.Randomness


@pytest.mark.parametrize("name", ["ckb_zkp_tpu.schemes.groth16.types:Proof",
                                  "ckb_zkp_tpu_torch.schemes.groth16.types:Proof"])
def test_struct_codec_refuses_an_unregistered_class(name):
    """A record naming a dataclass that no stand-in registers is refused,
    where the JAX package's codec imports its module and decodes it."""
    c = get_curve("bn254")
    record = b"D" + bytes([len(name)]) + name.encode() + b"N" * 3
    with pytest.raises(struct_codec.DecodeError, match="unknown dataclass"):
        struct_codec.decode(c, record)
    with pytest.raises(struct_codec.DecodeError, match="unknown dataclass"):
        cli.struct_decode(c, record, device="cpu")
    if name.startswith("ckb_zkp_tpu."):
        assert type(ref_codec.decode(ref_curve("bn254"), record)).__name__ == "Proof"


def test_read_artifact_falls_back_only_on_a_refusal(tmp_path, monkeypatch):
    c = get_curve("bn254")
    spec = ark_schemes.Tup(ark_schemes.FR, ark_schemes.Vec(ark_schemes.FR))
    value = (5, [6, 7])
    ark_file, codec_file = tmp_path / "a", tmp_path / "b"
    ark_file.write_bytes(ark_schemes.ark_encode(c, value, spec))
    codec_file.write_bytes(cli.struct_encode(c, value))
    assert cli._read_artifact(c, ark_file, spec, "cpu") == value
    assert cli._read_artifact(c, codec_file, spec, "cpu") == value

    def launch_failed(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ark_schemes, "ark_decode", launch_failed)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cli._read_artifact(c, codec_file, spec, "cpu")


# ---- the curve registry ----

def test_curve_registry_msm_equals_the_host():
    assert curves() == SUPPORTED == ("bn254", "bls12_381", "curve25519")
    c = Curve("bn254")
    rng = random.Random(3)
    pts = [c.g1.mul(c.g1_gen, rng.randrange(1, c.fr.modulus)) for _ in range(3)]
    ks = [rng.randrange(c.fr.modulus) for _ in range(3)]
    assert c.vartime_multiscalar_mul(ks, pts, device="cpu") == c.g1.msm(pts, ks)
    assert c.device("g1", "cpu").device == torch.device("cpu")
    r = Curve("curve25519")
    assert r.fr.modulus == Curve25519().fr.modulus == RefCurve25519().fr.modulus
    with pytest.raises(NotImplementedError):
        r.pairing(r.g1_gen, r.g1_gen)
