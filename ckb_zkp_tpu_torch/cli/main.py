"""zkp CLI entry points (setup / prove / verify).

The port of `ckb_zkp_tpu/cli/main.py`: the same sub-commands, arguments,
circuits, curves, artifact names and bytes. Every command takes `device`
(default "cuda", `--device {cuda,cpu}` on the command line) and passes it
to each call that makes tensors; nothing falls back to the CPU.

    python3 -m ckb_zkp_tpu_torch.cli.main setup groth16 bn254 mini --seed 5
    python3 -m ckb_zkp_tpu_torch.cli.main prove groth16 bn254 mini 2 3 10 --seed 6
    python3 -m ckb_zkp_tpu_torch.cli.main verify proof_files/groth16-bn254-mini.proof.json
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import inspect
import json
import random
import sys
from pathlib import Path

from ..circuits import Hash, Mini
from ..host.pairing import get_curve
from ..schemes import groth16
from ..schemes.bulletproofs import arithmetic_circuit as bulletproofs
from ..schemes.groth16 import serialize as g16ser
from ..schemes.spartan import nizk as spartan_nizk
from ..schemes.spartan import snark as spartan_snark
from ..serialize import struct_codec
from ..serialize.tobytes import fr_bytes

SETUP_DIR = Path("setup_files")
PROOF_DIR = Path("proof_files")


def _resolve_curve(name: str, scheme: str | None = None):
    """Curve by CLI name (cli/src/zkp_prove.rs:164-169 string matching).

    curve25519 serves the non-pairing schemes (spartan/bulletproofs), like
    the reference's zkp-curve25519 configurations.
    """
    if name in ("curve25519", "jubjub", "baby_jubjub", "babyjubjub"):
        if scheme in ("groth16", "marlin", "plonk"):
            raise SystemExit(f"{scheme} needs a pairing curve (bn254|bls12_381)")
        if name == "curve25519":
            from ..host.ristretto import Curve25519

            return Curve25519()
        # reference curve sweep includes JubJub / Baby_JubJub for the DL
        # schemes (ckb-zkp README.md:283-288)
        from ..host.edwards_groups import get_edwards_curve

        return get_edwards_curve(name)
    try:
        return get_curve(name)
    except KeyError:
        raise SystemExit(
            f"unknown curve {name!r} "
            "(expected bn254|bls12_381|curve25519|jubjub|baby_jubjub)"
        )


def _circuit(name: str, curve, args: list[str], power_on: bool):
    if name == "mini":
        if not power_on:
            return Mini.power_off(), []
        x, y, z = (int(a) for a in args[:3])
        c = Mini.power_on(x, y, z)
        return c, c.publics
    if name == "hash":
        if not power_on:
            return Hash.power_off(curve.fr), []
        c = Hash.power_on(curve.fr, args[0].encode())
        return c, c.publics
    raise SystemExit(f"unknown circuit {name!r} (expected mini|hash)")


SCHEMES = (
    "groth16", "bulletproofs", "spartan_snark", "spartan_nizk",
    "marlin", "plonk",
)


# ---- the framework codec's files (`struct_codec`) ----
# The codec writes a dataclass as its module's name, its class name and its
# fields in order. The files that it writes and reads here carry the JAX
# package's names and fields, so that either CLI reads the other's files:
# the port's dataclasses of these modules cross as stand-ins that bear
# those names, without the port's `device` field, which decoding puts back.
_CODEC_MODULES = (
    "host.field", "schemes.marlin.ahp", "schemes.marlin.pc",
    "schemes.spartan.common", "schemes.spartan.nizk", "schemes.spartan.snark",
)
_PORT_PACKAGE = __name__.split(".")[0]
_CODEC_PACKAGE = "ckb_zkp_tpu"  # the module names in the codec's bytes


@functools.cache
def _stand_in(cls):
    """The registered stand-in of a port dataclass: the codec's name for it
    and its fields but `device`; `port_class` leads back."""
    names = [f.name for f in dataclasses.fields(cls) if f.name != "device"]
    s = dataclasses.make_dataclass(cls.__name__, names, namespace={"port_class": cls})
    s.__module__ = _CODEC_PACKAGE + cls.__module__[len(_PORT_PACKAGE):]
    return struct_codec.register(s)


@functools.cache
def _codec_classes() -> frozenset:
    """Every dataclass defined in `_CODEC_MODULES`, its stand-in registered."""
    out = set()
    for name in _CODEC_MODULES:
        mod = importlib.import_module(f"{_PORT_PACKAGE}.{name}")
        for _, cls in inspect.getmembers(mod, inspect.isclass):
            if dataclasses.is_dataclass(cls) and cls.__module__ == mod.__name__:
                _stand_in(cls)
                out.add(cls)
    return frozenset(out)


def _to_codec(v, classes):
    """`v` with each dataclass of `classes` in it as its stand-in."""
    if type(v) in classes:
        s = _stand_in(type(v))
        return s(*(_to_codec(getattr(v, f.name), classes) for f in dataclasses.fields(s)))
    if isinstance(v, (list, tuple)):
        return type(v)(_to_codec(x, classes) for x in v)
    if isinstance(v, dict):
        return {_to_codec(k, classes): _to_codec(x, classes) for k, x in v.items()}
    return v


def _from_codec(v, device):
    """The inverse of `_to_codec`: stand-ins back to the port's classes,
    each with a `device` field given `device`."""
    import torch

    cls = getattr(type(v), "port_class", None)
    if cls is not None:
        kw = {f.name: _from_codec(getattr(v, f.name), device) for f in dataclasses.fields(v)}
        if any(f.name == "device" for f in dataclasses.fields(cls)):
            kw["device"] = torch.device(device)
        return cls(**kw)
    if isinstance(v, (list, tuple)):
        return type(v)(_from_codec(x, device) for x in v)
    if isinstance(v, dict):
        return {_from_codec(k, device): _from_codec(x, device) for k, x in v.items()}
    return v


def struct_encode(curve, value) -> bytes:
    """`struct_codec.encode` of `value` as the JAX package's CLI writes it."""
    return struct_codec.encode(curve, _to_codec(value, _codec_classes()))


def struct_decode(curve, data: bytes, device="cuda"):
    """`struct_codec.decode` into the port's classes on `device`."""
    _codec_classes()
    return _from_codec(struct_codec.decode(curve, data), device)


# ---- universal-SRS persistence (marlin/plonk KZG powers live on device;
# artifacts store host affine points and re-encode on load) ----

def _srs_spec():
    """ark spec of the portable SRS tuple (KZG10 UniversalParams layout:
    reference cli setup files are CanonicalSerialize bytes, setup.rs:89-130)."""
    from ..serialize.ark_schemes import G1, G2, Tup, Vec

    return Tup(Vec(G1), Vec(G1), G1, G1, G2, G2)


def _nizk_setup_spec():
    from ..schemes.spartan.common import NizkParameters
    from ..schemes.spartan.nizk import R1CSInstance
    from ..serialize.ark_schemes import S, Tup

    return Tup(S(NizkParameters), S(R1CSInstance))


def _read_artifact(curve, path: Path, cls_or_spec, device="cuda"):
    """Load a setup artifact: ark-0.2 bytes (current format), falling back
    to the legacy framework struct codec for round-3 artifacts. Only the
    ark codec's refusal of foreign bytes (ValueError) takes the second
    format; any other error, a launch's among them, propagates."""
    from ..serialize.ark_schemes import ark_decode

    data = path.read_bytes()
    try:
        return ark_decode(curve, data, cls_or_spec, device)
    except ValueError:
        return struct_decode(curve, data, device)


def _srs_to_portable(srs, device="cuda"):
    from ..ops.msm import device_group

    dg1 = device_group(srs.curve, "g1", device)
    return (
        dg1.decode_points(srs.powers_of_g),
        dg1.decode_points(srs.powers_of_gamma_g),
        srs.g, srs.gamma_g, srs.h, srs.beta_h,
    )


def _srs_from_portable(curve, blob, device="cuda"):
    from ..ops.msm import device_group
    from ..schemes import kzg10

    powers_g, powers_gamma, g, gamma_g, h, beta_h = blob
    dg1 = device_group(curve, "g1", device)
    return kzg10.UniversalParams(
        curve=curve,
        powers_of_g=dg1.encode_points(powers_g),
        powers_of_gamma_g=dg1.encode_points(powers_gamma),
        g=g, gamma_g=gamma_g, h=h, beta_h=beta_h,
    )


def _mimc_composer(spec, preimage: bytes, image: int):
    """PLONK MiMC-preimage circuit through the composer front-end (the
    gate-level counterpart of the R1CS Hash circuit, cli/src/circuits/
    hash.rs): per round t = xl + C_i (add gate), t2 = t*t (mul gate),
    xl' = t2*t + xr (poly gate with the aux wire), 322 rounds; the final
    state is bound to the public image. Single-block preimages (<= field
    width) keep the gate count — and therefore the vk — canonical."""
    from ..gadgets.mimc import MIMC_ROUNDS, _bytes_to_blocks, constants
    from ..schemes.plonk import Composer

    p = spec.modulus
    cs = Composer(p)
    consts = constants(spec)
    blocks = _bytes_to_blocks(spec, preimage)
    if len(blocks) != 1:
        raise SystemExit(
            "plonk hash circuit supports single-block preimages "
            f"(<= {spec.nbytes} bytes)"
        )
    h = cs.alloc_and_assign(0)
    cs.constrain_to_constant(h, 0)
    h_val = 0
    for blk in blocks:
        xr = cs.alloc_and_assign(blk)
        xr_val = blk
        xl, xl_val = h, h_val
        for i in range(MIMC_ROUNDS):
            t_val = (xl_val + consts[i]) % p
            t = cs.alloc_and_assign(t_val)
            cs.create_add_gate((xl, 1), (xl, 0), t, q_c=consts[i])
            t2_val = t_val * t_val % p
            t2 = cs.alloc_and_assign(t2_val)
            cs.create_mul_gate(t, t, t2)
            new_val = (t2_val * t_val + xr_val) % p
            new_xl = cs.alloc_and_assign(new_val)
            cs.create_poly_gate(
                (t2, 0), (t, 0), (new_xl, -1), (xr, 1), 1, 0, 0
            )
            xl, xr, xl_val, xr_val = new_xl, xl, new_val, xl_val
        h, h_val = xl, xl_val
    cs.constrain_to_constant(h, 0, pi=image)
    return cs


def _plonk_composer(curve, circuit_name: str, args: list[str], power_on: bool):
    """Composer + publics for the plonk CLI circuits."""
    from ..gadgets.mimc import mimc_hash

    p = curve.fr.modulus
    if circuit_name == "mini":
        if not power_on:
            return _mini_composer(p, 0, 0, 0), []
        x, y, z = (int(a) for a in args[:3])
        return _mini_composer(p, x, y, z), [z]
    if circuit_name == "hash":
        if not power_on:
            return _mimc_composer(curve.fr, b"\x00", 0), []
        preimage = args[0].encode()
        image = mimc_hash(curve.fr, preimage)[2]
        return _mimc_composer(curve.fr, preimage, image), [image]
    raise SystemExit("plonk CLI supports the mini|hash circuits")


def _mini_composer(p: int, x: int, y: int, z: int):
    """PLONK mini circuit: x * (y + 2) = z, z public (composer gates —
    PLONK has its own front-end, like the reference's plonk::Composer)."""
    from ..schemes.plonk import Composer

    cs = Composer(p)
    vx = cs.alloc_and_assign(x)
    vy = cs.alloc_and_assign(y)
    vt = cs.alloc_and_assign((y + 2) % p)
    vz = cs.alloc_and_assign(x * (y + 2) % p)
    cs.create_add_gate((vy, 1), (vy, 0), vt, q_c=2)  # t = y + 2
    cs.create_mul_gate(vx, vt, vz)  # x * t = z_wire
    cs.constrain_to_constant(vz, 0, pi=z)  # bind z_wire to the public input
    return cs


def setup_cmd(scheme: str, curve_name: str, circuit_name: str, seed: int | None = None,
              device="cuda"):
    """Trusted/universal setup -> setup_files/* (cli/src/setup.rs:89-130).

    groth16 writes ark-compatible .pk/.vk byte files; the spartan variants
    write a .universal_setup artifact like the reference's spartan
    universal_setup files; marlin adds the index (.ipk, framework codec).
    """
    curve = _resolve_curve(curve_name, scheme)
    rng = random.Random(seed)
    circuit, _ = _circuit(circuit_name, curve, [], power_on=False)
    SETUP_DIR.mkdir(exist_ok=True)
    if scheme == "groth16":
        params = groth16.generate_random_parameters(circuit, curve, rng, device)
        pk_path = SETUP_DIR / f"{scheme}-{curve.name}-{circuit_name}.pk"
        vk_path = SETUP_DIR / f"{scheme}-{curve.name}-{circuit_name}.vk"
        pk_path.write_bytes(g16ser.parameters_to_bytes(params))
        vk_path.write_bytes(g16ser.vk_to_bytes(curve, params.vk))
        print(f"wrote {pk_path} and {vk_path}")
        return pk_path, vk_path
    if scheme == "spartan_snark":
        from ..serialize.ark_schemes import ark_encode

        setup = spartan_snark.generate_random_parameters(curve, circuit, rng, device)
        path = SETUP_DIR / f"{scheme}-{curve.name}-{circuit_name}.universal_setup"
        # snark::Parameters CanonicalSerialize bytes (cli/src/setup.rs:47-58)
        path.write_bytes(ark_encode(curve, setup))
        print(f"wrote {path}")
        return (path,)
    if scheme == "spartan_nizk":
        from ..serialize.ark_schemes import ark_encode

        r1cs = spartan_nizk.generate_r1cs(curve, circuit)
        params = spartan_nizk.generate_setup_parameters(
            curve, rng, r1cs.num_aux, r1cs.num_inputs, device
        )
        path = SETUP_DIR / f"{scheme}-{curve.name}-{circuit_name}.universal_setup"
        # nizk::Parameters CanonicalSerialize bytes (cli/src/setup.rs:60-72)
        path.write_bytes(ark_encode(curve, (params, r1cs), _nizk_setup_spec()))
        print(f"wrote {path}")
        return (path,)
    if scheme == "marlin":
        from ..schemes import marlin
        from ..schemes.marlin import ahp as marlin_ahp
        from ..serialize.ark_schemes import ark_encode

        probe = marlin_ahp.index(curve.fr, circuit, device)
        srs = marlin.universal_setup(curve, probe.max_degree(), rng, device)
        path = SETUP_DIR / f"{scheme}-{curve.name}-{circuit_name}.universal_setup"
        path.write_bytes(ark_encode(curve, _srs_to_portable(srs, device), _srs_spec()))
        # index once at setup and persist the ark-encoded ivk so verify
        # needs neither the SRS nor an O(n) re-index (zkp_verify.rs parity:
        # the reference verifier consumes only the vk artifact)
        circuit2, _ = _circuit(circuit_name, curve, [], power_on=False)
        ipk, ivk = marlin.index(srs, circuit2)
        vk_path = SETUP_DIR / f"{scheme}-{curve.name}-{circuit_name}.vk"
        vk_path.write_bytes(ark_encode(curve, ivk))
        # persist the index once so prove skips the O(n) re-index + index
        # commitments; the committer key is rebuilt from the SRS by trim()
        ipk_path = SETUP_DIR / f"{scheme}-{curve.name}-{circuit_name}.ipk"
        ipk_path.write_bytes(
            struct_encode(
                curve,
                (ipk.index, ipk.index_rands, ipk.committer_key.supported_degree),
            )
        )
        print(f"wrote {path}, {vk_path} and {ipk_path}")
        return (path, vk_path, ipk_path)
    if scheme == "plonk":
        from ..ops.hdomain import HDomain
        from ..schemes.plonk import Plonk, default_ks
        from ..schemes.plonk import serialize as pser
        from ..serialize.ark_schemes import ark_encode

        cs, _ = _plonk_composer(curve, circuit_name, [], power_on=False)
        max_degree = 4 * HDomain(curve.fr, cs.size(), device).size
        srs = Plonk.setup(curve, max_degree, rng, device)
        path = SETUP_DIR / f"{scheme}-{curve.name}-{circuit_name}.universal_setup"
        path.write_bytes(ark_encode(curve, _srs_to_portable(srs, device), _srs_spec()))
        # keygen once at setup (vk depends only on the circuit structure)
        # and persist the ark-encoded vk for verify
        _pk, vk = Plonk.keygen(curve, srs, cs, default_ks(curve.fr.modulus))
        vk_path = SETUP_DIR / f"{scheme}-{curve.name}-{circuit_name}.vk"
        vk_path.write_bytes(pser.vk_to_bytes(curve, vk))
        print(f"wrote {path} and {vk_path}")
        return (path, vk_path)
    raise SystemExit(
        "setup supports groth16|spartan_snark|spartan_nizk|marlin|plonk, "
        f"not {scheme!r}"
    )


def prove_cmd(scheme: str, curve_name: str, circuit_name: str, args: list[str], seed=None,
              device="cuda"):
    """Prove and write proof_files/*.proof.json (cli/src/zkp_prove.rs:16-173)."""
    if scheme not in SCHEMES:
        raise SystemExit(f"unknown scheme {scheme!r} (expected one of {SCHEMES})")
    curve = _resolve_curve(curve_name, scheme)
    circuit, publics = _circuit(circuit_name, curve, args, power_on=True)
    rng = random.Random(seed)
    name = f"{scheme}-{curve.name}-{circuit_name}"
    if scheme == "groth16":
        params = g16ser.parameters_from_bytes(
            curve, (SETUP_DIR / f"{name}.pk").read_bytes(), device
        )
        proof = groth16.create_random_proof(params, circuit, rng)
        proof_hex = g16ser.proof_to_bytes(curve, proof).hex()
    elif scheme == "bulletproofs":
        from ..serialize.ark_schemes import S, Tup, ark_encode

        gens, r1cs, proof = bulletproofs.create_random_proof(curve, circuit, rng, device)
        # reference blob: gens ++ r1cs ++ proof CanonicalSerialize bytes
        # (cli/src/zkp_prove.rs:51-59)
        proof_hex = ark_encode(
            curve, (gens, r1cs, proof),
            Tup(
                S(bulletproofs.Generators),
                S(bulletproofs.R1csCircuit),
                S(bulletproofs.Proof),
            ),
        ).hex()
    elif scheme == "spartan_snark":
        from ..serialize.ark_schemes import ark_encode

        setup = _read_artifact(
            curve, SETUP_DIR / f"{name}.universal_setup", spartan_snark.SnarkSetup, device
        )
        hashes = (
            setup.r1cs.r1cs_to_hash(),
            spartan_snark.snark_params_to_hash(curve, setup.params),
            spartan_snark.encode_to_hash(curve, setup.encode_commit),
        )
        proof = spartan_snark.create_snark_proof(
            curve, setup.params, setup.r1cs, circuit,
            setup.encode, setup.encode_commit, *hashes, rng, device,
        )
        # reference blob: proof bytes only; hashes are recomputed from the
        # setup keys at verify (cli/src/zkp_prove.rs:61-78)
        proof_hex = ark_encode(curve, proof).hex()
    elif scheme == "marlin":
        from ..schemes import marlin
        from ..schemes.marlin import pc as marlin_pc
        from ..serialize.ark_schemes import ark_decode, ark_encode

        srs = _srs_from_portable(
            curve, _read_artifact(
                curve, SETUP_DIR / f"{name}.universal_setup", _srs_spec(), device
            ), device
        )
        ipk_path = SETUP_DIR / f"{name}.ipk"
        vk_path = SETUP_DIR / f"{name}.vk"
        if ipk_path.exists() and vk_path.exists():
            # fast path: the setup-persisted index + ivk; only the committer
            # key (SRS power slices) is rebuilt, in O(1) device slicing
            index, index_rands, supported_degree = struct_decode(
                curve, ipk_path.read_bytes(), device
            )
            ivk = ark_decode(curve, vk_path.read_bytes(), marlin.IndexVerifierKey, device)
            ck, _vk = marlin_pc.trim(srs, supported_degree)
            ipk = marlin.IndexProverKey(
                index=index, index_rands=index_rands,
                index_verifier_key=ivk, committer_key=ck,
            )
        else:  # legacy artifacts: O(n) re-index
            circuit_off, _ = _circuit(circuit_name, curve, [], power_on=False)
            ipk, _ivk = marlin.index(srs, circuit_off)
        proof = marlin.create_random_proof(ipk, circuit, rng)
        proof_hex = ark_encode(curve, proof).hex()
    elif scheme == "plonk":
        from ..schemes.plonk import Plonk, default_ks
        from ..schemes.plonk import serialize as pser

        p = curve.fr.modulus
        srs = _srs_from_portable(
            curve, _read_artifact(
                curve, SETUP_DIR / f"{name}.universal_setup", _srs_spec(), device
            ), device
        )
        cs, publics = _plonk_composer(curve, circuit_name, args, power_on=True)
        pk, _vk = Plonk.keygen(curve, srs, cs, default_ks(p))
        proof = Plonk.prove(curve, pk, cs, rng)
        proof_hex = pser.proof_to_bytes(curve, proof).hex()
    else:  # spartan_nizk
        from ..serialize.ark_schemes import ark_encode

        params, r1cs = _read_artifact(
            curve, SETUP_DIR / f"{name}.universal_setup", _nizk_setup_spec(), device
        )
        hashes = (r1cs.r1cs_to_hash(), spartan_nizk.params_to_hash(curve, params))
        proof = spartan_nizk.create_nizk_proof(
            curve, params, r1cs, circuit, *hashes, rng, device
        )
        proof_hex = ark_encode(curve, proof).hex()
    PROOF_DIR.mkdir(exist_ok=True)
    out = PROOF_DIR / f"{name}.proof.json"
    payload = {
        "circuit": circuit_name,
        "scheme": scheme,
        "curve": curve.name,
        "params": b"".join(fr_bytes(curve, x) for x in publics).hex(),
        "proof": proof_hex,
    }
    out.write_text(json.dumps(payload))
    print(f"wrote {out}")
    return out


def verify_cmd(proof_file: str, device="cuda") -> bool:
    """Verify a proof JSON (cli/src/zkp_verify.rs:132-163)."""
    payload = json.loads(Path(proof_file).read_text())
    scheme = payload["scheme"]
    if scheme not in SCHEMES:
        raise SystemExit(f"unknown scheme {scheme!r} (expected one of {SCHEMES})")
    curve = _resolve_curve(payload["curve"], scheme)
    name = f"{scheme}-{curve.name}-{payload['circuit']}"
    raw = bytes.fromhex(payload["params"])
    nb = curve.fr.nbytes
    publics = [
        int.from_bytes(raw[i : i + nb], "little") for i in range(0, len(raw), nb)
    ]
    if scheme == "groth16":
        vk = g16ser.vk_from_bytes(curve, (SETUP_DIR / f"{name}.vk").read_bytes())
        proof = g16ser.proof_from_bytes(curve, bytes.fromhex(payload["proof"]))
        pvk = groth16.prepare_verifying_key(curve, vk)
        ok = groth16.verify_proof(curve, pvk, proof, publics)
    elif scheme == "bulletproofs":
        from ..serialize.ark_schemes import S, Tup, ark_decode

        gens, r1cs, proof = ark_decode(
            curve, bytes.fromhex(payload["proof"]),
            Tup(
                S(bulletproofs.Generators),
                S(bulletproofs.R1csCircuit),
                S(bulletproofs.Proof),
            ),
            device,
        )
        ok = bulletproofs.verify_proof(curve, gens, proof, r1cs, publics)
    elif scheme == "spartan_snark":
        from ..serialize.ark_schemes import ark_decode

        setup = _read_artifact(
            curve, SETUP_DIR / f"{name}.universal_setup", spartan_snark.SnarkSetup, device
        )
        proof = ark_decode(
            curve, bytes.fromhex(payload["proof"]), spartan_snark.SNARKProof, device
        )
        hashes = (
            setup.r1cs.r1cs_to_hash(),
            spartan_snark.snark_params_to_hash(curve, setup.params),
            spartan_snark.encode_to_hash(curve, setup.encode_commit),
        )
        ok = spartan_snark.verify_snark_proof(
            curve, setup.params, setup.r1cs, publics, proof,
            setup.encode_commit, *hashes, device,
        )
    elif scheme == "marlin":
        from ..schemes import marlin
        from ..serialize.ark_schemes import ark_decode

        vk_path = SETUP_DIR / f"{name}.vk"
        if vk_path.exists():
            # O(1) verify path: the ark-encoded ivk written at setup
            ivk = ark_decode(
                curve, vk_path.read_bytes(), marlin.IndexVerifierKey, device
            )
        else:  # legacy artifacts: derive the ivk from the universal SRS
            srs = _srs_from_portable(
                curve, _read_artifact(
                    curve, SETUP_DIR / f"{name}.universal_setup", _srs_spec(), device
                ), device
            )
            circuit_off, _ = _circuit(
                payload["circuit"], curve, [], power_on=False
            )
            _ipk, ivk = marlin.index(srs, circuit_off)
        proof = ark_decode(curve, bytes.fromhex(payload["proof"]), marlin.Proof, device)
        ok = marlin.verify_proof(ivk, proof, publics)
    elif scheme == "plonk":
        from ..schemes.plonk import Plonk, default_ks
        from ..schemes.plonk import serialize as pser

        p = curve.fr.modulus
        if not publics:
            # mirror the prove-side arity check: a missing 'params' field is
            # a malformed payload, not a proof about z = 0 (ADVICE r2)
            raise SystemExit("plonk proof payload carries no public input")
        # the composer is rebuilt only for the public-input vector layout
        # (O(gates)); the vk itself is the setup artifact
        if payload["circuit"] == "hash":
            cs = _mimc_composer(curve.fr, b"\x00", publics[0])
        else:
            cs = _mini_composer(p, 0, 0, publics[0])
        vk_path = SETUP_DIR / f"{name}.vk"
        if vk_path.exists():
            # the decoder gives the field's default device; the vk's
            # transforms run on `device`
            vk = dataclasses.replace(
                pser.vk_from_bytes(curve, vk_path.read_bytes()), device=device
            )
        else:  # legacy artifacts: keygen from the universal SRS
            srs = _srs_from_portable(
                curve, _read_artifact(
                    curve, SETUP_DIR / f"{name}.universal_setup", _srs_spec(), device
                ), device
            )
            _pk, vk = Plonk.keygen(curve, srs, cs, default_ks(p))
        proof = pser.proof_from_bytes(curve, bytes.fromhex(payload["proof"]))
        ok = Plonk.verify(curve, vk, cs.public_inputs(), proof)
    else:  # spartan_nizk
        from ..serialize.ark_schemes import ark_decode

        params, r1cs = _read_artifact(
            curve, SETUP_DIR / f"{name}.universal_setup", _nizk_setup_spec(), device
        )
        proof = ark_decode(
            curve, bytes.fromhex(payload["proof"]), spartan_nizk.NIZKProof, device
        )
        ok = spartan_nizk.verify_nizk_proof(
            curve, params, r1cs, publics, proof,
            r1cs.r1cs_to_hash(), spartan_nizk.params_to_hash(curve, params), device,
        )
    print("verify:", ok)
    return ok


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ckb-zkp-tpu-torch")
    ap.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="torch device the commands run on (default: cuda)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("setup")
    s.add_argument("scheme")
    s.add_argument("curve")
    s.add_argument("circuit")
    s.add_argument("--seed", type=int, default=None)
    pr = sub.add_parser("prove")
    pr.add_argument("scheme")
    pr.add_argument("curve")
    pr.add_argument("circuit")
    pr.add_argument("args", nargs="*")
    pr.add_argument("--seed", type=int, default=None)
    v = sub.add_parser("verify")
    v.add_argument("proof_file")
    return ap


def main(argv=None) -> int:
    ns = _parser().parse_args(argv)
    if ns.cmd == "setup":
        setup_cmd(ns.scheme, ns.curve, ns.circuit, ns.seed, ns.device)
    elif ns.cmd == "prove":
        prove_cmd(ns.scheme, ns.curve, ns.circuit, ns.args, ns.seed, ns.device)
    elif ns.cmd == "verify":
        return 0 if verify_cmd(ns.proof_file, ns.device) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
