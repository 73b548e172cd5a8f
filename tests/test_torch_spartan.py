"""The port's Spartan (NIZK and SNARK) on the CPU against the JAX package's.

- `DeviceSumcheck`'s round methods, `bind`, the eq tables and both GKR
  table functions on 2^4-2^6 tables, against the JAX package's eager
  `ops/sumcheck.py` (the same values out);
- the Mini circuit's NIZK and SNARK proofs on BN254 and curve25519, as
  `tests/test_spartan.py` seeds them: the port's own setup gives the JAX
  package's parameter bytes, and the port's prove over the JAX package's
  parameters carried across by `convert` (with the rng where the port's
  own setup left it) gives the JAX proof's bytes. The port runs with
  DEVICE_SUMCHECK_MIN patched to 2 (every sumcheck on its device tables)
  and, for the NIZK, FIXED_BASE_MSM_MIN patched to 2 inside the witness
  commitment (its rows' MSMs on BN254's RCB engine and on the Ristretto
  group), and in the port's own setup (BN254's generator lists as
  fixed-base MSMs, `generator_multiples`): the thresholds decide where
  work runs, never the proof;
- each package's verifier accepts the other's proof and refuses a changed
  public input; the codec agrees with the JAX package's both ways and
  refuses a cut or an invalid Ristretto point;
- the two contract verifiers give the JAX entry points' OK, ERR_VERIFY
  and ERR_ENCODING on JAX-made BN254 cells, and a RuntimeError raised
  inside a verifier is no verdict.

Tolerance: none (bytes and field values are exact). JAX runs eagerly."""

import random
from collections import namedtuple

import jax
import numpy as np
import pytest
import torch

from ckb_zkp_tpu import contracts as ref_contracts
from ckb_zkp_tpu.circuits import Mini as RefMini
from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.host.ristretto import Curve25519 as RefCurve25519
from ckb_zkp_tpu.ops import sumcheck as ref_sumcheck
from ckb_zkp_tpu.schemes.spartan import nizk as ref_nizk
from ckb_zkp_tpu.schemes.spartan import snark as ref_snark
from ckb_zkp_tpu.serialize import ark_schemes as ref_ark
from ckb_zkp_tpu.serialize.tobytes import fr_bytes
from ckb_zkp_tpu_torch import contracts, convert
from ckb_zkp_tpu_torch.circuits import Mini
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.host.ristretto import Curve25519
from ckb_zkp_tpu_torch.ops import msm, sumcheck
from ckb_zkp_tpu_torch.ops.limbs import to_numpy
from ckb_zkp_tpu_torch.schemes.spartan import nizk, snark
from ckb_zkp_tpu_torch.serialize.ark_schemes import S, Tup, ark_decode, ark_encode

torch.set_num_threads(1)
CURVES = {"bn254": (get_curve("bn254"), ref_curve("bn254")),
          "curve25519": (Curve25519(), RefCurve25519())}
Gate = namedtuple("Gate", "op g left_node right_node")


# ---------------------------------------------------------------- sumcheck tables
def _tables(ds, rds, rng, p, k, n):
    vals = [[rng.randrange(p) for _ in range(n)] for _ in range(k)]
    return ([ds.encode_table(v) for v in vals],
            [rds.encode_table(v) for v in vals])


def _same(ref, port):
    return np.array_equal(np.asarray(jax.device_get(ref)).astype(np.int64),
                          to_numpy(port).astype(np.int64))


def test_device_sumcheck_matches_jax():
    """Every round method, bind, firsts and the eq tables of the port's
    DeviceSumcheck (plain K1 on the CPU) give the JAX package's values on
    the same 2^4-2^6 tables."""
    curve, rcurve = CURVES["bn254"]
    p = curve.fr.modulus
    rng = random.Random(17)
    ds, rds = sumcheck.DeviceSumcheck(curve.fr, "cpu"), ref_sumcheck.DeviceSumcheck(rcurve.fr)
    (a, b, c, e), (ra, rb, rc, re) = _tables(ds, rds, rng, p, 4, 16)
    assert ds.cubic_round(a, b, c, e) == rds.cubic_round(ra, rb, rc, re)
    assert ds.quad_round(a, b) == rds.quad_round(ra, rb)
    assert ds.cubic3_round_many([(a, b, c), (b, c, e)]) == \
        rds.cubic3_round_many([(ra, rb, rc), (rb, rc, re)])
    assert ds.libra_p1_round(a, b, c, e) == rds.libra_p1_round(ra, rb, rc, re)
    assert ds.libra_p2_round(a, b, c, 12345) == rds.libra_p2_round(ra, rb, rc, 12345)
    r = rng.randrange(p)
    assert _same(rds.bind(ra, r), ds.bind(a, r))
    assert ds.first(a) == rds.first(ra) and ds.firsts(a, b) == rds.firsts(ra, rb)
    rs = [rng.randrange(p) for _ in range(6)]
    assert _same(rds.eval_eq(rs), ds.eval_eq(rs))
    (t,), (rt,) = _tables(ds, rds, rng, p, 1, 64)
    assert ds.decode_scalar(ds.eval_value(t, rs)) == rds.decode_scalar(rds.eval_value(rt, rs))
    # hyrax rounds: (G, n) tables halving along the instance axis
    G, n = 4, 8
    grids, rgrids = [], []
    for _ in range(3):
        rows = [[rng.randrange(p) for _ in range(n)] for _ in range(G)]
        grids.append(torch.stack([ds.encode_table(v) for v in rows]))
        rgrids.append(jax.numpy.stack([rds.encode_table(v) for v in rows]))
    TP, CE, EQ = grids
    rTP, rCE, rEQ = rgrids
    li, ri = [0, 1, 2, 3], [1, 2, 3, 0]
    mulmask = [True, False, True, False]
    assert ds.hyrax_p1_round(TP, CE, li, ri, mulmask) == rds.hyrax_p1_round(
        rTP, rCE, jax.numpy.asarray(li), jax.numpy.asarray(ri), jax.numpy.asarray(mulmask))
    assert _same(rds.bind_axis1(rTP, r), ds.bind_axis1(TP, r))
    (V, tpx, pg), (rV, rtpx, rpg) = _tables(ds, rds, rng, p, 3, n)
    tpx, rtpx, pg, rpg = tpx[:G], rtpx[:G], pg[:G], rpg[:G]
    assert ds.hyrax_p23_round(EQ, V, tpx, pg, mulmask) == rds.hyrax_p23_round(
        rEQ, rV, rtpx, rpg, jax.numpy.asarray(mulmask))
    assert _same(rds.one_hot_rows([3, 0, 7], n), ds.one_hot_rows([3, 0, 7], n))


def test_gkr_tables_match_jax():
    """Both GKR table functions (the port's segment sum in place of
    `segment_sum_sorted`) against the JAX package's, with several gates
    on one target, untouched targets, and both gate kinds."""
    curve, rcurve = CURVES["bn254"]
    p = curve.fr.modulus
    rng = random.Random(23)
    ds, rds = sumcheck.DeviceSumcheck(curve.fr, "cpu"), ref_sumcheck.DeviceSumcheck(rcurve.fr)
    bit_size, ng = 5, 16
    gates = [Gate(rng.randrange(2), g, rng.randrange(20), rng.randrange(20)) for g in range(ng)]
    gates[3] = gates[3]._replace(left_node=gates[2].left_node, op=gates[2].op)
    (eg, v), (reg, rv) = _tables(ds, rds, rng, p, 2, 32)
    for port, ref in zip(sumcheck.gkr_tables_phase_one(ds, eg, v, gates, bit_size),
                         ref_sumcheck.gkr_tables_phase_one(rds, reg, rv, gates, bit_size)):
        assert _same(ref, port)
    for port, ref in zip(sumcheck.gkr_tables_phase_two(ds, eg, v, gates, bit_size),
                         ref_sumcheck.gkr_tables_phase_two(rds, reg, rv, gates, bit_size)):
        assert _same(ref, port)
    only_adds = [g._replace(op=0) for g in gates]
    assert _same(ref_sumcheck.gkr_tables_phase_one(rds, reg, rv, only_adds, bit_size)[0],
                 sumcheck.gkr_tables_phase_one(ds, eg, v, only_adds, bit_size)[0])


# ---------------------------------------------------------------- Mini proofs
def _ref_run(kind, rcurve, seed):
    """The JAX package's Mini setup, proof and hashes (its thresholds as
    they are: host ints at this size)."""
    rng = random.Random(seed)
    if kind == "nizk":
        r1cs = ref_nizk.generate_r1cs(rcurve, RefMini.power_off())
        params = ref_nizk.generate_setup_parameters(rcurve, rng, r1cs.num_aux, r1cs.num_inputs)
        setup = (params, r1cs)
        hashes = (r1cs.r1cs_to_hash(), ref_nizk.params_to_hash(rcurve, params))
        proof = ref_nizk.create_nizk_proof(rcurve, params, r1cs, RefMini.power_on(2, 3, 10),
                                           *hashes, rng)
    else:
        setup = ref_snark.generate_random_parameters(rcurve, RefMini.power_off(), rng)
        hashes = (setup.r1cs.r1cs_to_hash(), ref_snark.snark_params_to_hash(rcurve, setup.params),
                  ref_snark.encode_to_hash(rcurve, setup.encode_commit))
        proof = ref_snark.create_snark_proof(
            rcurve, setup.params, setup.r1cs, RefMini.power_on(2, 3, 10), setup.encode,
            setup.encode_commit, *hashes, rng)
    return setup, hashes, proof


def _port_verify(kind, curve, setup, hashes, proof, inputs):
    if kind == "nizk":
        params, r1cs = setup
        return nizk.verify_nizk_proof(curve, params, r1cs, inputs, proof, *hashes, device="cpu")
    return snark.verify_snark_proof(curve, setup.params, setup.r1cs, inputs, proof,
                                    setup.encode_commit, *hashes, device="cpu")


def _ref_verify(kind, rcurve, setup, hashes, proof, inputs):
    if kind == "nizk":
        params, r1cs = setup
        return ref_nizk.verify_nizk_proof(rcurve, params, r1cs, inputs, proof, *hashes)
    return ref_snark.verify_snark_proof(rcurve, setup.params, setup.r1cs, inputs, proof,
                                        setup.encode_commit, *hashes)


def _setup_bytes(kind, curve, setup, ark):
    if kind == "nizk":
        return ark(curve, setup[0]) + ark(curve, setup[1])
    return ark(curve, setup)


@pytest.mark.parametrize("kind", ["nizk", "snark"])
@pytest.mark.parametrize("name", ["bn254", "curve25519"])
def test_mini_proof_bytes_equal_jax(monkeypatch, kind, name):
    curve, rcurve = CURVES[name]
    seed = 55 if kind == "nizk" else 99
    rsetup, rhashes, rproof = _ref_run(kind, rcurve, seed)
    want = ref_ark.ark_encode(rcurve, rproof)

    monkeypatch.setattr(sumcheck, "DEVICE_SUMCHECK_MIN", 2)
    device_rows = []
    if kind == "nizk":
        real = nizk.packing_poly_commit

        def packing(*args, **kw):
            # the witness commitment's rows on the device
            with monkeypatch.context() as m:
                m.setattr(msm, "FIXED_BASE_MSM_MIN", 2)
                out = real(*args, **kw)
            device_rows.append(len(out[0]))
            return out

        monkeypatch.setattr(nizk, "packing_poly_commit", packing)
    dev_rounds = []
    real_cubic = sumcheck.DeviceSumcheck.cubic_round
    real_many = sumcheck.DeviceSumcheck.cubic3_round_many
    monkeypatch.setattr(sumcheck.DeviceSumcheck, "cubic_round",
                        lambda self, *a: dev_rounds.append(1) or real_cubic(self, *a))
    monkeypatch.setattr(sumcheck.DeviceSumcheck, "cubic3_round_many",
                        lambda self, *a: dev_rounds.append(3) or real_many(self, *a))

    rng = random.Random(seed)
    fixed_base_rows = []
    real_fixed_base = msm.DeviceCurveGroup.fixed_base_msm
    real_generators = msm.generator_multiples

    def generators(*args, **kw):
        # the setup's generator lists on the device (BN254's fixed-base MSM)
        with monkeypatch.context() as m:
            m.setattr(msm, "FIXED_BASE_MSM_MIN", 2)
            return real_generators(*args, **kw)

    with monkeypatch.context() as m:
        m.setattr(msm, "generator_multiples", generators)
        m.setattr(msm.DeviceCurveGroup, "fixed_base_msm", lambda self, t, s, *a: (
            fixed_base_rows.append(s.shape[0]) or real_fixed_base(self, t, s, *a)))
        if kind == "nizk":
            r1cs = nizk.generate_r1cs(curve, Mini.power_off())
            own = (nizk.generate_setup_parameters(curve, rng, r1cs.num_aux, r1cs.num_inputs,
                                                  device="cpu"), r1cs)
        else:
            own = snark.generate_random_parameters(curve, Mini.power_off(), rng, device="cpu")
    assert bool(fixed_base_rows) == (name == "bn254")
    if kind == "nizk":
        setup = convert.spartan_nizk_params_from_reference(*rsetup)
        hashes = (setup[1].r1cs_to_hash(), nizk.params_to_hash(curve, setup[0]))
        proof = nizk.create_nizk_proof(curve, *setup, Mini.power_on(2, 3, 10), *hashes, rng,
                                       device="cpu")
    else:
        setup = convert.spartan_snark_setup_from_reference(rsetup)
        hashes = (setup.r1cs.r1cs_to_hash(), snark.snark_params_to_hash(curve, setup.params),
                  snark.encode_to_hash(curve, setup.encode_commit))
        proof = snark.create_snark_proof(
            curve, setup.params, setup.r1cs, Mini.power_on(2, 3, 10), setup.encode,
            setup.encode_commit, *hashes, rng, device="cpu")
    assert hashes == rhashes
    assert _setup_bytes(kind, curve, own, ark_encode) == \
        _setup_bytes(kind, rcurve, rsetup, ref_ark.ark_encode)
    got = ark_encode(curve, proof)
    assert got == want
    assert dev_rounds and (1 if kind == "nizk" else 3) in dev_rounds
    assert device_rows == ([] if kind == "snark" else [len(proof.r1cs_satisfied_proof
                                                           .commit_witness)])

    # each verifier on the other package's proof, and a changed input refused
    cls = nizk.NIZKProof if kind == "nizk" else snark.SNARKProof
    rcls = ref_nizk.NIZKProof if kind == "nizk" else ref_snark.SNARKProof
    from_ref = ark_decode(curve, want, cls)
    assert ark_encode(curve, from_ref) == want
    assert _port_verify(kind, curve, setup, hashes, from_ref, [10]) is True
    assert _port_verify(kind, curve, setup, hashes, from_ref, [11]) is False
    from_port = ref_ark.ark_decode(rcurve, got, rcls)
    assert _ref_verify(kind, rcurve, rsetup, rhashes, from_port, [10]) is True


@pytest.mark.parametrize("cut", ["truncated", "invalid"])
def test_codec_refuses_a_bad_ristretto_point(cut):
    """A Ristretto point cut short, or 32 bytes that decode to no point
    (s negative: odd), raises ValueError, as the JAX package's codec."""
    curve, rcurve = CURVES["curve25519"]
    pt = curve.g1.mul(curve.g1_gen, 5)
    data = ark_encode(curve, pt, "pt")
    assert data == ref_ark.ark_encode(rcurve, RefCurve25519().g1.mul(rcurve.g1_gen, 5), "pt")
    bad = data[:31] if cut == "truncated" else bytes([1]) + data[1:]
    for dec, c in ((ark_decode, curve), (ref_ark.ark_decode, rcurve)):
        with pytest.raises(ValueError):
            dec(c, bad, "pt")
    assert ark_decode(curve, data, "pt") == pt


def _outcome(fn):
    try:
        return fn()
    except (ValueError, EOFError, IndexError) as e:
        return type(e)


@pytest.mark.parametrize("case", ["matrix", "g1_batch"])
def test_codec_fast_paths_equal_the_jax_walk(case, monkeypatch):
    """The codec's fast paths give the JAX package's generic walk's bytes
    and values, and its errors on cut and corrupted bytes: the R1CS
    matrices in one pass (coefficients 0, 1, p - 1, both Index kinds, an
    empty row), and compressed G1 points with DEVICE_DECODE_MIN patched to
    2 (square roots as one batch; infinity among them; an x with no root)."""
    from ckb_zkp_tpu_torch.serialize import ark_schemes

    curve, rcurve = CURVES["bn254"]
    p, q = curve.fr.modulus, curve.fq.modulus
    if case == "matrix":
        spec = ark_schemes.MATRIX
        value = [[(1, "A", 3), (p - 1, "I", 0)], [], [(0, "A", 1 << 40)], [(7, "I", 2)]]
        data = ref_ark.ark_encode(rcurve, value, spec)
        at = 8 + 8 + 32  # the first entry's Index tag, after its coefficient
        corrupt = [data[:at] + b"\x02" + data[at + 1:], data[:16] + b"\xff" * 32 + data[at:]]
    else:
        monkeypatch.setattr(ark_schemes, "DEVICE_DECODE_MIN", 2)
        spec = ark_schemes.Vec(ark_schemes.PT)
        value = [curve.g1.mul(curve.g1_gen, k) for k in (3, 5, 7)] + [curve.g1.infinity]
        data = ref_ark.ark_encode(rcurve, [ref_curve("bn254").g1.mul(rcurve.g1_gen, k)
                                           for k in (3, 5, 7)] + [rcurve.g1.infinity], spec)
        x = next(x for x in range(2, 100) if pow((x ** 3 + 3) % q, (q - 1) // 2, q) != 1)
        corrupt = [data[:40] + x.to_bytes(32, "little") + data[72:]]  # the second point's x
    assert ark_encode(curve, value, spec) == data
    assert ark_decode(curve, data, spec, device="cpu") == value
    for bad in corrupt + [data[:n] for n in (3, 12, 30, 47, 49, 60, len(data) - 1)]:
        want = _outcome(lambda: ref_ark.ark_decode(rcurve, bad, spec))
        got = _outcome(lambda: ark_decode(curve, bad, spec, device="cpu"))
        if isinstance(want, type):
            assert got is want
        else:
            assert ark_encode(curve, got, spec) == ref_ark.ark_encode(rcurve, want, spec)


# ---------------------------------------------------------------- contracts
def _frs(rcurve, xs):
    return b"".join(fr_bytes(rcurve, x) for x in xs)


@pytest.fixture(scope="module")
def cells():
    """The JAX package's BN254 Mini cells of both Spartan contracts."""
    _, rcurve = CURVES["bn254"]
    out = {}
    for kind, seed in (("nizk", 55), ("snark", 99)):
        setup, _, proof = _ref_run(kind, rcurve, seed)
        if kind == "nizk":
            vk = ref_ark.ark_encode(rcurve, setup, ref_ark.Tup(
                ref_ark.S(type(setup[0])), ref_ark.S(ref_nizk.R1CSInstance)))
        else:
            vk = ref_ark.ark_encode(
                rcurve, (setup.params, setup.r1cs, setup.encode_commit),
                ref_ark.Tup(ref_ark.S(ref_snark.SnarkParameters),
                            ref_ark.S(ref_nizk.R1CSInstance),
                            ref_ark.S(ref_snark.EncodeCommit)))
        out[kind] = (vk, ref_ark.ark_encode(rcurve, proof))
    return out


@pytest.mark.parametrize("kind", ["nizk", "snark"])
def test_contract_verifiers_give_the_jax_codes(cells, kind, monkeypatch):
    _, rcurve = CURVES["bn254"]
    vk, proof = cells[kind]
    port = getattr(contracts, f"universal_spartan_{kind}_verifier")
    ref = getattr(ref_contracts, f"universal_spartan_{kind}_verifier")
    cases = [(vk, proof, _frs(rcurve, [10])), (vk, proof, _frs(rcurve, [11])),
             (vk, proof[:-5], _frs(rcurve, [10])), (vk, proof, b"\x01\x02")]
    codes = [port("bn254", *c, device="cpu") for c in cases]
    assert codes == [ref("bn254", *c) for c in cases]
    assert codes == [contracts.OK, contracts.ERR_VERIFY, contracts.ERR_ENCODING,
                     contracts.ERR_ENCODING]
    # the vk cell as the port decodes it re-encodes to the same bytes
    cls = (Tup(S(nizk.NizkParameters), S(nizk.R1CSInstance)) if kind == "nizk" else
           Tup(S(snark.SnarkParameters), S(nizk.R1CSInstance), S(snark.EncodeCommit)))
    assert ark_encode(get_curve("bn254"), ark_decode(get_curve("bn254"), vk, cls), cls) == vk

    def launch_failed(*a, **kw):
        raise RuntimeError("zkp_mont_mul: CUDA error 700")

    module = nizk if kind == "nizk" else snark
    monkeypatch.setattr(module, f"verify_{kind}_proof", launch_failed)
    with pytest.raises(RuntimeError):
        port("bn254", vk, proof, _frs(rcurve, [10]), device="cpu")
