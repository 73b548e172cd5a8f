"""The port's discrete-log device layer on the CPU: the plain K1 at the two
moduli of curve25519 (2^255 - 19, one spare bit, and the group order l)
against host ints; the Edwards point operations against the JAX package's
eager `ops/edwards.py`, limb for limb, and against the host Ristretto
group; the Ristretto MSM and `msm_over_fixed_base` (with its threshold
patched down, so the device branch runs) against the host MSM, on BN254's
RCB engine and on the Ristretto group, with the cache of encoded lists.
Tolerance: none (canonical limbs; Ristretto points compared as group
elements and by their encoding)."""

import copy
import random

import jax
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.ristretto import Curve25519 as RefCurve25519
from ckb_zkp_tpu.ops import edwards as ref_ed
from ckb_zkp_tpu.ops.ristretto_device import device_ristretto_group as ref_group
from ckb_zkp_tpu_torch.host.curves import WeierstrassGroup
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.host.ristretto import L, P, Curve25519, RistrettoPoint
from ckb_zkp_tpu_torch.ops import edwards, msm
from ckb_zkp_tpu_torch.ops.field import DeviceField
from ckb_zkp_tpu_torch.ops.limbs import to_numpy, to_torch
from ckb_zkp_tpu_torch.ops.msm import DeviceCurveGroup
from ckb_zkp_tpu_torch.ops.ristretto_device import device_ristretto_group

torch.set_num_threads(1)
CURVE = Curve25519()
G = CURVE.g1


def _points(n, seed):
    rng = random.Random(seed)
    return [G.mul(CURVE.g1_gen, rng.randrange(1, L)) for _ in range(n)]


@pytest.mark.parametrize("spec", [CURVE.fq, CURVE.fr], ids=["2^255-19", "l"])
def test_plain_k1_add_sub_at_curve25519_moduli(spec):
    """mul, sqr, add and sub of the plain field against host ints, with
    0, 1, p - 1 and R mod p (p - 1 + p - 1 and (p - 1)^2 at the edge of
    2^255 - 19's one spare bit)."""
    df = DeviceField(spec, "cpu")
    p = spec.modulus
    assert df.L == 16 and spec.bits <= 16 * df.L - 1
    rng = random.Random(5)
    edges = [0, 1, p - 1, df.R, p - 2, (1 << 254) % p]
    a = edges + [rng.randrange(p) for _ in range(58)]
    b = [p - 1, p - 1, p - 1, df.R, p - 1, p - 1] + [rng.randrange(p) for _ in range(58)]
    ta, tb = df.encode(a), df.encode(b)
    assert df.decode(df.mul(ta, tb)) == [x * y % p for x, y in zip(a, b)]
    assert df.decode(df.sqr(ta)) == [x * x % p for x in a]
    assert df.decode(df.add(ta, tb)) == [(x + y) % p for x, y in zip(a, b)]
    assert df.decode(df.sub(ta, tb)) == [(x - y) % p for x, y in zip(a, b)]
    assert df.decode(df.neg(ta)) == [-x % p for x in a]
    assert df.decode(df.from_mont(df.to_mont(df.from_mont(ta)))) == [
        x * pow(df.R, -1, p) % p for x in df.decode(ta)]


def test_edwards_ops_match_jax_and_the_host_group():
    """ed_add/ed_double/ed_neg on the same limbs as the JAX package's eager
    `ops/edwards.py`: the same limbs out; and as host points equal to the
    host group's add, double and neg, with the identity, P == Q and
    P == -Q among the operands."""
    a, b, c = _points(3, 7)
    ident = G.infinity()
    left = [a, a, a, ident, ident, b, c]
    right = [a, G.neg(a), ident, a, ident, c, b]
    rdg = ref_group()
    dg = device_ristretto_group(device="cpu")
    rP, rQ = rdg.encode_points(left), rdg.encode_points(right)
    tP = tuple(to_torch(np.asarray(x), "cpu") for x in rP)
    tQ = tuple(to_torch(np.asarray(x), "cpu") for x in rQ)
    for x, y in zip(tP, dg.encode_points(left)):
        assert torch.equal(x, y)

    def same(ref, port):
        return all(np.array_equal(np.asarray(jax.device_get(u)), to_numpy(v))
                   for u, v in zip(ref, port))

    got_add = edwards.ed_add(dg.fq, dg._d2, tP, tQ)
    assert same(ref_ed.ed_add(rdg.fq, rdg._d2, rP, rQ), got_add)
    got_dbl = edwards.ed_double(dg.fq, tP)
    assert same(ref_ed.ed_double(rdg.fq, rP), got_dbl)
    assert same(ref_ed.ed_neg(rdg.fq, rP), edwards.ed_neg(dg.fq, tP))
    assert same(ref_ed.ed_identity(rdg.fq, (2,)), edwards.ed_identity(dg.fq, (2,)))
    adds = dg.decode_points_host(got_add)
    assert adds == [G.add(x, y) for x, y in zip(left, right)]
    assert [q.encode() for q in adds] == [G.add(x, y).encode() for x, y in zip(left, right)]
    assert adds[1] == ident and adds[4] == ident
    assert dg.decode_points_host(got_dbl) == [G.double(x) for x in left]
    assert dg.decode_points_host(edwards.ed_neg(dg.fq, tP)) == [G.neg(x) for x in left]


@pytest.mark.parametrize("n", [5, 40])
def test_ristretto_msm_matches_the_host(n):
    """The generic Pippenger over the Edwards ops against the host MSM, an
    identity point, a zero scalar and l - 1 among the operands; as one
    `msm` and inside a `msm_many` batch over the same points."""
    rng = random.Random(n)
    pts = _points(n, n + 1)
    pts[2] = G.infinity()
    sc = [rng.randrange(L) for _ in range(n)]
    sc[1], sc[3] = 0, L - 1
    want = G.msm(pts, sc)
    dg = device_ristretto_group(device="cpu")
    enc = dg.encode_points(pts)
    got = dg.decode_point(dg.msm(enc, dg.encode_scalars(sc)))
    assert got == want and got.encode() == want.encode()
    if n == 5:
        sc2 = [rng.randrange(L) for _ in range(n)]
        many = dg.msm_many([(enc, dg.encode_scalars(sc)), (enc, dg.encode_scalars(sc2))])
        assert [dg.decode_point(m) for m in many] == [want, G.msm(pts, sc2)]


@pytest.mark.parametrize("name", ["bn254", "curve25519"])
def test_msm_over_fixed_base_device_branch_and_cache(monkeypatch, name):
    """`msm_over_fixed_base` with FIXED_BASE_MSM_MIN patched to 2: the
    device MSM (BN254: RCB engine; curve25519: the Ristretto group) equals
    the host MSM; the list's encoding is made once (a hit), again for a new
    list of the same points (a miss), and not kept with cache=False; a
    prefix below the threshold stays on the host; the packing rows'
    `msm_over_fixed_base_many` against the host."""
    curve = CURVE if name == "curve25519" else get_curve("bn254")
    r = curve.fr.modulus
    rng = random.Random(3)
    gens = [curve.g1.mul(curve.g1_gen, rng.randrange(1, r)) for _ in range(6)]
    sc = [rng.randrange(r) for _ in range(6)]
    monkeypatch.setattr(msm, "FIXED_BASE_MSM_MIN", 2)
    monkeypatch.setattr(msm, "_fixed_base_cache", {})
    dg = msm._fixed_base_group(curve, "cpu")
    encodes = []
    real = type(dg).encode_points
    monkeypatch.setattr(type(dg), "encode_points",
                        lambda self, pts: encodes.append(len(pts)) or real(self, pts))
    got = msm.msm_over_fixed_base(curve, gens, sc[:5], device="cpu")
    assert got == curve.g1.msm(gens[:5], sc[:5])
    assert msm.msm_over_fixed_base(curve, gens, [1], device="cpu") == gens[0]
    rows = [sc[:3], sc[3:]]
    assert msm.msm_over_fixed_base_many(curve, gens, rows, device="cpu") == [
        curve.g1.msm(gens[:3], row) for row in rows]
    assert encodes == [6]  # one encoding of the list, then hits
    again = list(gens)
    msm._encoded_list(dg, again, True)
    assert encodes == [6, 6] and len(msm._fixed_base_cache) == 2
    msm._encoded_list(dg, gens[:4], False)
    assert encodes == [6, 6, 4] and len(msm._fixed_base_cache) == 2
    key = (id(gens), "cpu")
    assert msm._fixed_base_cache[key][0] is gens


def test_check_jacobian_refuses_only_an_a_nonzero_weierstrass_group():
    """The generic branch does not read `a` (the Ristretto host group has
    none); an a != 0 short-Weierstrass group is still refused."""
    device_ristretto_group(device="cpu")._check_jacobian()
    curve = copy.copy(get_curve("bn254"))
    g1 = curve.g1
    curve.g1 = WeierstrassGroup(g1.f, 1, g1.b, g1.order)
    dg = DeviceCurveGroup(curve, "g1", "cpu")
    with pytest.raises(ValueError, match="a = 0"):
        dg.msm(dg.encode_points([curve.g1_gen] * 2), dg.encode_scalars([1, 2]))


def test_ristretto_points_carry_from_the_reference():
    """The copied host group gives the reference's points and bytes."""
    ref = RefCurve25519()
    k = 123456789
    a, b = CURVE.g1.mul(CURVE.g1_gen, k), ref.g1.mul(ref.g1_gen, k)
    assert (a.X, a.Y, a.Z, a.T) == (b.X, b.Y, b.Z, b.T) and a.encode() == b.encode()
    assert RistrettoPoint.decode(a.encode()) == a and P == 2**255 - 19
