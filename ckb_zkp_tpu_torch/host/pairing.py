# Copied from ckb_zkp_tpu/host/pairing.py (host ints and numpy only): the port keeps its own copy.
"""Host-side pairing engine: BN254 ("bn_256") and BLS12-381.

Computes the optimal-ate pairing exactly over Python integers. Pairings are
O(1) per proof (verifier side), so they live on the host; the reference does
the same work via arkworks `PairingEngine`
(ckb-zkp groth16/src/verifier.rs:18-44).

Design: the Miller loop runs on the *untwisted* image of G2 inside E(Fq12)
with textbook affine line functions. This trades constant-factor speed for a
single generic, auditable code path shared by both curve families (D-type and
M-type twists). TODO(perf): x-chain hard part of the final exponentiation.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

from .curves import AffinePoint, Fq2Field, Fq12Field, IntField, WeierstrassGroup
from .field import FieldSpec
from .tower import Tower, Fq12E


@dataclass(eq=False)  # identity hash: instances are lru-cached singletons
class PairingCurve:
    name: str
    fq: FieldSpec
    fr: FieldSpec
    tower: Tower = field(repr=False)
    g1: WeierstrassGroup = field(repr=False)  # over Fq
    g2: WeierstrassGroup = field(repr=False)  # over Fq2 (the twist)
    g1_gen: AffinePoint = field(repr=False)
    g2_gen: AffinePoint = field(repr=False)
    ate_loop_count: int = 0  # |loop|, sign in ate_is_negative
    ate_is_negative: bool = False
    twist_type: str = "D"  # "D": E'->E via (x w^2, y w^3); "M": (x/w^2, y/w^3)
    bn_final_steps: bool = False  # BN family: two extra Frobenius line steps

    # ---- Fq12 helpers ----
    @functools.cached_property
    def _e12(self) -> WeierstrassGroup:
        """E over Fq12 (untwisted curve, coefficients a=0, b = g1.b)."""
        f12 = Fq12Field(self.tower)
        t = self.tower
        b12 = t.from_sextic([(self.g1.b, 0)] + [t.ZERO2] * 5)
        return WeierstrassGroup(f12, f12.zero, b12, self.fr.modulus)

    @functools.cached_property
    def _w_pows(self) -> tuple[Fq12E, Fq12E]:
        """(w^2, w^3) or their inverses for M-type twists."""
        t = self.tower
        w2 = t.from_sextic([t.ZERO2, t.ZERO2, t.ONE2, t.ZERO2, t.ZERO2, t.ZERO2])
        w3 = t.from_sextic([t.ZERO2, t.ZERO2, t.ZERO2, t.ONE2, t.ZERO2, t.ZERO2])
        if self.twist_type == "M":
            return t.f12_inv(w2), t.f12_inv(w3)
        return w2, w3

    def _untwist(self, q: AffinePoint) -> AffinePoint:
        """Map a G2 (twist) point into E(Fq12)."""
        if q.infinity:
            return self._e12.infinity
        t = self.tower
        w2, w3 = self._w_pows
        x12 = t.from_sextic([q.x] + [t.ZERO2] * 5)
        y12 = t.from_sextic([q.y] + [t.ZERO2] * 5)
        return AffinePoint(t.f12_mul(x12, w2), t.f12_mul(y12, w3))

    def _embed_fq(self, a: int) -> Fq12E:
        t = self.tower
        return t.from_sextic([(a % self.fq.modulus, 0)] + [t.ZERO2] * 5)

    def _line(self, T: AffinePoint, Q: AffinePoint, xp: Fq12E, yp: Fq12E):
        """Evaluate the line through T and Q (or tangent at T if T==Q) at P.

        Returns (value, T+Q) over E(Fq12).
        """
        t = self.tower
        e12 = self._e12
        f = e12.f
        if T.infinity or Q.infinity:
            return t.ONE12, e12.add(T, Q)
        if f.eq(T.x, Q.x) and not f.eq(T.y, Q.y):
            # vertical line x - x_T
            return t.f12_sub(xp, T.x), e12.infinity
        if f.eq(T.x, Q.x):
            num = f.mul(self._embed_fq(3), f.mul(T.x, T.x))  # a=0
            den = t.f12_add(T.y, T.y)
        else:
            num = t.f12_sub(Q.y, T.y)
            den = t.f12_sub(Q.x, T.x)
        lam = t.f12_mul(num, t.f12_inv(den))
        # l(P) = (y_P - y_T) - lam * (x_P - x_T)
        val = t.f12_sub(t.f12_sub(yp, T.y), t.f12_mul(lam, t.f12_sub(xp, T.x)))
        x3 = t.f12_sub(t.f12_sub(t.f12_mul(lam, lam), T.x), Q.x)
        y3 = t.f12_sub(t.f12_mul(lam, t.f12_sub(T.x, x3)), T.y)
        return val, AffinePoint(x3, y3)

    def miller_loop(self, p: AffinePoint, q: AffinePoint) -> Fq12E:
        """f_{loop,Q}(P) including BN Frobenius steps; without final exp."""
        t = self.tower
        if p.infinity or q.infinity:
            return t.ONE12
        Qu = self._untwist(q)
        xp, yp = self._embed_fq(p.x), self._embed_fq(p.y)
        f_acc = t.ONE12
        T = Qu
        m = self.ate_loop_count
        for bit in bin(m)[3:]:  # MSB-1 .. 0
            f_acc = t.f12_sqr(f_acc)
            val, T = self._line(T, T, xp, yp)
            f_acc = t.f12_mul(f_acc, val)
            if bit == "1":
                val, T = self._line(T, Qu, xp, yp)
                f_acc = t.f12_mul(f_acc, val)
        if self.ate_is_negative:
            # f_{-m} differs from conj(f_m) by vertical-line factors that die
            # in the final exponentiation.
            f_acc = t.f12_conj(f_acc)
        if self.bn_final_steps:
            pi = lambda pt: AffinePoint(
                t.f12_frobenius(pt.x), t.f12_frobenius(pt.y), pt.infinity
            )
            Q1 = pi(Qu)
            Q2 = pi(Q1)
            nQ2 = AffinePoint(Q2.x, t.f12_sub(t.ZERO12, Q2.y), Q2.infinity)
            val, T = self._line(T, Q1, xp, yp)
            f_acc = t.f12_mul(f_acc, val)
            val, T = self._line(T, nQ2, xp, yp)
            f_acc = t.f12_mul(f_acc, val)
        return f_acc

    def multi_miller_loop(self, pairs) -> Fq12E:
        t = self.tower
        f_acc = t.ONE12
        for p, q in pairs:
            f_acc = t.f12_mul(f_acc, self.miller_loop(p, q))
        return f_acc

    @functools.cached_property
    def _hard_exp(self) -> int:
        q = self.fq.modulus
        return (q**4 - q**2 + 1) // self.fr.modulus

    def final_exponentiation(self, f: Fq12E) -> Fq12E:
        t = self.tower
        # easy part: f^((q^6-1)(q^2+1))
        f = t.f12_mul(t.f12_conj(f), t.f12_inv(f))  # f^(q^6-1)
        f = t.f12_mul(t.f12_frobenius(f, 2), f)  # f^(q^2+1)
        # hard part: f^((q^4-q^2+1)/r) via base-q Frobenius decomposition
        q = self.fq.modulus
        h = self._hard_exp
        digits = []
        while h:
            digits.append(h % q)
            h //= q
        out = t.ONE12
        for i, d in enumerate(digits):
            out = t.f12_mul(out, t.f12_pow(t.f12_frobenius(f, i), d))
        return out

    def pairing(self, p: AffinePoint, q: AffinePoint) -> Fq12E:
        return self.final_exponentiation(self.miller_loop(p, q))

    def product_of_pairings(self, pairs) -> Fq12E:
        return self.final_exponentiation(self.multi_miller_loop(pairs))


def _make_bn254() -> PairingCurve:
    q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
    r = 21888242871839275222246405745257275088548364400416034343698204186575808495617
    x = 4965661367192848881
    fq = FieldSpec("bn254.Fq", q, 3)
    fr = FieldSpec("bn254.Fr", r, 5)
    tower = Tower(q, (9, 1))  # xi = 9 + u
    f1 = IntField(q)
    f2 = Fq2Field(tower)
    g1 = WeierstrassGroup(f1, 0, 3, r)
    # b2 = 3 / (9 + u)  (D-type twist)
    b2 = tower.f2_mul(tower.f2(3), tower.f2_inv(tower.f2(9, 1)))
    g2 = WeierstrassGroup(f2, f2.zero, b2, r)
    g1_gen = AffinePoint(1, 2)
    g2_gen = AffinePoint(
        (
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        (
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    )
    return PairingCurve(
        name="bn254",
        fq=fq,
        fr=fr,
        tower=tower,
        g1=g1,
        g2=g2,
        g1_gen=g1_gen,
        g2_gen=g2_gen,
        ate_loop_count=6 * x + 2,
        ate_is_negative=False,
        twist_type="D",
        bn_final_steps=True,
    )


def _make_bls12_381() -> PairingCurve:
    q = int(
        "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
        "1eabfffeb153ffffb9feffffffffaaab",
        16,
    )
    r = int("73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16)
    x_abs = 0xD201000000010000  # BLS parameter |x|, x is negative
    fq = FieldSpec("bls12_381.Fq", q, 2)
    fr = FieldSpec("bls12_381.Fr", r, 7)
    tower = Tower(q, (1, 1))  # xi = 1 + u
    f1 = IntField(q)
    f2 = Fq2Field(tower)
    g1 = WeierstrassGroup(f1, 0, 4, r)
    b2 = tower.f2(4, 4)  # 4*(1+u)  (M-type twist)
    g2 = WeierstrassGroup(f2, f2.zero, b2, r)
    g1_gen = AffinePoint(
        int(
            "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
            "6c55e83ff97a1aeffb3af00adb22c6bb",
            16,
        ),
        int(
            "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
            "d03cc744a2888ae40caa232946c5e7e1",
            16,
        ),
    )
    g2_gen = AffinePoint(
        (
            int(
                "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d177"
                "0bac0326a805bbefd48056c8c121bdb8",
                16,
            ),
            int(
                "13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
                "334cf11213945d57e5ac7d055d042b7e",
                16,
            ),
        ),
        (
            int(
                "0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c"
                "923ac9cc3baca289e193548608b82801",
                16,
            ),
            int(
                "0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab"
                "3f370d275cec1da1aaa9075ff05f79be",
                16,
            ),
        ),
    )
    return PairingCurve(
        name="bls12_381",
        fq=fq,
        fr=fr,
        tower=tower,
        g1=g1,
        g2=g2,
        g1_gen=g1_gen,
        g2_gen=g2_gen,
        ate_loop_count=x_abs,
        ate_is_negative=True,
        twist_type="M",
        bn_final_steps=False,
    )


@functools.lru_cache(maxsize=None)
def get_curve(name: str) -> PairingCurve:
    name = name.lower().replace("-", "_")
    if name in ("bn254", "bn_256", "bn256", "alt_bn128"):
        return _make_bn254()
    if name in ("bls12_381", "bls12381"):
        return _make_bls12_381()
    raise KeyError(f"unknown pairing curve {name!r}")
