"""Bulletproofs arithmetic-circuit prover/verifier ("protocol3").

Port of the reference's `schemes/bulletproofs/arithmetic_circuit.py`
(parity: ckb-zkp bulletproofs/src/arithmetic_circuit.rs:104-848 —
identical transcript schedule, commitment set (A_I, A_O, A_W, S,
T_2,T_3,T_5..T_10), blinding structure, and final P-check), word for word
but for the device:

- `create_random_proof` and `prove` take `device` (default "cuda") and a
  `timings` dict, which receives the seconds of the stages (generators,
  synthesize, commitments, t_poly, T_commitments, IPP_P, inner_product);
- the 2N + 3 generators are the reference's random points, the same
  scalars drawn in the same order (g_vec_N, h_vec_N, g, h, u), made as
  one `generator_multiples` on `device` (K6's fixed-base MSM on
  short-Weierstrass curves from FIXED_BASE_MSM_MIN scalars up);
- the MSMs over one generator list with rows of one length run as one
  `msm_over_fixed_base_many` (the four g_vec_N rows and the two h_vec_N
  rows of the commitments where their lengths agree; l_x and r_x of
  IPP_P): the same points;
- the transcript's bytes of the dense CL/CR/CO rows (n (n + 2) elements a
  matrix for n constraints) are made in one pass, zero elements as zero
  bytes (`_rows_bytes`): the same bytes as `frs_bytes` a row.

The verifier stays host ints, as in the reference.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ...host.curves import AffinePoint
from ...host.pairing import PairingCurve
from ...r1cs import ConstraintSynthesizer, ConstraintSystem, SynthesisMode
from ...transcript import Transcript
from ..groth16.prover import Stages
from . import inner_product_proof
from .common import (
    VecPoly5,
    fr_bytes,
    frs_bytes,
    hadamard,
    inner_product,
    point_bytes,
    points_bytes,
    random_bytes_to_fr,
    scalar_powers,
)


@dataclass
class Generators:
    g_vec_N: list[AffinePoint]
    h_vec_N: list[AffinePoint]
    g: AffinePoint
    h: AffinePoint
    u: AffinePoint
    n: int
    N: int
    k: int
    n_w: int


@dataclass
class R1csCircuit:
    """Dense CL/CR/CO over columns [inputs | aux] (reference keeps both dense
    and BTreeMap forms; the dense rows feed the transcript)."""

    CL: list[list[int]]
    CR: list[list[int]]
    CO: list[list[int]]

    # sparse BTreeMap views, derived exactly like the reference's
    # matrix_to_map (arithmetic_circuit.rs:128-151) — wire-format only
    @staticmethod
    def _to_map(m):
        return {
            (i, j): v
            for i, row in enumerate(m)
            for j, v in enumerate(row)
            if v
        }

    @property
    def CL_T(self):
        return self._to_map(self.CL)

    @property
    def CR_T(self):
        return self._to_map(self.CR)

    @property
    def CO_T(self):
        return self._to_map(self.CO)


@dataclass
class Proof:
    A_I: AffinePoint
    A_O: AffinePoint
    A_W: AffinePoint
    S: AffinePoint
    T: dict  # degree -> commitment, degrees {2,3,5,6,7,8,9,10}
    mu: int
    tau_x: int
    l_x: list[int]
    r_x: list[int]
    t_x: int
    IPP: inner_product_proof.Proof
    IPP_P: AffinePoint


T_DEGREES = [2, 3, 5, 6, 7, 8, 9, 10]


def create_random_proof(
    curve: PairingCurve, circuit: ConstraintSynthesizer, rng: random.Random,
    device="cuda", timings: dict | None = None,
):
    from ...ops.msm import generator_multiples

    st = Stages(timings, device)
    p = curve.fr.modulus
    cs = ConstraintSystem(SynthesisMode.PROVE)
    circuit.generate_constraints(cs)
    shape = cs.finalize(p)
    num_constraints = shape.num_constraints
    f = shape.full_assignment()
    num_inputs = shape.num_inputs
    nv = len(f)

    CL = [[0] * nv for _ in range(num_constraints)]
    CR = [[0] * nv for _ in range(num_constraints)]
    CO = [[0] * nv for _ in range(num_constraints)]
    for mat, dense in ((shape.a, CL), (shape.b, CR), (shape.c, CO)):
        for r_, c_, v in zip(mat.rows, mat.cols, mat.coeffs):
            dense[int(r_)][int(c_)] = v % p
    r1cs = R1csCircuit(CL, CR, CO)

    aL = [inner_product(row, f, p) for row in CL]
    aR = [inner_product(row, f, p) for row in CR]
    aO = [inner_product(row, f, p) for row in CO]
    s_pub = f[:num_inputs]
    w = f[num_inputs:]
    st.mark("synthesize")

    n_max = max(len(aL), len(w))
    N = 1 if n_max == 0 else 1 << (n_max - 1).bit_length()
    # the reference's rand_pt() draws, in its order: g_vec_N, h_vec_N, g, h, u
    pts = generator_multiples(curve, [rng.randrange(1, p) for _ in range(2 * N + 3)], device)
    gens = Generators(
        g_vec_N=pts[:N],
        h_vec_N=pts[N : 2 * N],
        g=pts[2 * N],
        h=pts[2 * N + 1],
        u=pts[2 * N + 2],
        n=num_constraints,
        N=N,
        k=len(s_pub),
        n_w=len(w),
    )
    st.mark("generators")
    proof = prove(curve, gens, r1cs, aL, aR, aO, s_pub, w, rng, device, timings)
    return gens, r1cs, proof


def _rows_bytes(curve, rows) -> bytes:
    """b"".join(frs_bytes(curve, row) for row in rows), zero elements as
    zero bytes and only the others converted."""
    p, nb = curve.fr.modulus, curve.fr.nbytes
    out = bytearray(sum(map(len, rows)) * nb)
    o = 0
    for row in rows:
        for j, v in enumerate(row):
            if v:
                out[o + j * nb : o + (j + 1) * nb] = (v % p).to_bytes(nb, "little")
        o += len(row) * nb
    return bytes(out)


def _absorb_common(curve, transcript, gens, r1cs, s_pub):
    transcript.append_u64(b"n", gens.n)
    transcript.append_u64(b"N", gens.N)
    transcript.append_u64(b"k", gens.k)
    transcript.append_u64(b"n_w", gens.n_w)
    transcript.append_message(b"g", point_bytes(curve, gens.g))
    transcript.append_message(b"h", point_bytes(curve, gens.h))
    transcript.append_message(b"u", point_bytes(curve, gens.u))
    transcript.append_message(b"g_vec_N", points_bytes(curve, gens.g_vec_N))
    transcript.append_message(b"h_vec_N", points_bytes(curve, gens.h_vec_N))
    transcript.append_message(b"cL", _rows_bytes(curve, r1cs.CL))
    transcript.append_message(b"cR", _rows_bytes(curve, r1cs.CR))
    transcript.append_message(b"cO", _rows_bytes(curve, r1cs.CO))
    transcript.append_message(b"s", frs_bytes(curve, s_pub))


def _msm_rows(curve, base, rows, device):
    """The MSMs of `rows` over the generator list `base`: one
    `msm_over_fixed_base_many` for the rows of each length (the same
    points as one `msm_over_fixed_base` a row), in the rows' order."""
    from ...ops.msm import msm_over_fixed_base_many

    out = [None] * len(rows)
    for length in dict.fromkeys(len(r) for r in rows):
        idx = [i for i, r in enumerate(rows) if len(r) == length]
        for i, pt in zip(idx, msm_over_fixed_base_many(curve, base, [rows[i] for i in idx],
                                                       device=device)):
            out[i] = pt
    return out


def prove(curve, gens, r1cs, aL, aR, aO, s_pub, w, rng, device="cuda",
          timings: dict | None = None):
    st = Stages(timings, device)
    p = curve.fr.modulus
    g1 = curve.g1
    transcript = Transcript(b"protocol3")
    n = len(aL)
    k = len(s_pub)
    n_w = len(w)
    N = gens.N
    g_vec = gens.g_vec_N[:n]
    h_vec = gens.h_vec_N[:n]
    g_vec_w = gens.g_vec_N[:n_w]

    _absorb_common(curve, transcript, gens, r1cs, s_pub)

    sL = [rng.randrange(p) for _ in range(max(n, n_w))]
    sR = [rng.randrange(p) for _ in range(max(n, n_w))]
    aIB, aOB, sB, gamma = (rng.randrange(p) for _ in range(4))

    g_aL, g_aO, g_w, g_sL = _msm_rows(curve, gens.g_vec_N, [aL, aO, w, sL], device)
    h_aR, h_sR = _msm_rows(curve, gens.h_vec_N, [aR, sR], device)
    A_I = g1.add(g1.mul(gens.h, aIB), g1.add(g_aL, h_aR))
    A_O = g1.add(g1.mul(gens.h, aOB), g_aO)
    A_W = g1.add(g1.mul(gens.h, gamma), g_w)
    S = g1.add(g1.mul(gens.h, sB), g1.add(g_sL, h_sR))
    for lbl, pt in ((b"A_I", A_I), (b"A_O", A_O), (b"A_W", A_W), (b"S", S)):
        transcript.append_message(lbl, point_bytes(curve, pt))
    st.mark("commitments")

    y = random_bytes_to_fr(p, transcript.challenge_bytes(b"y", 31))
    z = random_bytes_to_fr(p, transcript.challenge_bytes(b"z", 31))

    pad = lambda v: v + [0] * (N - len(v))
    aL, aR, aO, witness = pad(aL), pad(aR), pad(aO), pad(list(w))
    sL, sR = pad(sL[:N]), pad(sR[:N])

    y_n = scalar_powers(y, N, p)
    y_n_inv = [pow(v, -1, p) for v in y_n]
    z_Q = [z * v % p for v in scalar_powers(z, n, p)]
    zn = z_Q[n - 1]
    zn_sq = zn * zn % p

    m = k + n_w
    # zQ*WL etc: W matrices are diagonal (identity / zn*I / zn^2*I)
    zQ_WL = pad([z_Q[i] % p for i in range(n)])
    zQ_WR = pad([z_Q[i] * zn % p for i in range(n)])
    zQ_WO = pad([z_Q[i] * zn_sq % p for i in range(n)])
    # WV[i][j-k] = CL[i][j] + zn CR[i][j] + zn^2 CO[i][j] for j in k..m
    zQ_WV = [0] * N
    for i in range(n):
        zi = z_Q[i]
        CLi, CRi, COi = r1cs.CL[i], r1cs.CR[i], r1cs.CO[i]
        for j in range(k, m):
            val = (CLi[j] + zn * CRi[j] + zn_sq * COi[j]) % p
            if val:
                zQ_WV[j - k] = (zQ_WV[j - k] + zi * val) % p

    ynInvZQWR = hadamard(y_n_inv, zQ_WR, p)
    yn_aR = hadamard(y_n, aR, p)
    yn_sR = hadamard(y_n, sR, p)

    l_poly = VecPoly5(N, p)
    r_poly = VecPoly5(N, p)
    for i in range(N):
        l_poly.coeffs[2][i] = (aL[i] + ynInvZQWR[i]) % p
        l_poly.coeffs[3][i] = aO[i]
        l_poly.coeffs[4][i] = witness[i]
        l_poly.coeffs[5][i] = sL[i]
        r_poly.coeffs[2][i] = (yn_aR[i] + zQ_WL[i]) % p
        r_poly.coeffs[1][i] = (-y_n[i] + zQ_WO[i]) % p
        r_poly.coeffs[0][i] = (-zQ_WV[i]) % p
        r_poly.coeffs[5][i] = yn_sR[i]

    t_poly = VecPoly5.special_inner_product(l_poly, r_poly)
    st.mark("t_poly")
    taus = {d: rng.randrange(p) for d in T_DEGREES}
    T = {
        d: g1.add(g1.mul(gens.g, t_poly.get(d, 0)), g1.mul(gens.h, taus[d]))
        for d in T_DEGREES
    }
    for d in T_DEGREES:
        transcript.append_message(b"T_%d" % d, point_bytes(curve, T[d]))
    st.mark("T_commitments")

    x = random_bytes_to_fr(p, transcript.challenge_bytes(b"x", 31))
    l_x = l_poly.eval(x)
    r_x = r_poly.eval(x)
    t_x = inner_product(l_x, r_x, p)
    tau_x = sum(taus[d] * pow(x, d, p) for d in T_DEGREES) % p
    xx = x * x % p
    xxxx = xx * xx % p
    mu = (aIB * xx + aOB * xx * x + gamma * xxxx + sB * xxxx * x) % p

    transcript.append_message(b"t_x", fr_bytes(curve, t_x))
    transcript.append_message(b"tau_x", fr_bytes(curve, tau_x))
    transcript.append_message(b"mu", fr_bytes(curve, mu))
    transcript.append_message(b"l_x", frs_bytes(curve, l_x))
    transcript.append_message(b"r_x", frs_bytes(curve, r_x))
    x_1 = random_bytes_to_fr(p, transcript.challenge_bytes(b"x_1", 31))
    ux = g1.mul(gens.u, x_1)

    (g_lx,) = _msm_rows(curve, gens.g_vec_N, [l_x], device)
    (h_rx,) = _msm_rows(curve, gens.h_vec_N, [r_x], device)
    IPP_P = g1.add(g1.add(g_lx, h_rx), g1.mul(ux, t_x))
    st.mark("IPP_P")
    IPP = inner_product_proof.prove(
        curve, transcript, list(gens.g_vec_N), list(gens.h_vec_N), ux, IPP_P, l_x, r_x,
        device,
    )
    st.mark("inner_product")
    return Proof(
        A_I=A_I, A_O=A_O, A_W=A_W, S=S, T=T, mu=mu, tau_x=tau_x,
        l_x=l_x, r_x=r_x, t_x=t_x, IPP=IPP, IPP_P=IPP_P,
    )


def verify_proof(curve, gens, proof, r1cs, public_inputs) -> bool:
    p = curve.fr.modulus
    g1 = curve.g1
    transcript = Transcript(b"protocol3")
    r1_pub = [1] + list(public_inputs)

    _absorb_common(curve, transcript, gens, r1cs, r1_pub)
    for lbl, pt in (
        (b"A_I", proof.A_I), (b"A_O", proof.A_O), (b"A_W", proof.A_W), (b"S", proof.S)
    ):
        transcript.append_message(lbl, point_bytes(curve, pt))
    y = random_bytes_to_fr(p, transcript.challenge_bytes(b"y", 31))
    z = random_bytes_to_fr(p, transcript.challenge_bytes(b"z", 31))

    N, n, k, n_w = gens.N, gens.n, gens.k, gens.n_w
    y_n = scalar_powers(y, N, p)
    y_n_inv = [pow(v, -1, p) for v in y_n]
    z_Q = [z * v % p for v in scalar_powers(z, n, p)]
    zn = z_Q[n - 1]
    zn_sq = zn * zn % p
    m = k + n_w

    C1 = [[(r1cs.CL[i][j] + zn * r1cs.CR[i][j] + zn_sq * r1cs.CO[i][j]) % p
           for j in range(k)] for i in range(n)]
    pad = lambda v: v + [0] * (N - len(v))
    zQ_WL = pad([z_Q[i] for i in range(n)])
    zQ_WR = pad([z_Q[i] * zn % p for i in range(n)])
    zQ_WO = pad([z_Q[i] * zn_sq % p for i in range(n)])
    zQ_neg_WV = [0] * N
    for i in range(n):
        zi = (-z_Q[i]) % p
        for j in range(k, m):
            val = (r1cs.CL[i][j] + zn * r1cs.CR[i][j] + zn_sq * r1cs.CO[i][j]) % p
            if val:
                zQ_neg_WV[j - k] = (zQ_neg_WV[j - k] + zi * val) % p

    ynInvZQWR = hadamard(y_n_inv, zQ_WR, p)
    delta_yz = inner_product(ynInvZQWR, zQ_WL, p)
    # c_j = sum_i r1_pub vector through C1 (transpose product)
    c = [sum(r1_pub[j] * C1[i][j] for j in range(k)) % p for i in range(n)]

    for d in T_DEGREES:
        transcript.append_message(b"T_%d" % d, point_bytes(curve, proof.T[d]))
    x = random_bytes_to_fr(p, transcript.challenge_bytes(b"x", 31))

    h_vec_inv = [g1.mul(gens.h_vec_N[i], y_n_inv[i]) for i in range(N)]
    wL = g1.msm(h_vec_inv, zQ_WL)
    wR = g1.msm(gens.g_vec_N, ynInvZQWR)
    wO = g1.msm(h_vec_inv, zQ_WO)
    wV = g1.msm(h_vec_inv, zQ_neg_WV)

    transcript.append_message(b"t_x", fr_bytes(curve, proof.t_x))
    transcript.append_message(b"tau_x", fr_bytes(curve, proof.tau_x))
    transcript.append_message(b"mu", fr_bytes(curve, proof.mu))
    transcript.append_message(b"l_x", frs_bytes(curve, proof.l_x))
    transcript.append_message(b"r_x", frs_bytes(curve, proof.r_x))
    x_1 = random_bytes_to_fr(p, transcript.challenge_bytes(b"x_1", 31))
    ux = g1.mul(gens.u, x_1)

    if not inner_product_proof.verify(
        curve, transcript, list(gens.g_vec_N), list(gens.h_vec_N), ux,
        proof.IPP_P, proof.IPP,
    ):
        return False

    lhs = g1.add(g1.mul(gens.g, proof.t_x), g1.mul(gens.h, proof.tau_x))
    zQ_c = inner_product(z_Q, c, p)
    xx = x * x % p
    xxxx = xx * xx % p
    rhs = g1.mul(gens.g, xxxx * (delta_yz + zQ_c) % p)
    for d in T_DEGREES:
        rhs = g1.add(rhs, g1.mul(proof.T[d], pow(x, d, p)))
    if lhs != rhs:
        return False

    y_n_neg = [(-v) % p for v in y_n]
    P = g1.mul(proof.A_I, xx)
    P = g1.add(P, g1.mul(proof.A_O, xx * x % p))
    P = g1.add(P, g1.mul(proof.A_W, xxxx))
    P = g1.add(P, g1.mul(g1.msm(h_vec_inv, y_n_neg), x))
    P = g1.add(P, g1.mul(wL, xx))
    P = g1.add(P, g1.mul(wR, xx))
    P = g1.add(P, g1.mul(wO, x))
    P = g1.add(P, wV)
    P = g1.add(P, g1.mul(proof.S, xxxx * x % p))
    checkP = g1.add(
        g1.mul(gens.h, proof.mu),
        g1.add(g1.msm(gens.g_vec_N, proof.l_x), g1.msm(h_vec_inv, proof.r_x)),
    )
    return P == checkP
