"""Plain Libra linear GKR prover/verifier.

Port of the reference's `schemes/libra/linear_gkr.py` (parity: ckb-zkp
libra/src/{libra_linear_gkr.rs:22-245, sumcheck.rs:21-176,
evaluate.rs:11-130} — per-layer two-phase sumcheck with eval_hg /
eval_fgu bookkeeping, quadratic round polynomials, 32-byte challenges
truncated to 31), word for word but for the device: `DeviceLayer`,
`_layer_device` and `LinearGKRProof.prover` take `device` (default
"cuda"), where a layer's tables live when `_use_device` sends them there
(`DeviceSumcheck(curve.fr, device)`, the GKR tables of `ops/sumcheck.py`).
`LinearGKRProof.verify` takes `device` as the other verifiers do; the
plain verifier is host ints, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...host.pairing import PairingCurve
from ...serialize.tobytes import fr_bytes, u64_bytes
from ...transcript import Transcript
from ..spartan.polynomial import eval_eq
from .circuit import Circuit, Gate


def _challenge32(curve, transcript, label: bytes) -> int:
    return int.from_bytes(transcript.challenge_bytes(label, 32)[:31], "little") % (
        curve.fr.modulus
    )


def _poly_bytes(curve, coeffs: list[int]) -> bytes:
    return u64_bytes(len(coeffs)) + b"".join(fr_bytes(curve, c) for c in coeffs)


def _poly_eval(coeffs, x, p):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def _combine(values: list[int], r: int, p: int) -> list[int]:
    half = len(values) // 2
    return [(r * values[i + half] + (1 - r) * values[i]) % p for i in range(half)]


def eval_value(values: list[int], r: list[int], p: int) -> int:
    eq = eval_eq(r, p)
    return sum(v * e % p for v, e in zip(values, eq)) % p


def eval_output(curve, output: list[int], bit_size: int, transcript):
    p = curve.fr.modulus
    outputs = list(output) + [0] * ((1 << bit_size) - len(output))
    rs = [_challenge32(curve, transcript, b"challenge_nextround") for _ in range(bit_size)]
    return eval_value(outputs, rs, p), rs


def eval_hg(evals_g, v_vec, gates: list[Gate], bit_size: int, p: int):
    n = 1 << bit_size
    mul_hg = [0] * n
    add_hg1 = [0] * n
    add_hg2 = [0] * n
    for gate in gates:
        g, x, y = gate.g, gate.left_node, gate.right_node
        if gate.op == 1:
            mul_hg[x] = (mul_hg[x] + evals_g[g] * v_vec[y]) % p
        elif gate.op == 0:
            add_hg1[x] = (add_hg1[x] + evals_g[g]) % p
            add_hg2[x] = (add_hg2[x] + evals_g[g] * v_vec[y]) % p
    return mul_hg, add_hg1, add_hg2


def eval_fgu(evals_g, ru_table, gates: list[Gate], bit_size: int, p: int):
    n = 1 << bit_size
    mul_hg = [0] * n
    add_hg = [0] * n
    for gate in gates:
        g, x, y = gate.g, gate.left_node, gate.right_node
        if gate.op == 1:
            mul_hg[y] = (mul_hg[y] + evals_g[g] * ru_table[x]) % p
        elif gate.op == 0:
            add_hg[y] = (add_hg[y] + evals_g[g] * ru_table[x]) % p
    return mul_hg, add_hg


def initialize_phase_one(gu, gv, gates, v_vec, bit_size, alpha, beta, p):
    egu = eval_eq(gu, p)
    egv = eval_eq(gv, p)
    eg = [(alpha * a + beta * b) % p for a, b in zip(egu, egv)]
    return eval_hg(eg, v_vec, gates, bit_size, p)


def initialize_phase_two(gu, gv, ru, gates, v_vec, bit_size, alpha, beta, p):
    egu = eval_eq(gu, p)
    egv = eval_eq(gv, p)
    eru = eval_eq(ru, p)
    eval_ru = sum(v * e % p for v, e in zip(v_vec, eru)) % p
    eg = [(alpha * a + beta * b) % p for a, b in zip(egu, egv)]
    mul_hg, add_hg = eval_fgu(eg, eru, gates, bit_size, p)
    return mul_hg, add_hg, eval_ru


@dataclass
class SumCheckProof:
    polys: list[list[int]]  # quadratic coeffs [c, b, a]
    poly_value_at_r: list[int]


# ---- device-resident path (ops/sumcheck.py): eval tables live on `device`
# as Montgomery limb arrays; each round sends only (eval_0, eval_2) to the
# host where the transcript runs, then binds the tables with the challenge.
# Byte-identical proofs to the host path (tests/test_libra.py equality).
def _use_device(bit_size: int) -> bool:
    from ...ops.sumcheck import DEVICE_SUMCHECK_MIN

    return (1 << bit_size) >= DEVICE_SUMCHECK_MIN


def _quad_coeffs(e0: int, e2: int, claim: int, p: int):
    two_inv = pow(2, -1, p)
    e1 = (claim - e0) % p
    a_c = (e0 - 2 * e1 + e2) * two_inv % p
    c_c = e0 % p
    b_c = (e1 - a_c - c_c) % p
    return [c_c, b_c, a_c]


def _phase_one_device(curve, ds, pf, tabs, bit_size, claim, transcript):
    p = curve.fr.modulus
    pmul, pa1, pa2 = tabs
    rs, polys = [], []
    for _ in range(bit_size):
        e0, e2 = ds.libra_p1_round(pf, pmul, pa1, pa2)
        poly = _quad_coeffs(e0, e2, claim, p)
        transcript.append_message(b"poly", _poly_bytes(curve, poly))
        r_i = _challenge32(curve, transcript, b"challenge_nextround")
        pf, pmul, pa1, pa2 = (
            ds.bind(pf, r_i), ds.bind(pmul, r_i),
            ds.bind(pa1, r_i), ds.bind(pa2, r_i),
        )
        claim = _poly_eval(poly, r_i, p)
        rs.append(r_i)
        polys.append(poly)
    values = ds.firsts(pf, pmul, pa1, pa2)
    transcript.append_message(
        b"claim_final", b"".join(fr_bytes(curve, v) for v in values)
    )
    return SumCheckProof(polys, values), rs


def _phase_two_device(curve, ds, pf, tabs, fu, bit_size, claim, transcript):
    p = curve.fr.modulus
    pmul, padd = tabs
    rs, polys = [], []
    for _ in range(bit_size):
        e0, e2 = ds.libra_p2_round(pf, pmul, padd, fu)
        poly = _quad_coeffs(e0, e2, claim, p)
        transcript.append_message(b"poly", _poly_bytes(curve, poly))
        r_i = _challenge32(curve, transcript, b"challenge_nextround")
        pf, pmul, padd = (
            ds.bind(pf, r_i), ds.bind(pmul, r_i), ds.bind(padd, r_i)
        )
        claim = _poly_eval(poly, r_i, p)
        rs.append(r_i)
        polys.append(poly)
    values = ds.firsts(pf, pmul, padd)
    transcript.append_message(
        b"claim_final", b"".join(fr_bytes(curve, v) for v in values)
    )
    return SumCheckProof(polys, values), rs


class DeviceLayer:
    """Device-resident bookkeeping tables for one GKR layer (shared by the
    plain and zk provers): eval_eq challenge tables, the eval_hg /
    eval_fgu scatter-accumulations and the value vector all live on device
    as Montgomery limb arrays (libra_linear_gkr.rs:201-244,
    evaluate.rs:79-120)."""

    def __init__(self, curve, gu, gv, gates, v_vec, uv_size, alpha, beta, device="cuda"):
        from ...ops.sumcheck import DeviceSumcheck, gkr_tables_phase_one

        self.curve = curve
        self.gates = gates
        self.uv_size = uv_size
        self.ds = DeviceSumcheck(curve.fr, device)
        fr = self.ds.fr
        egu = self.ds.eval_eq(gu)
        egv = self.ds.eval_eq(gv)
        self.eg = fr.add(
            fr.mul(egu, fr.encode([alpha])), fr.mul(egv, fr.encode([beta]))
        )
        self.v_dev = self.ds.encode_table(v_vec)
        self.tabs1 = gkr_tables_phase_one(
            self.ds, self.eg, self.v_dev, gates, uv_size
        )

    def phase_two(self, ru):
        """-> (tabs2, fu) after the phase-one challenges are known."""
        from ...ops.sumcheck import gkr_tables_phase_two

        ds = self.ds
        eru = ds.eval_eq(ru)
        fu = ds.decode_scalar(ds._sum(ds.fr.mul(self.v_dev, eru)))
        tabs2 = gkr_tables_phase_two(
            ds, self.eg, eru, self.gates, self.uv_size
        )
        return tabs2, fu


class DeviceRounds:
    """Round engine over device tables: evals() sends only (eval_0, eval_2)
    to host; bind() halves every table with the round challenge."""

    def __init__(self, ds, f_dev, tabs, fu: int | None = None):
        self.ds = ds
        self.f = f_dev
        self.tabs = list(tabs)
        self.fu = fu  # set => phase-two term; None => phase-one

    def evals(self):
        if self.fu is None:
            return self.ds.libra_p1_round(self.f, *self.tabs)
        return self.ds.libra_p2_round(self.f, *self.tabs, self.fu)

    def bind(self, r: int):
        self.f = self.ds.bind(self.f, r)
        self.tabs = [self.ds.bind(t, r) for t in self.tabs]

    def finals(self) -> list[int]:
        return self.ds.firsts(self.f, *self.tabs)


class HostRounds:
    """Host-int round engine (the original _sumcheck inner loop)."""

    def __init__(self, p, f_vec, tables, term_fn):
        self.p = p
        self.f = list(f_vec)
        self.tabs = [list(t) for t in tables]
        self.term = term_fn

    def evals(self):
        p = self.p
        size = len(self.f) // 2
        e0 = sum(self.term(self.f, self.tabs, j) for j in range(size)) % p
        f2 = _combine(self.f, 2, p)
        tabs2 = [_combine(t, 2, p) for t in self.tabs]
        e2 = sum(self.term(f2, tabs2, j) for j in range(size)) % p
        return e0, e2

    def bind(self, r: int):
        self.f = _combine(self.f, r, self.p)
        self.tabs = [_combine(t, r, self.p) for t in self.tabs]

    def finals(self) -> list[int]:
        return [self.f[0]] + [t[0] for t in self.tabs]


def _layer_device(curve, gu, gv, gates, v_vec, uv_size, alpha, beta, claim,
                  transcript, device="cuda"):
    """One GKR layer (both phases) with device-resident tables; only the
    round scalars and final claims cross to the host."""
    p = curve.fr.modulus
    layer = DeviceLayer(curve, gu, gv, gates, v_vec, uv_size, alpha, beta, device)
    proof1, ru = _phase_one_device(
        curve, layer.ds, layer.v_dev, layer.tabs1, uv_size, claim, transcript
    )
    e = proof1.poly_value_at_r
    claim2 = (e[0] * e[1] + e[0] * e[2] + e[3]) % p
    tabs2, fu = layer.phase_two(ru)
    proof2, rv = _phase_two_device(
        curve, layer.ds, layer.v_dev, tabs2, fu, uv_size, claim2, transcript
    )
    return proof1, ru, proof2, rv, fu


def _sumcheck(curve, f_vec, tables, term_fn, bit_size, claim, transcript):
    """Generic round loop shared by phase one/two (term_fn computes the
    per-index summand from the current tables + f)."""
    p = curve.fr.modulus
    two_inv = pow(2, -1, p)
    rs, polys = [], []
    f = list(f_vec)
    tabs = [list(t) for t in tables]
    for _ in range(bit_size):
        size = len(f) // 2
        eval_0 = sum(term_fn(f, tabs, j) for j in range(size)) % p
        eval_1 = (claim - eval_0) % p
        f2 = _combine(f, 2, p)
        tabs2 = [_combine(t, 2, p) for t in tabs]
        eval_2 = sum(term_fn(f2, tabs2, j) for j in range(size)) % p
        a_c = (eval_0 - 2 * eval_1 + eval_2) * two_inv % p
        c_c = eval_0 % p
        b_c = (eval_1 - a_c - c_c) % p
        poly = [c_c, b_c, a_c]
        transcript.append_message(b"poly", _poly_bytes(curve, poly))
        r_i = _challenge32(curve, transcript, b"challenge_nextround")
        f = _combine(f, r_i, p)
        tabs = [_combine(t, r_i, p) for t in tabs]
        claim = _poly_eval(poly, r_i, p)
        rs.append(r_i)
        polys.append(poly)
    return polys, rs, f, tabs


def phase_one_prover(curve, f_vec, g_vec, bit_size, claim, transcript):
    p = curve.fr.modulus

    def term(f, tabs, j):
        mul, a1, a2 = tabs
        return (f[j] * mul[j] + f[j] * a1[j] + a2[j]) % p

    polys, ru, f, tabs = _sumcheck(
        curve, f_vec, g_vec, term, bit_size, claim, transcript
    )
    values = [f[0], tabs[0][0], tabs[1][0], tabs[2][0]]
    transcript.append_message(
        b"claim_final", b"".join(fr_bytes(curve, v) for v in values)
    )
    return SumCheckProof(polys, values), ru


def phase_two_prover(curve, f_vec, g_vec, bit_size, claim, transcript):
    p = curve.fr.modulus
    mul_hg, add_hg, fu = g_vec

    def term(f, tabs, j):
        mul, add = tabs
        return (mul[j] * f[j] % p * fu + add[j] * fu + add[j] * f[j]) % p

    polys, rv, f, tabs = _sumcheck(
        curve, f_vec, (mul_hg, add_hg), term, bit_size, claim, transcript
    )
    values = [f[0], tabs[0][0], tabs[1][0]]
    transcript.append_message(
        b"claim_final", b"".join(fr_bytes(curve, v) for v in values)
    )
    return SumCheckProof(polys, values), rv


@dataclass
class LayerProof:
    proof_phase_one: SumCheckProof
    proof_phase_two: SumCheckProof


@dataclass
class LinearGKRProof:
    proofs: list[LayerProof]

    @classmethod
    def prover(cls, curve: PairingCurve, circuit: Circuit, inputs, witnesses, circuit_hash,
               device="cuda"):
        p = curve.fr.modulus
        transcript = Transcript(b"libra - linear gkr")
        transcript.append_message(b"circuit_to_hash", fr_bytes(curve, circuit_hash))
        evals = circuit.evaluate(p, inputs, witnesses)
        transcript.append_message(
            b"input", b"".join(fr_bytes(curve, v) for v in evals[0])
        )
        transcript.append_message(
            b"output", b"".join(fr_bytes(curve, v) for v in evals[-1])
        )
        alpha, beta = 1, 0
        result_u, gu = eval_output(
            curve, evals[-1], circuit.layers[circuit.depth - 1].bit_size, transcript
        )
        gv = [0] * len(gu)
        result_v = 0
        proofs = []
        for d in range(circuit.depth - 1, 0, -1):
            claim = (alpha * result_u + beta * result_v) % p
            uv_size = circuit.layers[d - 1].bit_size
            if _use_device(uv_size):
                proof1, ru, proof2, rv, fu = _layer_device(
                    curve, gu, gv, circuit.layers[d].gates, evals[d - 1],
                    uv_size, alpha, beta, claim, transcript, device,
                )
                ev = proof2.poly_value_at_r
                proofs.append(LayerProof(proof1, proof2))
                if d > 1:
                    gu, gv = ru, rv
                    result_u, result_v = fu, ev[0]
                    alpha = _challenge32(curve, transcript, b"challenge_alpha")
                    beta = _challenge32(curve, transcript, b"challenge_beta")
                continue
            g1tables = initialize_phase_one(
                gu, gv, circuit.layers[d].gates, evals[d - 1], uv_size, alpha, beta, p
            )
            proof1, ru = phase_one_prover(
                curve, evals[d - 1], g1tables, uv_size, claim, transcript
            )
            e = proof1.poly_value_at_r
            claim = (e[0] * e[1] + e[0] * e[2] + e[3]) % p
            mul_hg, add_hg, fu = initialize_phase_two(
                gu, gv, ru, circuit.layers[d].gates, evals[d - 1], uv_size, alpha, beta, p
            )
            proof2, rv = phase_two_prover(
                curve, evals[d - 1], (mul_hg, add_hg, fu), uv_size, claim, transcript
            )
            ev = proof2.poly_value_at_r
            proofs.append(LayerProof(proof1, proof2))
            if d > 1:
                gu, gv = ru, rv
                result_u, result_v = fu, ev[0]
                alpha = _challenge32(curve, transcript, b"challenge_alpha")
                beta = _challenge32(curve, transcript, b"challenge_beta")
        return cls(proofs), evals[-1]

    def verify(self, curve: PairingCurve, circuit: Circuit, outputs, inputs, circuit_hash,
               device="cuda") -> bool:
        p = curve.fr.modulus
        transcript = Transcript(b"libra - linear gkr")
        transcript.append_message(b"circuit_to_hash", fr_bytes(curve, circuit_hash))
        transcript.append_message(b"input", b"".join(fr_bytes(curve, v) for v in inputs))
        transcript.append_message(b"output", b"".join(fr_bytes(curve, v) for v in outputs))
        alpha, beta = 1, 0
        result_u, _ = eval_output(
            curve, outputs, circuit.layers[circuit.depth - 1].bit_size, transcript
        )
        result_v = 0
        eval_ru_x = eval_rv_y = 0
        ru_vec: list[int] = []
        rv_vec: list[int] = []
        if circuit.depth - 1 != len(self.proofs):
            return False
        for d, lproof in enumerate(self.proofs):
            claim = (alpha * result_u + beta * result_v) % p
            proof1, proof2 = lproof.proof_phase_one, lproof.proof_phase_two
            bit_size = circuit.layers[circuit.depth - d - 2].bit_size
            ru_vec, rv_vec = [], []
            for i in range(bit_size):
                poly = proof1.polys[i]
                if (_poly_eval(poly, 0, p) + _poly_eval(poly, 1, p)) % p != claim:
                    return False
                transcript.append_message(b"poly", _poly_bytes(curve, poly))
                r_u = _challenge32(curve, transcript, b"challenge_nextround")
                ru_vec.append(r_u)
                claim = _poly_eval(poly, r_u, p)
            e1 = proof1.poly_value_at_r
            transcript.append_message(
                b"claim_final", b"".join(fr_bytes(curve, v) for v in e1)
            )
            if claim != (e1[0] * e1[1] + e1[0] * e1[2] + e1[3]) % p:
                return False
            claim = (e1[0] * e1[1] + e1[0] * e1[2] + e1[3]) % p
            for i in range(bit_size):
                poly = proof2.polys[i]
                if (_poly_eval(poly, 0, p) + _poly_eval(poly, 1, p)) % p != claim:
                    return False
                transcript.append_message(b"poly", _poly_bytes(curve, poly))
                r_v = _challenge32(curve, transcript, b"challenge_nextround")
                rv_vec.append(r_v)
                claim = _poly_eval(poly, r_v, p)
            e2 = proof2.poly_value_at_r
            transcript.append_message(
                b"claim_final", b"".join(fr_bytes(curve, v) for v in e2)
            )
            if claim != (e2[1] * e2[0] % p * e1[0] + e2[2] * e1[0] + e2[2] * e2[0]) % p:
                return False
            if d < circuit.depth - 2:
                result_u, result_v = e1[0], e2[0]
                alpha = _challenge32(curve, transcript, b"challenge_alpha")
                beta = _challenge32(curve, transcript, b"challenge_beta")
            else:
                eval_ru_x, eval_rv_y = e1[0], e2[0]
        return eval_ru_x == eval_value(
            list(inputs) + [0] * ((1 << len(ru_vec)) - len(inputs)), ru_vec, p
        ) and eval_rv_y == eval_value(
            list(inputs) + [0] * ((1 << len(rv_vec)) - len(inputs)), rv_vec, p
        )
