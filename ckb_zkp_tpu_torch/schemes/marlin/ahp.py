"""Marlin's algebraic holographic proof for R1CS.

Port of the reference's `schemes/marlin/ahp.py` (ckb-zkp marlin/src/ahp/):
indexer (square matrices, balanced A/B, row/col/val/row_col encodings over
domains K and B), the three prover rounds (masked outer sumcheck, inner
sumcheck over K) and the verifier rounds/query set/equality check.
Transform-heavy steps run through the device NTT (HDomain); sparse walks
are host-side. Word for word but for the device, which the index carries
(every HDomain of a prove is on it, and the verifier gets it as an
argument), and the two products z_a * z_b and b * t: the reference
multiplies them as Python-int schoolbook products (`hpoly.mul`), about
4 * 10^9 big-int products each at 2^16 constraints; here they go through
the device NTT (`_poly_mul`), the same integers.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import torch

from ...host import poly as hpoly
from ...host.field import FieldSpec
from ...ops.field import device_field
from ...ops.hdomain import HDomain
from ...ops.poly import decode_ints, encode_ints, poly_mul
from ...r1cs import ConstraintSystem, ConstraintSynthesizer, SynthesisMode
from ..errors import SchemeError
from .pc import LabeledPolynomial

INDEXER_POLYNOMIALS = [
    "a_row", "a_col", "a_val", "a_row_col",
    "b_row", "b_col", "b_val", "b_row_col",
    "c_row", "c_col", "c_val", "c_row_col",
]
PROVER_POLYNOMIALS = ["w", "z_a", "z_b", "mask", "t", "g_1", "h_1", "g_2", "h_2"]


def polynomial_labels() -> list[str]:
    return INDEXER_POLYNOMIALS + PROVER_POLYNOMIALS


@dataclass
class IndexInfo:
    num_constraints: int
    num_variables: int
    num_non_zeros: int

    def to_bytes(self) -> bytes:
        from ...serialize.tobytes import u64_bytes

        return (
            u64_bytes(self.num_variables)
            + u64_bytes(self.num_constraints)
            + u64_bytes(self.num_non_zeros)
        )


def max_degree(num_constraints: int, num_variables: int, num_non_zeros: int) -> int:
    zk_bound = 1
    num_padded = max(num_constraints, num_variables)
    h = _domain_size(num_padded)
    k = _domain_size(num_non_zeros)
    return max(3 * h + 2 * zk_bound - 1, 3 * k - 3)


def _domain_size(n: int) -> int:
    s = 1
    while s < max(1, n):
        s *= 2
    return s


Matrix = list[list[tuple[int, int]]]  # rows of (coeff, col)


@dataclass
class MatrixPolynomials:
    row: LabeledPolynomial
    col: LabeledPolynomial
    val: LabeledPolynomial
    row_col: LabeledPolynomial
    row_evals_on_k: list[int]
    col_evals_on_k: list[int]
    val_evals_on_k: list[int]
    row_evals_on_b: list[int]
    col_evals_on_b: list[int]
    val_evals_on_b: list[int]
    row_col_evals_on_b: list[int]


@dataclass
class Index:
    spec: FieldSpec
    index_info: IndexInfo
    a: Matrix
    b: Matrix
    c: Matrix
    a_star: MatrixPolynomials
    b_star: MatrixPolynomials
    c_star: MatrixPolynomials
    device: torch.device

    def max_degree(self) -> int:
        ii = self.index_info
        return max_degree(ii.num_constraints, ii.num_variables, ii.num_non_zeros)

    def iter_polys(self) -> list[LabeledPolynomial]:
        out = []
        for star in (self.a_star, self.b_star, self.c_star):
            out += [star.row, star.col, star.val, star.row_col]
        return out


# ------------------------- indexer -------------------------
def _synthesize(circuit: ConstraintSynthesizer, p: int, mode: SynthesisMode):
    cs = ConstraintSystem(mode)
    circuit.generate_constraints(cs)
    # make square (reference constraint_systems.rs:9-30): pad variables or
    # constraints with identity rows
    nf = cs.num_inputs + cs.num_aux
    nc = cs.num_constraints
    if nf < nc:
        for i in range(nc - nf):
            cs.alloc(f"pad variable {i}", 1 if mode == SynthesisMode.PROVE else None)
    else:
        from ...r1cs.lc import LinearCombination

        zero = LinearCombination()
        for i in range(nf - nc):
            cs.enforce(f"pad constraint {i}", zero, zero, zero)
    return cs


def _matrices_from_cs(cs: ConstraintSystem, p: int):
    ni = cs.num_inputs

    def row_of(lc) -> list[tuple[int, int]]:
        out = []
        for v, coeff in lc.terms.items():
            c = coeff % p
            if c:
                col = v.index if v.kind == "I" else ni + v.index
                out.append((c, col))
        out.sort(key=lambda t: t[1])
        return out

    a = [row_of(con[1]) for con in cs.constraints]
    b = [row_of(con[2]) for con in cs.constraints]
    c = [row_of(con[3]) for con in cs.constraints]
    return a, b, c


def _balance(a: Matrix, b: Matrix):
    """reference constraint_systems.rs balance_matrices."""
    a_density = sum(len(r) for r in a)
    b_density = sum(len(r) for r in b)
    a_denser = a_density > b_density
    for i in range(len(a)):
        if a_denser:
            a_sz, b_sz = len(a[i]), len(b[i])
            a[i], b[i] = b[i], a[i]
            a_density += b_sz - a_sz
            b_density += a_sz - b_sz
            a_denser = a_density > b_density


def compose_matrix_polynomials(
    name: str,
    matrix: Matrix,
    domain_x: HDomain,
    domain_h: HDomain,
    domain_k: HDomain,
    domain_b: HDomain,
    p: int,
) -> MatrixPolynomials:
    h_elements = domain_h.elements
    h_diag = domain_h.diagonal_evals()
    row_vec, col_vec, val_vec, denom_vec = [], [], [], []
    for i, row in enumerate(matrix):
        for v, j in row:
            j2 = domain_h.reindex_by_subdomain(domain_x, j)
            row_vec.append(h_elements[j2])
            col_vec.append(h_elements[i])
            val_vec.append(v)
            denom_vec.append(h_diag[j2])
    val_vec = [
        v * pow(d, -1, p) % p for v, d in zip(val_vec, denom_vec)
    ]
    for _ in range(domain_k.size - len(row_vec)):
        row_vec.append(h_elements[0])
        col_vec.append(h_elements[0])
        val_vec.append(0)
    row_col_vec = [r * c % p for r, c in zip(row_vec, col_vec)]

    row = domain_k.ifft(row_vec)
    col = domain_k.ifft(col_vec)
    val = domain_k.ifft(val_vec)
    row_col = domain_k.ifft(row_col_vec)

    return MatrixPolynomials(
        row=LabeledPolynomial(name + "_row", row),
        col=LabeledPolynomial(name + "_col", col),
        val=LabeledPolynomial(name + "_val", val),
        row_col=LabeledPolynomial(name + "_row_col", row_col),
        row_evals_on_k=row_vec,
        col_evals_on_k=col_vec,
        val_evals_on_k=val_vec,
        row_evals_on_b=domain_b.fft(row),
        col_evals_on_b=domain_b.fft(col),
        val_evals_on_b=domain_b.fft(val),
        row_col_evals_on_b=domain_b.fft(row_col),
    )


def index(spec: FieldSpec, circuit: ConstraintSynthesizer, device="cuda") -> Index:
    p = spec.modulus
    cs = _synthesize(circuit, p, SynthesisMode.SETUP)
    a, b, c = _matrices_from_cs(cs, p)
    _balance(a, b)
    num_inputs = cs.num_inputs
    num_constraints = cs.num_constraints
    num_variables = cs.num_inputs + cs.num_aux
    num_non_zeros = max(
        sum(len(r) for r in m) for m in (a, b, c)
    )
    domain_x = HDomain(spec, num_inputs, device)
    domain_h = HDomain(spec, num_variables, device)
    domain_k = HDomain(spec, num_non_zeros, device)
    domain_b = HDomain(spec, 3 * domain_k.size - 3, device)
    a_star = compose_matrix_polynomials("a", a, domain_x, domain_h, domain_k, domain_b, p)
    b_star = compose_matrix_polynomials("b", b, domain_x, domain_h, domain_k, domain_b, p)
    c_star = compose_matrix_polynomials("c", c, domain_x, domain_h, domain_k, domain_b, p)
    return Index(
        spec=spec,
        index_info=IndexInfo(num_constraints, num_variables, num_non_zeros),
        a=a,
        b=b,
        c=c,
        a_star=a_star,
        b_star=b_star,
        c_star=c_star,
        device=torch.device(device),
    )


# ------------------------- prover -------------------------
@dataclass
class ProverState:
    index: Index
    formatted_input: list[int]
    witness: list[int]
    z_a: list[int]
    z_b: list[int]
    domain_x: HDomain
    domain_h: HDomain
    domain_k: HDomain
    zk_bound: int = 1
    w_poly: LabeledPolynomial | None = None
    mask_poly: LabeledPolynomial | None = None
    z_a_poly: LabeledPolynomial | None = None
    z_b_poly: LabeledPolynomial | None = None
    first_msg: "VerifierFirstMsg | None" = None

    def public_input(self) -> list[int]:
        return self.formatted_input[1:]


@dataclass
class VerifierFirstMsg:
    alpha: int
    eta_a: int
    eta_b: int
    eta_c: int


@dataclass
class VerifierSecondMsg:
    beta: int


def prover_init(index: Index, circuit: ConstraintSynthesizer) -> ProverState:
    p = index.spec.modulus
    cs = _synthesize(circuit, p, SynthesisMode.PROVE)
    formatted_input = [int(v) % p for v in cs.input_values]
    witness = [int(v) % p for v in cs.aux_values]
    ni = len(formatted_input)
    if index.index_info.num_constraints != cs.num_constraints or (
        index.index_info.num_constraints != ni + len(witness)
    ):
        raise SchemeError("instance does not match index")

    def ip(row):
        acc = 0
        for coeff, j in row:
            val = formatted_input[j] if j < ni else witness[j - ni]
            acc += coeff * val
        return acc % p

    z_a = [ip(r) for r in index.a]
    z_b = [ip(r) for r in index.b]
    return ProverState(
        index=index,
        formatted_input=formatted_input,
        witness=witness,
        z_a=z_a,
        z_b=z_b,
        domain_x=HDomain(index.spec, ni, index.device),
        domain_h=HDomain(index.spec, index.index_info.num_constraints, index.device),
        domain_k=HDomain(index.spec, index.index_info.num_non_zeros, index.device),
    )


def _poly_mul(spec: FieldSpec, a: list[int], b: list[int], device) -> list[int]:
    """hpoly.mul(a, b, p) through `ops/poly.poly_mul` on the device: the
    inputs without their trailing zeros up as Montgomery limbs (K1), the
    NTT product, back as ints, trimmed as hpoly.mul trims."""
    df = device_field(spec, device)
    p = spec.modulus
    a, b = ([x % p for x in hpoly.trim(list(v))] for v in (a, b))
    return hpoly.trim(decode_ints(df, poly_mul(df, encode_ints(df, a), encode_ints(df, b))))


def _rand_poly(degree: int, p: int, rng: random.Random) -> list[int]:
    return [rng.randrange(p) for _ in range(degree + 1)]


def _mul_by_vanishing(coeffs: list[int], n: int, p: int) -> list[int]:
    """coeffs * (x^n - 1)"""
    res = [0] * (len(coeffs) + n)
    for i, c in enumerate(coeffs):
        res[i] = (res[i] - c) % p
        res[i + n] = (res[i + n] + c) % p
    return res


def _divide_by_vanishing(coeffs: list[int], n: int, p: int):
    """(quotient, remainder) of division by x^n - 1 (exact long division)."""
    coeffs = list(coeffs)
    q = [0] * max(0, len(coeffs) - n)
    for i in range(len(coeffs) - 1, n - 1, -1):
        c = coeffs[i]
        if c:
            q[i - n] = c
            coeffs[i] = 0
            coeffs[i - n] = (coeffs[i - n] + c) % p
    return q, hpoly.trim(coeffs[:n] if n <= len(coeffs) else coeffs)


def prover_first_round(state: ProverState, rng: random.Random):
    p = state.index.spec.modulus
    zk = state.zk_bound
    dh, dx = state.domain_h, state.domain_x
    x_poly = dx.ifft(state.formatted_input)
    x_evals_on_h = dh.fft(x_poly)
    ratio = dh.size // dx.size
    w_extended = state.witness + [0] * (
        dh.size - dx.size - len(state.witness)
    )
    w_evals_on_h = [
        0 if i % ratio == 0 else (w_extended[i - i // ratio - 1] - x_evals_on_h[i]) % p
        for i in range(dh.size)
    ]
    w_poly = hpoly.add(
        dh.ifft(w_evals_on_h), _mul_by_vanishing(_rand_poly(zk - 1, p, rng), dh.size, p), p
    )
    w_poly, rem = _divide_by_vanishing(w_poly, dx.size, p)
    assert rem == [0], "w must vanish on the input domain"
    z_a_poly = hpoly.add(
        dh.ifft(state.z_a), _mul_by_vanishing(_rand_poly(zk - 1, p, rng), dh.size, p), p
    )
    z_b_poly = hpoly.add(
        dh.ifft(state.z_b), _mul_by_vanishing(_rand_poly(zk - 1, p, rng), dh.size, p), p
    )
    mask_degree = 3 * dh.size + 2 * zk - 3
    mask = _rand_poly(mask_degree, p, rng)
    _, r_rem = _divide_by_vanishing(mask, dh.size, p)
    sigma = r_rem[0] if r_rem else 0
    mask[0] = (mask[0] - sigma) % p  # force sum over H to zero

    w = LabeledPolynomial("w", w_poly, None, zk)
    z_a = LabeledPolynomial("z_a", z_a_poly, None, zk)
    z_b = LabeledPolynomial("z_b", z_b_poly, None, zk)
    mask_lp = LabeledPolynomial("mask", mask, None, None)
    state.w_poly, state.mask_poly = w, mask_lp
    state.z_a_poly, state.z_b_poly = z_a, z_b
    return state, [w, z_a, z_b, mask_lp]


def first_round_degree_bounds(info: IndexInfo):
    return [None] * 4


def prover_second_round(state: ProverState, msg: VerifierFirstMsg):
    p = state.index.spec.modulus
    dh, dx = state.domain_h, state.domain_x
    alpha, eta_a, eta_b, eta_c = msg.alpha, msg.eta_a, msg.eta_b, msg.eta_c

    z_a_poly = state.z_a_poly.coeffs
    z_b_poly = state.z_b_poly.coeffs
    z_c_poly = _poly_mul(state.index.spec, z_a_poly, z_b_poly, state.index.device)
    m_poly = hpoly.add(
        hpoly.scale(z_c_poly, eta_c, p),
        hpoly.add(
            hpoly.scale(z_a_poly, eta_a, p), hpoly.scale(z_b_poly, eta_b, p), p
        ),
        p,
    )
    r_alpha_evals_on_h = dh.batch_evals(alpha)
    r_alpha_poly = dh.ifft(r_alpha_evals_on_h)
    # t
    t_evals_on_h = [0] * dh.size
    for matrix, eta in ((state.index.a, eta_a), (state.index.b, eta_b), (state.index.c, eta_c)):
        for i, row in enumerate(matrix):
            for coeff, j in row:
                idx = dh.reindex_by_subdomain(dx, j)
                t_evals_on_h[idx] = (
                    t_evals_on_h[idx] + eta * coeff % p * r_alpha_evals_on_h[i]
                ) % p
    t_poly = dh.ifft(t_evals_on_h)
    # z
    x_poly = dx.ifft(state.formatted_input)
    z_poly = _mul_by_vanishing(state.w_poly.coeffs, dx.size, p)
    z_poly = hpoly.add(z_poly, x_poly, p)
    # q_1 = mask + r_alpha * m - t * z  (computed on a large enough domain)
    mask_poly = state.mask_poly.coeffs
    domain_size = max(
        len(mask_poly),
        len(hpoly.trim(r_alpha_poly)) + len(hpoly.trim(m_poly)),
        len(hpoly.trim(t_poly)) + len(hpoly.trim(z_poly)),
    )
    dom = HDomain(state.index.spec, domain_size, state.index.device)
    r_evals = dom.fft(r_alpha_poly)
    m_evals = dom.fft(m_poly)
    t_evals = dom.fft(t_poly)
    z_evals = dom.fft(z_poly)
    q1_evals = [
        (r * m - t * z) % p
        for r, m, t, z in zip(r_evals, m_evals, t_evals, z_evals)
    ]
    q_1 = hpoly.add(mask_poly, dom.ifft(q1_evals), p)
    h_1, x_g_1 = _divide_by_vanishing(q_1, dh.size, p)
    g_1 = x_g_1[1:] if len(x_g_1) > 1 else [0]

    oracles = [
        LabeledPolynomial("t", t_poly, None, None),
        LabeledPolynomial("g_1", g_1, dh.size - 2, state.zk_bound),
        LabeledPolynomial("h_1", h_1, None, None),
    ]
    state.first_msg = msg
    return state, oracles


def second_round_degree_bounds(info: IndexInfo):
    h = _domain_size(max(info.num_constraints, info.num_variables))
    return [None, h - 2, None]


def prover_third_round(state: ProverState, msg2: VerifierSecondMsg):
    p = state.index.spec.modulus
    beta = msg2.beta
    msg = state.first_msg
    alpha, eta_a, eta_b, eta_c = msg.alpha, msg.eta_a, msg.eta_b, msg.eta_c
    dh, dk = state.domain_h, state.domain_k
    v_h_alpha = dh.evaluate_vanishing(alpha)
    v_h_beta = dh.evaluate_vanishing(beta)
    stars = (state.index.a_star, state.index.b_star, state.index.c_star)
    etas = (eta_a, eta_b, eta_c)

    inverses = []
    for star in stars:
        inv = [
            pow(
                (beta - star.row_evals_on_k[i]) * (alpha - star.col_evals_on_k[i]) % p,
                -1,
                p,
            )
            for i in range(dk.size)
        ]
        inverses.append(inv)
    t_evals_on_k = [
        sum(
            eta * star.val_evals_on_k[i] % p * inv[i]
            for eta, star, inv in zip(etas, stars, inverses)
        )
        % p
        * v_h_alpha
        % p
        * v_h_beta
        % p
        for i in range(dk.size)
    ]
    t_poly = dk.ifft(t_evals_on_k)
    g_2 = t_poly[1:] if len(t_poly) > 1 else [0]

    domain_b = HDomain(state.index.spec, 3 * dk.size - 3, state.index.device)
    denoms = []
    for star in stars:
        denoms.append(
            [
                (
                    beta * alpha
                    - alpha * star.row_evals_on_b[i]
                    - beta * star.col_evals_on_b[i]
                    + star.row_col_evals_on_b[i]
                )
                % p
                for i in range(domain_b.size)
            ]
        )
    da, db, dc = denoms
    sa, sb, sc = stars
    a_evals_on_b = [
        (
            eta_a * sa.val_evals_on_b[i] % p * db[i] % p * dc[i]
            + eta_b * sb.val_evals_on_b[i] % p * dc[i] % p * da[i]
            + eta_c * sc.val_evals_on_b[i] % p * da[i] % p * db[i]
        )
        % p
        * v_h_alpha
        % p
        * v_h_beta
        % p
        for i in range(domain_b.size)
    ]
    a_poly = domain_b.ifft(a_evals_on_b)
    b_evals_on_b = [da[i] * db[i] % p * dc[i] % p for i in range(domain_b.size)]
    b_poly = domain_b.ifft(b_evals_on_b)
    numer = hpoly.sub(a_poly, _poly_mul(state.index.spec, b_poly, t_poly, state.index.device), p)
    h_2, _ = _divide_by_vanishing(numer, dk.size, p)
    return [
        LabeledPolynomial("g_2", g_2, dk.size - 2, None),
        LabeledPolynomial("h_2", h_2, None, None),
    ]


def third_round_degree_bounds(info: IndexInfo):
    k = _domain_size(info.num_non_zeros)
    return [k - 2, None]


# ------------------------- verifier -------------------------
@dataclass
class VerifierState:
    domain_h: HDomain
    domain_k: HDomain
    eta_a: int | None = None
    eta_b: int | None = None
    eta_c: int | None = None
    alpha: int | None = None
    beta: int | None = None
    gamma: int | None = None


def verifier_first_round(spec: FieldSpec, info: IndexInfo, fs_rng, device="cuda"):
    if info.num_constraints != info.num_variables:
        raise SchemeError("non-square matrix")
    p = spec.modulus
    domain_h = HDomain(spec, info.num_constraints, device)
    domain_k = HDomain(spec, info.num_non_zeros, device)
    msg = VerifierFirstMsg(
        alpha=_sample_outside(domain_h, p, fs_rng),
        eta_a=fs_rng.rand_fr(p),
        eta_b=fs_rng.rand_fr(p),
        eta_c=fs_rng.rand_fr(p),
    )
    state = VerifierState(
        domain_h=domain_h,
        domain_k=domain_k,
        eta_a=msg.eta_a,
        eta_b=msg.eta_b,
        eta_c=msg.eta_c,
        alpha=msg.alpha,
    )
    return state, msg


def verifier_second_round(state: VerifierState, fs_rng, p: int):
    beta = _sample_outside(state.domain_h, p, fs_rng)
    state.beta = beta
    return state, VerifierSecondMsg(beta=beta)


def verifier_third_round(state: VerifierState, fs_rng, p: int):
    state.gamma = fs_rng.rand_fr(p)
    return state


def _sample_outside(domain: HDomain, p: int, fs_rng) -> int:
    t = fs_rng.rand_fr(p)
    while domain.evaluate_vanishing(t) == 0:
        t = fs_rng.rand_fr(p)
    return t


def verifier_query_set(state: VerifierState) -> set[tuple[str, int]]:
    beta, gamma = state.beta, state.gamma
    qs = set()
    for label in ("w", "z_a", "z_b", "mask", "t", "g_1", "h_1"):
        qs.add((label, beta))
    for label in ("g_2", "h_2"):
        qs.add((label, gamma))
    for m in "abc":
        for suffix in ("row", "col", "val", "row_col"):
            qs.add((f"{m}_{suffix}", gamma))
    return qs


def verifier_equality_check(
    spec: FieldSpec,
    public_input: list[int],
    evaluations: dict[tuple[str, int], int],
    state: VerifierState,
) -> bool:
    p = spec.modulus
    alpha, beta, gamma = state.alpha, state.beta, state.gamma
    eta_a, eta_b, eta_c = state.eta_a, state.eta_b, state.eta_c
    dh = state.domain_h
    v_h_alpha = dh.evaluate_vanishing(alpha)
    v_h_beta = dh.evaluate_vanishing(beta)
    r_alpha_beta = dh.bivariate_eval(alpha, beta)

    formatted = [1] + [x % p for x in public_input]
    dx = HDomain(spec, len(formatted), dh.device)
    v_x_beta = dx.evaluate_vanishing(beta)
    x_poly = dx.ifft(formatted)
    x_at_beta = hpoly.evaluate(x_poly, beta, p)

    e = lambda label, pt: evaluations[(label, pt)]
    lhs = (
        e("mask", beta)
        + r_alpha_beta
        * (
            eta_a * e("z_a", beta)
            + eta_b * e("z_b", beta)
            + eta_c * e("z_a", beta) % p * e("z_b", beta)
        )
        - e("t", beta) * (v_x_beta * e("w", beta) + x_at_beta)
    ) % p
    rhs = (e("h_1", beta) * v_h_beta + beta * e("g_1", beta)) % p
    if lhs != rhs:
        return False

    dk = state.domain_k
    v_k_gamma = dk.evaluate_vanishing(gamma)
    k_size = dk.size_as_field_element
    alpha_beta = alpha * beta % p

    denom = {}
    for m in "abc":
        denom[m] = (
            alpha_beta
            - alpha * e(f"{m}_row", gamma)
            - beta * e(f"{m}_col", gamma)
            + e(f"{m}_row_col", gamma)
        ) % p
    a_g = (
        eta_a * e("a_val", gamma) % p * denom["b"] % p * denom["c"]
        + eta_b * e("b_val", gamma) % p * denom["c"] % p * denom["a"]
        + eta_c * e("c_val", gamma) % p * denom["a"] % p * denom["b"]
    ) % p
    a_g = a_g * v_h_alpha % p * v_h_beta % p
    b_g = denom["a"] * denom["b"] % p * denom["c"] % p
    lhs = e("h_2", gamma) * v_k_gamma % p
    rhs = (
        a_g
        - b_g * (gamma * e("g_2", gamma) + e("t", beta) * pow(k_size, -1, p)) % p
    ) % p
    return lhs == rhs
