"""Spartan SNARK: SPARK sparse-MLE evaluation argument over the NIZK core.

Port of the reference's `schemes/spartan/snark.py`, word for word but for
the device: `generate_random_parameters`, `create_snark_proof` and
`verify_snark_proof` take `device` (default "cuda"), which goes down to
the Pedersen commitments (device MSMs of FIXED_BASE_MSM_MIN scalars or
more), to the NIZK core and to the batched cubic sumcheck
(`sum_check_cubic_prover`, `DeviceSumcheck` at tables of
DEVICE_SUMCHECK_MIN or more). `generate_random_parameters` and
`create_snark_proof` take a `timings` dict, which receives the seconds of
their stages. The parameters' generators, the SPARK encoding and its
memory checking are host ints, as in the reference.

Parity: ckb-zkp spartan/src/spark.rs:18-372 (memory-in-the-head
encode, hash/product layers), prover.rs:104-201 + 1062-1809 (snark proof,
sparse_poly_eval_proof, product/hash layer provers, cubic sumcheck),
verify.rs:54-101 + 538-1083 (snark verify, product/hash layer verifies,
timestamp checks), setup.rs:33-180 and lib.rs:31-137 (parameters/API).

The SNARK reuses the NIZK's r1cs-satisfiability argument verbatim and adds a
verifiable evaluation proof for the three matrix MLEs at (rx, ry): the
matrices are committed in setup as address/timestamp/value vectors
("memory in the head"), and evaluation reduces to grand-product memory
consistency checks proven by batched cubic sumchecks over layered product
circuits, plus bullet-IPA openings of the committed vectors.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ...host.pairing import PairingCurve
from ...r1cs import ConstraintSynthesizer
from ...serialize.tobytes import fr_bytes, point_bytes
from ...transcript import Transcript
from ..groth16.prover import Stages
from .common import (
    PolyCommitmentParameters,
    R1CSSatisfiedParameters,
    challenge_fr,
    packing_poly_commit,
    poly_commit_vec,
    r1cs_satisfied_parameters,
)
from .nizk import (
    R1CSInstance,
    generate_r1cs,
    inner_product_proof_prover,
    inner_product_verify,
    r1cs_satisfied_prover,
    r1cs_satisfied_verify,
)
from .polynomial import bound_poly_var_bot, eval_eq, eval_eq_x_y, evaluate_mle

Entry = tuple[int, str, int]


# ---------------- parameters ----------------
@dataclass
class R1CSEvalsParameters:
    ops_params: PolyCommitmentParameters
    mem_params: PolyCommitmentParameters
    derefs_params: PolyCommitmentParameters


@dataclass
class SnarkParameters:
    r1cs_satisfied_params: R1CSSatisfiedParameters
    r1cs_eval_params: R1CSEvalsParameters


def _log2_ceil(x: int) -> int:
    return 0 if x <= 1 else (x - 1).bit_length()


def _next_pow2(x: int) -> int:
    return 1 if x == 0 else 1 << _log2_ceil(x)


def generate_setup_snark_parameters(
    curve: PairingCurve,
    rng: random.Random,
    num_aux: int,
    num_inputs: int,
    num_constraints: int,
    device="cuda",
) -> SnarkParameters:
    """setup.rs:33-55 — satisfiability params + eval params sized for the
    worst-case nnz (setup runs before the matrices are encoded). The
    generator lists' products run on `device` where a list is long enough
    (`common.poly_commitment_parameters`)."""
    from .common import poly_commitment_parameters

    sat = r1cs_satisfied_parameters(curve, rng, num_aux, num_inputs, device)
    t = _next_pow2(max(num_aux, num_inputs))
    m = _next_pow2(max(t * 2, num_constraints))
    n_worst = num_constraints * (t * 2)
    ops_params = poly_commitment_parameters(curve, rng, _log2_ceil(n_worst) + 4, device)
    mem_params = poly_commitment_parameters(curve, rng, _log2_ceil(m * 2) + 1, device)
    derefs_params = poly_commitment_parameters(curve, rng, _log2_ceil(n_worst) + 3, device)
    return SnarkParameters(sat, R1CSEvalsParameters(ops_params, mem_params, derefs_params))


# ---------------- SPARK encode (spark.rs) ----------------
@dataclass
class AddrTimestamps:
    addr_index: list[list[int]]  # raw usize addresses
    addrs: list[list[int]]  # as field elements
    read_ts_list: list[list[int]]
    audit_ts: list[int]


@dataclass
class EncodeMemory:
    row_addr_ts: AddrTimestamps
    col_addr_ts: AddrTimestamps
    val_list: list[list[int]]
    ops_list: list[int]
    mem_list: list[int]


@dataclass
class EncodeCommit:
    n: int
    m: int
    ops_commit: list
    mem_commit: list


def switch_matrix_to_list(
    matrix: list[list[Entry]], witness_len: int, p: int
) -> tuple[list[int], list[int], list[int]]:
    """r1cs.rs:205-243 — sparse rows to (vals, rows, cols); aux columns at
    their index, input columns shifted by witness_len; dups merged, zeros
    dropped, cols sorted within a row."""
    vals: list[int] = []
    rows: list[int] = []
    cols: list[int] = []
    for row, entries in enumerate(matrix):
        ms: dict[int, int] = {}
        for val, kind, idx in entries:
            col = idx if kind == "A" else idx + witness_len
            ms[col] = (ms.get(col, 0) + val) % p
        for col in sorted(ms):
            if ms[col] != 0:
                rows.append(row)
                cols.append(col)
                vals.append(ms[col])
    return vals, rows, cols


def memory_in_the_head(addrs_list: list[list[int]], n: int, m: int) -> AddrTimestamps:
    """spark.rs:132-176 — audit memory shared sequentially across the lists."""
    audit_ts = [0] * m
    read_ts_list = []
    addr_fr_list = []
    for addrs in addrs_list:
        assert len(addrs) == n
        read_ts = [0] * n
        for i, addr in enumerate(addrs):
            r_ts = audit_ts[addr]
            read_ts[i] = r_ts
            audit_ts[addr] = r_ts + 1
        read_ts_list.append(read_ts)
        addr_fr_list.append(list(addrs))
    return AddrTimestamps(addrs_list, addr_fr_list, read_ts_list, list(audit_ts))


def encode(
    params: SnarkParameters, r1cs: R1CSInstance, rng: random.Random, device="cuda"
) -> tuple[EncodeMemory, EncodeCommit]:
    """spark.rs:18-105."""
    p = r1cs.curve.fr.modulus
    t = _next_pow2(max(r1cs.num_aux, r1cs.num_inputs))
    m = _next_pow2(max(t * 2, r1cs.num_constraints))
    a_val, a_row, a_col = switch_matrix_to_list(r1cs.a_matrix, t, p)
    b_val, b_row, b_col = switch_matrix_to_list(r1cs.b_matrix, t, p)
    c_val, c_row, c_col = switch_matrix_to_list(r1cs.c_matrix, t, p)
    n = _next_pow2(max(len(a_row), len(b_row), len(c_row)))
    for lst in (a_row, b_row, c_row, a_col, b_col, c_col):
        lst.extend([0] * (n - len(lst)))
    for lst in (a_val, b_val, c_val):
        lst.extend([0] * (n - len(lst)))
    val_list = [a_val, b_val, c_val]

    row_addr_ts = memory_in_the_head([a_row, b_row, c_row], n, m)
    col_addr_ts = memory_in_the_head([a_col, b_col, c_col], n, m)

    ops_list: list[int] = []
    for lst in (
        *row_addr_ts.addrs,
        *row_addr_ts.read_ts_list,
        *col_addr_ts.addrs,
        *col_addr_ts.read_ts_list,
        *val_list,
    ):
        ops_list.extend(lst)
    ops_list.extend([0] * (_next_pow2(len(ops_list)) - len(ops_list)))
    ops_gen = params.r1cs_eval_params.ops_params.gen_n
    ops_commit, _ = packing_poly_commit(
        r1cs.curve, ops_gen.generators, ops_list, ops_gen.h, rng, False, device=device
    )

    mem_list = list(row_addr_ts.audit_ts) + list(col_addr_ts.audit_ts)
    mem_list.extend([0] * (_next_pow2(len(mem_list)) - len(mem_list)))
    mem_gen = params.r1cs_eval_params.mem_params.gen_n
    mem_commit, _ = packing_poly_commit(
        r1cs.curve, mem_gen.generators, mem_list, mem_gen.h, rng, False, device=device
    )

    return (
        EncodeMemory(row_addr_ts, col_addr_ts, val_list, ops_list, mem_list),
        EncodeCommit(n, m, ops_commit, mem_commit),
    )


def equalize_length(rx: list[int], ry: list[int]) -> tuple[list[int], list[int]]:
    """spark.rs:107-130 — zero-pad the shorter vector at the FRONT."""
    if len(rx) < len(ry):
        return [0] * (len(ry) - len(rx)) + list(rx), list(ry)
    if len(rx) > len(ry):
        return list(rx), [0] * (len(rx) - len(ry)) + list(ry)
    return list(rx), list(ry)


# ---------------- product circuits (spark.rs:209-372) ----------------
@dataclass
class ProductCircuit:
    left_vec: list[list[int]]
    right_vec: list[list[int]]


def circuit_hash(a_list, v_list, t_list, gamma: int, p: int) -> list[int]:
    """h_gamma(a, v, t) = a*gamma^2 + v*gamma + t (spark.rs:298-312)."""
    g2 = gamma * gamma % p
    return [
        (a * g2 + v * gamma + t) % p for a, v, t in zip(a_list, v_list, t_list)
    ]


def construct_product_circuit(values: list[int], p: int) -> ProductCircuit:
    left_vec, right_vec = [], []
    lst = list(values)
    layers = _log2_ceil(len(lst))
    for _ in range(layers):
        tlen = len(lst) // 2
        if tlen * 2 < len(lst):
            lst.append(1)
            tlen += 1
        left = lst[:tlen]
        right = lst[tlen:]
        lst = [left[j] * right[j] % p for j in range(tlen)]
        left_vec.append(left)
        right_vec.append(right)
    return ProductCircuit(left_vec, right_vec)


def evaluate_product_circuit(c: ProductCircuit, p: int) -> int:
    return c.left_vec[-1][0] * c.right_vec[-1][0] % p


def evaluate_dot_product_circuit(row, col, val, p: int) -> int:
    return sum(r * c % p * v for r, c, v in zip(row, col, val)) % p


@dataclass
class HashForMemoryChecking:
    init_hash: list[int]
    read_ts_hash_list: list[list[int]]
    write_ts_hash_list: list[list[int]]
    audit_ts_hash: list[int]


@dataclass
class ProdForMemoryChecking:
    init_prod: ProductCircuit
    read_ts_prod_list: list[ProductCircuit]
    write_ts_prod_list: list[ProductCircuit]
    audit_ts_prod: ProductCircuit


@dataclass
class MemoryLayer:
    hash: HashForMemoryChecking
    prod: ProdForMemoryChecking


def memory_checking(
    lists, mem, read_ts_list, audit_ts, e_list, gamma: tuple[int, int], p: int
) -> MemoryLayer:
    """spark.rs:209-296 — grand-product consistency: init*write == read*audit."""
    gamma1, gamma2 = gamma
    init_a = list(range(len(mem)))
    init_hash = circuit_hash(init_a, mem, [0] * len(mem), gamma1, p)
    read_ts_hash_list, write_ts_hash_list = [], []
    for lst, read_ts, e in zip(lists, read_ts_list, e_list):
        write_ts = [(ts + 1) % p for ts in read_ts]
        read_ts_hash_list.append(circuit_hash(lst, e, read_ts, gamma1, p))
        write_ts_hash_list.append(circuit_hash(lst, e, write_ts, gamma1, p))
    audit_ts_hash = circuit_hash(init_a, mem, audit_ts, gamma1, p)

    init_prod = construct_product_circuit([(h - gamma2) % p for h in init_hash], p)
    read_ts_prod_list = [
        construct_product_circuit([(h - gamma2) % p for h in hs], p)
        for hs in read_ts_hash_list
    ]
    write_ts_prod_list = [
        construct_product_circuit([(h - gamma2) % p for h in hs], p)
        for hs in write_ts_hash_list
    ]
    audit_ts_prod = construct_product_circuit(
        [(h - gamma2) % p for h in audit_ts_hash], p
    )

    init = evaluate_product_circuit(init_prod, p)
    read = 1
    for c in read_ts_prod_list:
        read = read * evaluate_product_circuit(c, p) % p
    write = 1
    for c in write_ts_prod_list:
        write = write * evaluate_product_circuit(c, p) % p
    audit = evaluate_product_circuit(audit_ts_prod, p)
    assert init * write % p == read * audit % p

    return MemoryLayer(
        HashForMemoryChecking(init_hash, read_ts_hash_list, write_ts_hash_list, audit_ts_hash),
        ProdForMemoryChecking(init_prod, read_ts_prod_list, write_ts_prod_list, audit_ts_prod),
    )


def circuit_eval_opt(
    encode_mem: EncodeMemory, gamma, e_list, mem, p: int
) -> tuple[MemoryLayer, MemoryLayer]:
    e_row, e_col = e_list
    mem_row, mem_col = mem
    row_layer = memory_checking(
        encode_mem.row_addr_ts.addrs, mem_row, encode_mem.row_addr_ts.read_ts_list,
        encode_mem.row_addr_ts.audit_ts, e_row, gamma, p,
    )
    col_layer = memory_checking(
        encode_mem.col_addr_ts.addrs, mem_col, encode_mem.col_addr_ts.read_ts_list,
        encode_mem.col_addr_ts.audit_ts, e_col, gamma, p,
    )
    return row_layer, col_layer


# ---------------- proof data structures ----------------
@dataclass
class LayerProductCircuitProof:
    polys: list[list[int]]  # cubic coeffs [d, c, b, a] per round
    claim_prod_left: list[int]
    claim_prod_right: list[int]


@dataclass
class ProductCircuitEvalProof:
    layers_proof: list[LayerProductCircuitProof]
    claim_dotp: tuple[list[int], list[int], list[int]]


@dataclass
class ProductLayerProof:
    proof_memory: ProductCircuitEvalProof
    proof_ops: ProductCircuitEvalProof
    eval_dotp: tuple[list[int], list[int]]
    eval_row: tuple[int, list[int], list[int], int]
    eval_col: tuple[int, list[int], list[int], int]


@dataclass
class HashLayerProof:
    proof_derefs: object
    proof_ops: object
    proof_mem: object
    evals_derefs: tuple[list[int], list[int]]
    evals_row: tuple[list[int], list[int], int]
    evals_col: tuple[list[int], list[int], int]
    evals_val: list[int]


@dataclass
class R1CSEvalsProof:
    prod_layer_proof: ProductLayerProof
    hash_layer_proof: HashLayerProof
    derefs_commit: list


@dataclass
class SNARKProof:
    r1cs_satisfied_proof: object
    matrix_evals: tuple[int, int, int]
    r1cs_evals_proof: R1CSEvalsProof


# ---------------- prover ----------------
def _poly_eval(coeffs: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def sum_check_cubic_prover(
    curve, num_rounds, claim,
    poly_a_par: list[list[int]], poly_b_par: list[list[int]], poly_c_par: list[int],
    poly_a_seq: list[list[int]], poly_b_seq: list[list[int]], poly_c_seq: list[list[int]],
    coeffs: list[int], transcript: Transcript, device="cuda",
):
    """prover.rs:1442-1607 — batched degree-3 sumcheck over parallel
    (left*right*eq) triples and sequential (row*col*val) triples.

    Large tables run the halving recurrence on device (ops/sumcheck.py,
    SURVEY hard part #4) exactly like the nizk/libra/hyrax provers; only
    the three round evals cross to the host per round. Bit-identical to
    the host-int path (same field algebra on canonical Montgomery limbs)."""
    p = curve.fr.modulus
    claim_per_round = claim
    r = []
    cubic_polys = []

    from ...ops.sumcheck import DEVICE_SUMCHECK_MIN, DeviceSumcheck

    table_len = len(poly_c_par)
    ds = (
        DeviceSumcheck(curve.fr, device=device)
        if table_len >= DEVICE_SUMCHECK_MIN
        else None
    )
    if ds is not None:
        d_c_par = ds.encode_table(poly_c_par)
        d_a_par = [ds.encode_table(v) for v in poly_a_par]
        d_b_par = [ds.encode_table(v) for v in poly_b_par]
        d_a_seq = [ds.encode_table(v) for v in poly_a_seq]
        d_b_seq = [ds.encode_table(v) for v in poly_b_seq]
        d_c_seq = [ds.encode_table(v) for v in poly_c_seq]

    def triple_evals(a, b, c):
        e0 = e2 = e3 = 0
        slen = len(a) // 2
        for i in range(slen):
            e0 = (e0 + a[i] * b[i] % p * c[i]) % p
            ta = (2 * a[slen + i] - a[i]) % p
            tb = (2 * b[slen + i] - b[i]) % p
            tc = (2 * c[slen + i] - c[i]) % p
            e2 = (e2 + ta * tb % p * tc) % p
            ta = (3 * a[slen + i] - 2 * a[i]) % p
            tb = (3 * b[slen + i] - 2 * b[i]) % p
            tc = (3 * c[slen + i] - 2 * c[i]) % p
            e3 = (e3 + ta * tb % p * tc) % p
        return e0, e2, e3

    inv2 = pow(2, -1, p)
    inv6 = pow(6, -1, p)
    from .polynomial import combine_with_r

    for _ in range(num_rounds):
        if ds is not None:
            triples = [(a, b, d_c_par) for a, b in zip(d_a_par, d_b_par)]
            triples += list(zip(d_a_seq, d_b_seq, d_c_seq))
            evals = ds.cubic3_round_many(triples)
        else:
            evals = [
                triple_evals(a, b, poly_c_par)
                for a, b in zip(poly_a_par, poly_b_par)
            ]
            evals += [
                triple_evals(a, b, c)
                for a, b, c in zip(poly_a_seq, poly_b_seq, poly_c_seq)
            ]
        assert len(coeffs) == len(evals)
        e0 = sum(ev[0] * co % p for ev, co in zip(evals, coeffs)) % p
        e1 = (claim_per_round - e0) % p
        e2 = sum(ev[1] * co % p for ev, co in zip(evals, coeffs)) % p
        e3 = sum(ev[2] * co % p for ev, co in zip(evals, coeffs)) % p
        a_c = (-e0 + 3 * e1 - 3 * e2 + e3) % p * inv6 % p
        b_c = (2 * e0 - 5 * e1 + 4 * e2 - e3) % p * inv2 % p
        c_c = (e1 - e0 - a_c - b_c) % p
        d_c = e0
        poly = [d_c, c_c, b_c, a_c]
        transcript.append_message(b"comm_poly", b"".join(fr_bytes(curve, x) for x in poly))
        r_j = challenge_fr(curve, transcript, b"challenge_nextround")
        if ds is not None:
            d_c_par = ds.bind(d_c_par, r_j)
            d_a_par = [ds.bind(v, r_j) for v in d_a_par]
            d_b_par = [ds.bind(v, r_j) for v in d_b_par]
            d_a_seq = [ds.bind(v, r_j) for v in d_a_seq]
            d_b_seq = [ds.bind(v, r_j) for v in d_b_seq]
            d_c_seq = [ds.bind(v, r_j) for v in d_c_seq]
        else:
            poly_c_par[:] = combine_with_r(poly_c_par, r_j, p)
            for lst in (*poly_a_par, *poly_b_par):
                lst[:] = combine_with_r(lst, r_j, p)
            for lst in (*poly_a_seq, *poly_b_seq, *poly_c_seq):
                lst[:] = combine_with_r(lst, r_j, p)
        claim_per_round = _poly_eval(poly, r_j, p)
        r.append(r_j)
        cubic_polys.append(poly)

    if ds is not None:
        finals = ds.firsts(
            *d_a_par, *d_b_par, d_c_par, *d_a_seq, *d_b_seq, *d_c_seq
        )
        na, nb = len(d_a_par), len(d_b_par)
        ns = len(d_a_seq)
        claim_prod = (finals[:na], finals[na : na + nb], finals[na + nb])
        rest = finals[na + nb + 1 :]
        claim_dotp = (rest[:ns], rest[ns : 2 * ns], rest[2 * ns :])
    else:
        claim_prod = (
            [a[0] for a in poly_a_par],
            [b[0] for b in poly_b_par],
            poly_c_par[0],
        )
        claim_dotp = (
            [a[0] for a in poly_a_seq],
            [b[0] for b in poly_b_seq],
            [c[0] for c in poly_c_seq],
        )
    return cubic_polys, r, claim_prod, claim_dotp


def product_circuit_eval_prover(
    curve, prod_circuit_vec: list[ProductCircuit],
    dotp_circuit_vec: list[tuple[list[int], list[int], list[int]]],
    transcript: Transcript, device="cuda",
):
    """prover.rs:1313-1440 — per-layer batched sumchecks, top layer first."""
    p = curve.fr.modulus
    layer_num = len(prod_circuit_vec[0].left_vec)
    claims_to_verify = [evaluate_product_circuit(c, p) for c in prod_circuit_vec]
    layers_proof = []
    rands: list[int] = []
    final_claim_dotp: tuple[list[int], list[int], list[int]] = ([], [], [])

    # local copies so sumcheck binding never corrupts the caller's circuits
    left_layers = [[list(l) for l in c.left_vec] for c in prod_circuit_vec]
    right_layers = [[list(l) for l in c.right_vec] for c in prod_circuit_vec]
    dotp_local = [
        (list(row), list(col), list(val)) for row, col, val in dotp_circuit_vec
    ]

    for i in reversed(range(layer_num)):
        poly_left = [layers[i] for layers in left_layers]
        poly_right = [layers[i] for layers in right_layers]
        poly_rand = eval_eq(rands, p)
        assert len(poly_rand) == len(poly_left[0])
        poly_row, poly_col, poly_val = [], [], []
        if i == 0 and dotp_local:
            for row, col, val in dotp_local:
                claims_to_verify.append(evaluate_dot_product_circuit(row, col, val, p))
                poly_row.append(row)
                poly_col.append(col)
                poly_val.append(val)
        coeffs = [
            challenge_fr(curve, transcript, b"rand_coeffs_next_layer")
            for _ in claims_to_verify
        ]
        claim = sum(c * co % p for c, co in zip(claims_to_verify, coeffs)) % p
        num_rounds = _log2_ceil(len(poly_rand))
        polys, rand_prod, claim_prod, claim_dotp = sum_check_cubic_prover(
            curve, num_rounds, claim,
            poly_left, poly_right, poly_rand,
            poly_row, poly_col, poly_val, coeffs, transcript, device=device,
        )
        claim_prod_left, claim_prod_right, _ = claim_prod
        for cl, cr in zip(claim_prod_left, claim_prod_right):
            transcript.append_message(b"claim_prod_left", fr_bytes(curve, cl))
            transcript.append_message(b"claim_prod_right", fr_bytes(curve, cr))
        if i == 0 and dotp_local:
            final_claim_dotp = claim_dotp
            for dr, dc, dv in zip(*claim_dotp):
                transcript.append_message(b"claim_dotp_row", fr_bytes(curve, dr))
                transcript.append_message(b"claim_dotp_col", fr_bytes(curve, dc))
                transcript.append_message(b"claim_dotp_val", fr_bytes(curve, dv))
        r_layer = challenge_fr(curve, transcript, b"challenge_r_layer")
        claims_to_verify = [
            (cl + r_layer * ((cr - cl) % p)) % p
            for cl, cr in zip(claim_prod_left, claim_prod_right)
        ]
        rands = [r_layer] + rand_prod
        layers_proof.append(
            LayerProductCircuitProof(polys, claim_prod_left, claim_prod_right)
        )

    return ProductCircuitEvalProof(layers_proof, final_claim_dotp), rands


def product_layer_prover(
    curve, encode_mem: EncodeMemory, e_list, prod_list, evals: list[int],
    transcript: Transcript, device="cuda",
):
    """prover.rs:1164-1311."""
    p = curve.fr.modulus
    transcript.append_message(b"protocol-name", b"Sparse polynomial product layer proof")
    e_row, e_col = e_list
    row_prod, col_prod = prod_list

    def layer_evals(prod: ProdForMemoryChecking):
        init = evaluate_product_circuit(prod.init_prod, p)
        read_list = [evaluate_product_circuit(c, p) for c in prod.read_ts_prod_list]
        write_list = [evaluate_product_circuit(c, p) for c in prod.write_ts_prod_list]
        audit = evaluate_product_circuit(prod.audit_ts_prod, p)
        read = write = 1
        for v in read_list:
            read = read * v % p
        for v in write_list:
            write = write * v % p
        assert init * write % p == read * audit % p
        return init, read_list, write_list, audit

    row_init, row_read_list, row_write_list, row_audit = layer_evals(row_prod)
    transcript.append_message(b"claim_row_eval_init", fr_bytes(curve, row_init))
    transcript.append_message(b"claim_row_eval_read", b"".join(fr_bytes(curve, v) for v in row_read_list))
    transcript.append_message(b"claim_row_eval_write", b"".join(fr_bytes(curve, v) for v in row_write_list))
    transcript.append_message(b"claim_row_eval_audit", fr_bytes(curve, row_audit))
    col_init, col_read_list, col_write_list, col_audit = layer_evals(col_prod)
    transcript.append_message(b"claim_col_eval_init", fr_bytes(curve, col_init))
    transcript.append_message(b"claim_col_eval_read", b"".join(fr_bytes(curve, v) for v in col_read_list))
    transcript.append_message(b"claim_col_eval_write", b"".join(fr_bytes(curve, v) for v in col_write_list))
    transcript.append_message(b"claim_col_eval_audit", fr_bytes(curve, col_audit))

    # dot products row[i]·col[i]·val[i], split left/right halves
    dotp_circuits = []
    eval_dotp_left_list, eval_dotp_right_list = [], []
    for i in range(len(e_row)):
        row, col, val = e_row[i], e_col[i], encode_mem.val_list[i]
        idx = len(row) // 2
        left = (row[:idx], col[:idx], val[:idx])
        right = (row[idx:], col[idx:], val[idx:])
        ev_l = evaluate_dot_product_circuit(*left, p)
        ev_r = evaluate_dot_product_circuit(*right, p)
        transcript.append_message(b"claim_eval_dotp_left", fr_bytes(curve, ev_l))
        transcript.append_message(b"claim_eval_dotp_right", fr_bytes(curve, ev_r))
        assert (ev_l + ev_r) % p == evals[i] % p
        eval_dotp_left_list.append(ev_l)
        eval_dotp_right_list.append(ev_r)
        dotp_circuits.append(left)
        dotp_circuits.append(right)

    ops_circuits = (
        row_prod.read_ts_prod_list
        + row_prod.write_ts_prod_list
        + col_prod.read_ts_prod_list
        + col_prod.write_ts_prod_list
    )
    proof_ops, ops_rands = product_circuit_eval_prover(
        curve, ops_circuits, dotp_circuits, transcript, device=device
    )
    mem_circuits = [
        row_prod.init_prod,
        row_prod.audit_ts_prod,
        col_prod.init_prod,
        col_prod.audit_ts_prod,
    ]
    proof_memory, mem_rands = product_circuit_eval_prover(
        curve, mem_circuits, [], transcript, device=device
    )
    proof = ProductLayerProof(
        proof_memory,
        proof_ops,
        (eval_dotp_left_list, eval_dotp_right_list),
        (row_init, row_read_list, row_write_list, row_audit),
        (col_init, col_read_list, col_write_list, col_audit),
    )
    return proof, ops_rands, mem_rands


def pre_prover_for_timestamp(ops_rands, mem_rands, ts: AddrTimestamps, p: int):
    """prover.rs:1780-1809 — evaluate addr/read_ts/audit MLEs at the rands."""
    eq_ops = eval_eq(ops_rands, p)
    eq_mem = eval_eq(mem_rands, p)
    eval_addr = [
        sum(a * e % p for a, e in zip(lst, eq_ops)) % p for lst in ts.addrs
    ]
    eval_read = [
        sum(a * e % p for a, e in zip(lst, eq_ops)) % p for lst in ts.read_ts_list
    ]
    eval_audit = sum(a * e % p for a, e in zip(ts.audit_ts, eq_mem)) % p
    return eval_addr, eval_read, eval_audit


def _combine_n_to_one(curve, evals: list[int], transcript: Transcript, label: bytes):
    """Fold a small eval vector to one claim with fresh challenges."""
    p = curve.fr.modulus
    cs = [
        challenge_fr(curve, transcript, label) for _ in range(_log2_ceil(len(evals)))
    ]
    folded = list(evals)
    for i in reversed(range(len(cs))):
        folded = bound_poly_var_bot(folded, cs[i], p)
    assert len(folded) == 1
    return cs, folded[0]


def hash_layer_prover(
    curve, params: R1CSEvalsParameters, encode_mem: EncodeMemory,
    ops_rands, mem_rands, e_row, e_col, e_comb_list, rng, transcript: Transcript, device="cuda",
) -> HashLayerProof:
    """prover.rs:1609-1778."""
    p = curve.fr.modulus
    transcript.append_message(b"protocol-name", b"Sparse polynomial hash layer proof")
    eq_ops = eval_eq(ops_rands, p)
    eval_row_ops_val = [
        sum(v * e % p for v, e in zip(lst, eq_ops)) % p for lst in e_row
    ]
    eval_col_ops_val = [
        sum(v * e % p for v, e in zip(lst, eq_ops)) % p for lst in e_col
    ]
    evals = eval_row_ops_val + eval_col_ops_val
    evals += [0] * (_next_pow2(len(evals)) - len(evals))
    transcript.append_message(b"protocol-name", b"Derefs evaluation proof")
    transcript.append_message(b"evals_ops_val", b"".join(fr_bytes(curve, v) for v in evals))
    cs, claim_eval = _combine_n_to_one(curve, evals, transcript, b"challenge_combine_n_to_one")
    rs = cs + list(ops_rands)
    transcript.append_message(b"joint_claim_eval", fr_bytes(curve, claim_eval))
    proof_derefs, _ = inner_product_proof_prover(
        curve, params.derefs_params, e_comb_list, [], rs, 0, claim_eval, rng, transcript,
        device=device
    )

    row_eval_addr, row_eval_read, row_eval_audit = pre_prover_for_timestamp(
        ops_rands, mem_rands, encode_mem.row_addr_ts, p
    )
    col_eval_addr, col_eval_read, col_eval_audit = pre_prover_for_timestamp(
        ops_rands, mem_rands, encode_mem.col_addr_ts, p
    )
    eval_val_list = [
        sum(v * e % p for v, e in zip(lst, eq_ops)) % p for lst in encode_mem.val_list
    ]
    evals_ops = (
        row_eval_addr + row_eval_read + col_eval_addr + col_eval_read + eval_val_list
    )
    evals_ops += [0] * (_next_pow2(len(evals_ops)) - len(evals_ops))
    transcript.append_message(b"claim_evals_ops", b"".join(fr_bytes(curve, v) for v in evals_ops))
    cs_ops, claim_eval_ops = _combine_n_to_one(
        curve, evals_ops, transcript, b"challenge_combine_n_to_one"
    )
    rs_ops = cs_ops + list(ops_rands)
    transcript.append_message(b"joint_claim_eval_ops", fr_bytes(curve, claim_eval_ops))
    proof_ops, _ = inner_product_proof_prover(
        curve, params.ops_params, encode_mem.ops_list, [], rs_ops, 0, claim_eval_ops, rng, transcript,
        device=device
    )

    evals_mem = [row_eval_audit, col_eval_audit]
    transcript.append_message(b"claim_evals_mem", b"".join(fr_bytes(curve, v) for v in evals_mem))
    cs_mem, claim_eval_mem = _combine_n_to_one(
        curve, evals_mem, transcript, b"challenge_combine_two_to_one"
    )
    rs_mem = cs_mem + list(mem_rands)
    transcript.append_message(b"joint_claim_eval_mem", fr_bytes(curve, claim_eval_mem))
    proof_mem, _ = inner_product_proof_prover(
        curve, params.mem_params, encode_mem.mem_list, [], rs_mem, 0, claim_eval_mem, rng, transcript,
        device=device
    )

    return HashLayerProof(
        proof_derefs,
        proof_ops,
        proof_mem,
        (eval_row_ops_val, eval_col_ops_val),
        (row_eval_addr, row_eval_read, row_eval_audit),
        (col_eval_addr, col_eval_read, col_eval_audit),
        eval_val_list,
    )


def sparse_poly_eval_proof(
    curve, params: R1CSEvalsParameters, rx, ry, evals, encode_mem: EncodeMemory,
    rng, transcript: Transcript, device="cuda", timings: dict | None = None,
) -> R1CSEvalsProof:
    """prover.rs:1062-1162. `timings`, when given, receives the seconds of
    the stages: spark_derefs (the eq tables of rx and ry, the derefs and
    their commitment), memory_checking (the product circuits and their
    sumchecks) and spark_openings (the hash layer's openings)."""
    st = Stages(timings, device)
    p = curve.fr.modulus
    transcript.append_message(b"protocol-name", b"sparse polynomial evaluation proof")
    rows, cols = equalize_length(rx, ry)
    mem_row = eval_eq(rows, p)
    mem_col = eval_eq(cols, p)
    e_row = [
        [mem_row[a] for a in addrs] for addrs in encode_mem.row_addr_ts.addr_index
    ]
    e_col = [
        [mem_col[a] for a in addrs] for addrs in encode_mem.col_addr_ts.addr_index
    ]
    e_list: list[int] = []
    for lst in (*e_row, *e_col):
        e_list.extend(lst)
    e_list += [0] * (_next_pow2(len(e_list)) - len(e_list))
    dg = params.derefs_params.gen_n
    derefs_commit, _ = packing_poly_commit(
        curve, dg.generators, e_list, dg.h, rng, False, device=device
    )
    transcript.append_message(
        b"comm_poly_row_col_ops_val",
        b"".join(point_bytes(curve, c) for c in derefs_commit),
    )
    st.mark("spark_derefs")
    gamma = (
        challenge_fr(curve, transcript, b"challenge_gamma_hash"),
        challenge_fr(curve, transcript, b"challenge_gamma_hash"),
    )
    row_layer, col_layer = circuit_eval_opt(
        encode_mem, gamma, (e_row, e_col), (mem_row, mem_col), p
    )
    prod_layer_proof, ops_rands, mem_rands = product_layer_prover(
        curve, encode_mem, (e_row, e_col), (row_layer.prod, col_layer.prod),
        list(evals), transcript, device=device,
    )
    st.mark("memory_checking")
    hash_layer_proof = hash_layer_prover(
        curve, params, encode_mem, ops_rands, mem_rands, e_row, e_col, e_list,
        rng, transcript, device=device,
    )
    st.mark("spark_openings")
    return R1CSEvalsProof(prod_layer_proof, hash_layer_proof, derefs_commit)


def create_snark_proof(
    curve: PairingCurve,
    params: SnarkParameters,
    r1cs: R1CSInstance,
    circuit: ConstraintSynthesizer,
    encode_mem: EncodeMemory,
    encode_commit: EncodeCommit,
    r1cs_hash: int,
    params_hash: int,
    encode_hash: int,
    rng: random.Random,
    device="cuda",
    timings: dict | None = None,
) -> SNARKProof:
    """prover.rs:137-201. `timings`, when given, receives the seconds of
    the stages: those of the NIZK core (`r1cs_satisfied_prover`), then
    matrix_evals (the three matrix MLEs at (rx, ry), host ints) and the
    SPARK evaluation's (`sparse_poly_eval_proof`)."""
    p = curve.fr.modulus
    transcript = Transcript(b"Spartan SNARK proof")
    transcript.append_message(b"r1cs_hash", fr_bytes(curve, r1cs_hash))
    transcript.append_message(b"params_hash", fr_bytes(curve, params_hash))
    transcript.append_message(b"encode_hash", fr_bytes(curve, encode_hash))
    sat_proof, (rx, ry) = r1cs_satisfied_prover(
        curve, params.r1cs_satisfied_params, r1cs, circuit, rng, transcript, device=device,
        timings=timings,
    )
    st = Stages(timings, device)
    eval_a = evaluate_mle(r1cs.a_matrix, rx, ry, p)
    eval_b = evaluate_mle(r1cs.b_matrix, rx, ry, p)
    eval_c = evaluate_mle(r1cs.c_matrix, rx, ry, p)
    transcript.append_message(b"Ar_claim", fr_bytes(curve, eval_a))
    transcript.append_message(b"Br_claim", fr_bytes(curve, eval_b))
    transcript.append_message(b"Cr_claim", fr_bytes(curve, eval_c))
    transcript.append_u64(b"n", encode_commit.n)
    transcript.append_u64(b"m", encode_commit.m)
    transcript.append_message(
        b"encode_mem_commit", b"".join(point_bytes(curve, c) for c in encode_commit.mem_commit)
    )
    transcript.append_message(
        b"encode_ops_commit", b"".join(point_bytes(curve, c) for c in encode_commit.ops_commit)
    )
    evals = (eval_a, eval_b, eval_c)
    st.mark("matrix_evals")
    evals_proof = sparse_poly_eval_proof(
        curve, params.r1cs_eval_params, rx, ry, evals, encode_mem, rng, transcript, device=device,
        timings=timings,
    )
    return SNARKProof(sat_proof, evals, evals_proof)


# ---------------- verifier ----------------
def sum_check_cubic_verify(curve, polys, num_rounds, claim, transcript: Transcript):
    """verify.rs:817-841."""
    p = curve.fr.modulus
    claim_per_round = claim
    r = []
    assert len(polys) == num_rounds
    for poly in polys:
        transcript.append_message(b"comm_poly", b"".join(fr_bytes(curve, x) for x in poly))
        if (_poly_eval(poly, 0, p) + _poly_eval(poly, 1, p)) % p != claim_per_round % p:
            raise ValueError("cubic sumcheck round mismatch")
        r_j = challenge_fr(curve, transcript, b"challenge_nextround")
        claim_per_round = _poly_eval(poly, r_j, p)
        r.append(r_j)
    return r, claim_per_round


def product_circuit_eval_verify(
    curve, proof: ProductCircuitEvalProof, claims_prod_circuit, claims_dotp_circuit,
    n: int, transcript: Transcript,
):
    """verify.rs:717-815."""
    p = curve.fr.modulus
    layer_num = _log2_ceil(n)
    claims_to_verify = list(claims_prod_circuit)
    assert len(proof.layers_proof) == layer_num
    num_rounds = 0
    rands: list[int] = []
    claims_to_verify_dotp: list[int] = []
    for i in range(layer_num):
        if i == layer_num - 1:
            claims_to_verify.extend(claims_dotp_circuit)
        coeffs = [
            challenge_fr(curve, transcript, b"rand_coeffs_next_layer")
            for _ in claims_to_verify
        ]
        claim = sum(c * co % p for c, co in zip(claims_to_verify, coeffs)) % p
        r, claim_final = sum_check_cubic_verify(
            curve, proof.layers_proof[i].polys, num_rounds, claim, transcript
        )
        claim_prod_left = proof.layers_proof[i].claim_prod_left
        claim_prod_right = proof.layers_proof[i].claim_prod_right
        assert len(claim_prod_left) == len(claim_prod_right) == len(claims_prod_circuit)
        for cl, cr in zip(claim_prod_left, claim_prod_right):
            transcript.append_message(b"claim_prod_left", fr_bytes(curve, cl))
            transcript.append_message(b"claim_prod_right", fr_bytes(curve, cr))
        assert len(rands) == len(r)
        eq = 1
        for rv, ra in zip(r, rands):
            eq = eq * ((rv * ra + (1 - rv) * (1 - ra)) % p) % p
        claim_expected = sum(
            co * (cl * cr % p * eq % p) % p
            for co, cl, cr in zip(coeffs, claim_prod_left, claim_prod_right)
        ) % p
        if i == layer_num - 1:
            dr, dc, dv = proof.claim_dotp
            for j in range(len(dr)):
                transcript.append_message(b"claim_dotp_row", fr_bytes(curve, dr[j]))
                transcript.append_message(b"claim_dotp_col", fr_bytes(curve, dc[j]))
                transcript.append_message(b"claim_dotp_val", fr_bytes(curve, dv[j]))
                claim_expected = (
                    claim_expected
                    + coeffs[len(claim_prod_left) + j] * dr[j] % p * dc[j] % p * dv[j]
                ) % p
        if claim_expected != claim_final % p:
            raise ValueError("product circuit layer claim mismatch")
        r_layer = challenge_fr(curve, transcript, b"challenge_r_layer")
        claims_to_verify = [
            (cl + r_layer * ((cr - cl) % p)) % p
            for cl, cr in zip(claim_prod_left, claim_prod_right)
        ]
        if i == layer_num - 1:
            dr, dc, dv = proof.claim_dotp
            for j in range(len(dr) // 2):
                claims_to_verify_dotp.append(
                    (dr[2 * j] + r_layer * ((dr[2 * j + 1] - dr[2 * j]) % p)) % p
                )
                claims_to_verify_dotp.append(
                    (dc[2 * j] + r_layer * ((dc[2 * j + 1] - dc[2 * j]) % p)) % p
                )
                claims_to_verify_dotp.append(
                    (dv[2 * j] + r_layer * ((dv[2 * j + 1] - dv[2 * j]) % p)) % p
                )
        num_rounds += 1
        rands = [r_layer] + r
    return claims_to_verify, claims_to_verify_dotp, rands


def product_layer_verify(curve, proof: ProductLayerProof, n, m, evals, transcript):
    """verify.rs:619-715."""
    p = curve.fr.modulus
    transcript.append_message(b"protocol-name", b"Sparse polynomial product layer proof")
    row_init, row_read_list, row_write_list, row_audit = proof.eval_row
    col_init, col_read_list, col_write_list, col_audit = proof.eval_col
    eval_dotp_left_list, eval_dotp_right_list = proof.eval_dotp

    def grand(vals):
        acc = 1
        for v in vals:
            acc = acc * v % p
        return acc

    if row_init * grand(row_write_list) % p != grand(row_read_list) * row_audit % p:
        raise ValueError("row memory product identity fails")
    transcript.append_message(b"claim_row_eval_init", fr_bytes(curve, row_init))
    transcript.append_message(b"claim_row_eval_read", b"".join(fr_bytes(curve, v) for v in row_read_list))
    transcript.append_message(b"claim_row_eval_write", b"".join(fr_bytes(curve, v) for v in row_write_list))
    transcript.append_message(b"claim_row_eval_audit", fr_bytes(curve, row_audit))
    if col_init * grand(col_write_list) % p != grand(col_read_list) * col_audit % p:
        raise ValueError("col memory product identity fails")
    transcript.append_message(b"claim_col_eval_init", fr_bytes(curve, col_init))
    transcript.append_message(b"claim_col_eval_read", b"".join(fr_bytes(curve, v) for v in col_read_list))
    transcript.append_message(b"claim_col_eval_write", b"".join(fr_bytes(curve, v) for v in col_write_list))
    transcript.append_message(b"claim_col_eval_audit", fr_bytes(curve, col_audit))

    claims_dotp_circuit = []
    for ev_l, ev_r, ev in zip(eval_dotp_left_list, eval_dotp_right_list, evals):
        if (ev_l + ev_r) % p != ev % p:
            raise ValueError("dot-product split does not add to matrix eval")
        transcript.append_message(b"claim_eval_dotp_left", fr_bytes(curve, ev_l))
        transcript.append_message(b"claim_eval_dotp_right", fr_bytes(curve, ev_r))
        claims_dotp_circuit.extend([ev_l, ev_r])

    claims_prod_circuit = (
        list(row_read_list) + list(row_write_list)
        + list(col_read_list) + list(col_write_list)
    )
    claims_ops, claims_ops_dotp, ops_rands = product_circuit_eval_verify(
        curve, proof.proof_ops, claims_prod_circuit, claims_dotp_circuit, n, transcript
    )
    claims_mem, _, mem_rands = product_circuit_eval_verify(
        curve, proof.proof_memory,
        [row_init, row_audit, col_init, col_audit], [], m, transcript,
    )
    return claims_ops, claims_ops_dotp, ops_rands, claims_mem, mem_rands


def behind_verify_for_timestamp(
    curve, mem_rands, claims, r, eval_ops_val, eval_addr_ops_list,
    eval_read_ts_list, eval_audit_ts_val, gamma,
):
    """verify.rs:1030-1083 — check hash claims against direct evaluations."""
    p = curve.fr.modulus
    gamma1, gamma2 = gamma
    claim_init, claim_read_list, claim_write_list, claim_audit = claims
    g1sq = gamma1 * gamma1 % p
    eval_init_addr = sum(
        mem_rands[i] * pow(2, len(mem_rands) - i - 1, p) % p
        for i in range(len(mem_rands))
    ) % p
    eval_init_val = eval_eq_x_y(r, mem_rands, p)
    if claim_init % p != (eval_init_addr * g1sq + eval_init_val * gamma1 - gamma2) % p:
        raise ValueError("init hash claim mismatch")
    for i in range(len(eval_addr_ops_list)):
        h_read = (
            eval_addr_ops_list[i] * g1sq
            + eval_ops_val[i] * gamma1
            + eval_read_ts_list[i]
            - gamma2
        ) % p
        if claim_read_list[i] % p != h_read:
            raise ValueError("read hash claim mismatch")
        h_write = (h_read + 1) % p
        if claim_write_list[i] % p != h_write:
            raise ValueError("write hash claim mismatch")
    h_audit = (
        eval_init_addr * g1sq + eval_init_val * gamma1 + eval_audit_ts_val - gamma2
    ) % p
    if claim_audit % p != h_audit:
        raise ValueError("audit hash claim mismatch")
    return True


def hash_layer_verify(
    curve, params: R1CSEvalsParameters, proof: HashLayerProof, rx, ry,
    ops_rands, mem_rands, gamma, claims_row, claims_col, claims_dotp,
    encode_commit: EncodeCommit, derefs_commit, transcript: Transcript, device="cuda",
):
    """verify.rs:843-1028."""
    p = curve.fr.modulus
    transcript.append_message(b"protocol-name", b"Sparse polynomial hash layer proof")
    assert len(claims_dotp) == 9
    eval_row_ops_val, eval_col_ops_val = proof.evals_derefs
    assert len(eval_row_ops_val) == len(eval_col_ops_val) == 3
    evals = list(eval_row_ops_val) + list(eval_col_ops_val)
    evals += [0] * (_next_pow2(len(evals)) - len(evals))
    transcript.append_message(b"protocol-name", b"Derefs evaluation proof")
    transcript.append_message(b"evals_ops_val", b"".join(fr_bytes(curve, v) for v in evals))
    cs, claim_eval = _combine_n_to_one(curve, evals, transcript, b"challenge_combine_n_to_one")
    rs = cs + list(ops_rands)
    transcript.append_message(b"joint_claim_eval", fr_bytes(curve, claim_eval))
    claim_commit = poly_commit_vec(
        curve, params.derefs_params.gen_1.generators, [claim_eval],
        params.derefs_params.gen_1.h, 0, device=device,
    )
    if not inner_product_verify(
        curve, params.derefs_params, rs, derefs_commit, claim_commit,
        proof.proof_derefs, transcript, device=device,
    ):
        raise ValueError("derefs opening fails")
    eval_val_list = proof.evals_val
    for i in range(3):
        if (
            claims_dotp[i * 3] % p != eval_row_ops_val[i] % p
            or claims_dotp[i * 3 + 1] % p != eval_col_ops_val[i] % p
            or claims_dotp[i * 3 + 2] % p != eval_val_list[i] % p
        ):
            raise ValueError("dotp claims mismatch derefs/val evals")

    row_eval_addr, row_eval_read, row_eval_audit = proof.evals_row
    col_eval_addr, col_eval_read, col_eval_audit = proof.evals_col
    evals_ops = (
        list(row_eval_addr) + list(row_eval_read)
        + list(col_eval_addr) + list(col_eval_read) + list(eval_val_list)
    )
    evals_ops += [0] * (_next_pow2(len(evals_ops)) - len(evals_ops))
    transcript.append_message(b"claim_evals_ops", b"".join(fr_bytes(curve, v) for v in evals_ops))
    cs_ops, claim_eval_ops = _combine_n_to_one(
        curve, evals_ops, transcript, b"challenge_combine_n_to_one"
    )
    rs_ops = cs_ops + list(ops_rands)
    transcript.append_message(b"joint_claim_eval_ops", fr_bytes(curve, claim_eval_ops))
    claim_commit = poly_commit_vec(
        curve, params.ops_params.gen_1.generators, [claim_eval_ops],
        params.ops_params.gen_1.h, 0, device=device,
    )
    if not inner_product_verify(
        curve, params.ops_params, rs_ops, encode_commit.ops_commit, claim_commit,
        proof.proof_ops, transcript, device=device,
    ):
        raise ValueError("ops opening fails")

    evals_mem = [row_eval_audit, col_eval_audit]
    transcript.append_message(b"claim_evals_mem", b"".join(fr_bytes(curve, v) for v in evals_mem))
    cs_mem, claim_eval_mem = _combine_n_to_one(
        curve, evals_mem, transcript, b"challenge_combine_two_to_one"
    )
    rs_mem = cs_mem + list(mem_rands)
    transcript.append_message(b"joint_claim_eval_mem", fr_bytes(curve, claim_eval_mem))
    claim_commit = poly_commit_vec(
        curve, params.mem_params.gen_1.generators, [claim_eval_mem],
        params.mem_params.gen_1.h, 0, device=device,
    )
    if not inner_product_verify(
        curve, params.mem_params, rs_mem, encode_commit.mem_commit, claim_commit,
        proof.proof_mem, transcript, device=device,
    ):
        raise ValueError("mem opening fails")

    behind_verify_for_timestamp(
        curve, mem_rands, claims_row, rx, eval_row_ops_val,
        row_eval_addr, row_eval_read, row_eval_audit, gamma,
    )
    behind_verify_for_timestamp(
        curve, mem_rands, claims_col, ry, eval_col_ops_val,
        col_eval_addr, col_eval_read, col_eval_audit, gamma,
    )
    return True


def sparse_poly_eval_verify(
    curve, params: R1CSEvalsParameters, proof: R1CSEvalsProof,
    encode_commit: EncodeCommit, rx, ry, evals, transcript: Transcript, device="cuda",
):
    """verify.rs:538-617."""
    transcript.append_message(b"protocol-name", b"sparse polynomial evaluation proof")
    rx_ext, ry_ext = equalize_length(rx, ry)
    assert (1 << len(rx_ext)) == encode_commit.m
    transcript.append_message(
        b"comm_poly_row_col_ops_val",
        b"".join(point_bytes(curve, c) for c in proof.derefs_commit),
    )
    gamma = (
        challenge_fr(curve, transcript, b"challenge_gamma_hash"),
        challenge_fr(curve, transcript, b"challenge_gamma_hash"),
    )
    claims_ops, claims_ops_dotp, ops_rands, claims_mem, mem_rands = product_layer_verify(
        curve, proof.prod_layer_proof, encode_commit.n, encode_commit.m,
        list(evals), transcript,
    )
    assert len(claims_mem) == 4 and len(claims_ops) == 12 and len(claims_ops_dotp) == 9
    hash_layer_verify(
        curve, params, proof.hash_layer_proof, rx_ext, ry_ext,
        ops_rands, mem_rands, gamma,
        (claims_mem[0], claims_ops[0:3], claims_ops[3:6], claims_mem[1]),
        (claims_mem[2], claims_ops[6:9], claims_ops[9:12], claims_mem[3]),
        claims_ops_dotp,
        encode_commit, proof.derefs_commit, transcript, device=device,
    )
    return True


def verify_snark_proof(
    curve: PairingCurve,
    params: SnarkParameters,
    r1cs: R1CSInstance,
    inputs: list[int],
    proof: SNARKProof,
    encode_commit: EncodeCommit,
    r1cs_hash: int,
    params_hash: int,
    encode_hash: int, device="cuda",
) -> bool:
    """verify.rs:54-101."""
    transcript = Transcript(b"Spartan SNARK proof")
    transcript.append_message(b"r1cs_hash", fr_bytes(curve, r1cs_hash))
    transcript.append_message(b"params_hash", fr_bytes(curve, params_hash))
    transcript.append_message(b"encode_hash", fr_bytes(curve, encode_hash))
    ok, rx, ry = r1cs_satisfied_verify(
        curve, params.r1cs_satisfied_params, r1cs, inputs,
        proof.r1cs_satisfied_proof, proof.matrix_evals, transcript, device=device,
    )
    if not ok:
        return False
    eval_a, eval_b, eval_c = proof.matrix_evals
    transcript.append_message(b"Ar_claim", fr_bytes(curve, eval_a))
    transcript.append_message(b"Br_claim", fr_bytes(curve, eval_b))
    transcript.append_message(b"Cr_claim", fr_bytes(curve, eval_c))
    transcript.append_u64(b"n", encode_commit.n)
    transcript.append_u64(b"m", encode_commit.m)
    transcript.append_message(
        b"encode_mem_commit", b"".join(point_bytes(curve, c) for c in encode_commit.mem_commit)
    )
    transcript.append_message(
        b"encode_ops_commit", b"".join(point_bytes(curve, c) for c in encode_commit.ops_commit)
    )
    try:
        sparse_poly_eval_verify(
            curve, params.r1cs_eval_params, proof.r1cs_evals_proof, encode_commit,
            rx, ry, proof.matrix_evals, transcript, device=device,
        )
    except (ValueError, AssertionError):
        return False
    return True


# ---------------- top-level API (lib.rs snark module) ----------------
@dataclass
class SnarkSetup:
    params: SnarkParameters
    r1cs: R1CSInstance
    encode: EncodeMemory
    encode_commit: EncodeCommit


def generate_random_parameters(
    curve: PairingCurve, circuit: ConstraintSynthesizer, rng: random.Random, device="cuda",
    timings: dict | None = None,
) -> SnarkSetup:
    """`timings`, when given, receives the seconds of the stages: r1cs,
    params (the generators) and encode_commit (SPARK's encoding
    and its two commitments)."""
    st = Stages(timings, device)
    r1cs = generate_r1cs(curve, circuit)
    st.mark("r1cs")
    params = generate_setup_snark_parameters(
        curve, rng, r1cs.num_aux, r1cs.num_inputs, r1cs.num_constraints, device
    )
    st.mark("params")
    encode_mem, encode_commit = encode(params, r1cs, rng, device=device)
    st.mark("encode_commit")
    return SnarkSetup(params, r1cs, encode_mem, encode_commit)


def encode_to_hash(curve: PairingCurve, encode_commit: EncodeCommit) -> int:
    t = Transcript(b"Spartan snark encode")
    t.append_u64(b"n", encode_commit.n)
    t.append_u64(b"m", encode_commit.m)
    for c in encode_commit.ops_commit:
        t.append_message(b"ops_commit", point_bytes(curve, c))
    for c in encode_commit.mem_commit:
        t.append_message(b"mem_commit", point_bytes(curve, c))
    return challenge_fr(curve, t, b"challenge_nextround")


def snark_params_to_hash(curve: PairingCurve, params: SnarkParameters) -> int:
    """Binds the satisfiability sub-parameters (the eval params enter the
    transcript via the encode hash and commitments)."""
    from .nizk import NizkParameters, params_to_hash

    return params_to_hash(curve, NizkParameters(params.r1cs_satisfied_params))
