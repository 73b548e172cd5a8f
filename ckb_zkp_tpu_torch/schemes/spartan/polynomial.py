# Copied from ckb_zkp_tpu/schemes/spartan/polynomial.py (host ints only): the port keeps its own copy.
"""Multilinear-extension utilities.

Parity: ckb-zkp spartan/src/polynomial.rs:8-147. Host ints for the
protocol layer; the same recurrences exist device-side in ops for the
prover hot path at benchmark scale (sumcheck table halving).
"""

from __future__ import annotations


def eval_eq(rx: list[int], p: int) -> list[int]:
    """Table of eq(x, rx) over x in {0,1}^len (bit-reversed build order)."""
    rlen = len(rx)
    evals = [1] * (1 << rlen)
    size = 1
    for i in range(rlen):
        scalar = rx[rlen - i - 1]
        for j in range(size):
            evals[size + j] = scalar * evals[j] % p
            evals[j] = (1 - scalar) * evals[j] % p
        size *= 2
    return evals


def eval_eq_x_y(rx: list[int], ry: list[int], p: int) -> int:
    assert len(rx) == len(ry)
    out = 1
    for a, b in zip(rx, ry):
        out = out * ((1 - a) * (1 - b) + a * b) % p
    return out


def sparse_evaluate_value(values: list[int], r: list[int], p: int) -> int:
    num_bits = len(r)
    out = 0
    for i, v in enumerate(values):
        if v == 0:
            continue
        eq = 1
        for j in range(num_bits):
            bit = (i >> (num_bits - j - 1)) & 1
            eq = eq * (r[j] if bit else (1 - r[j]) % p) % p
        out = (out + eq * v) % p
    return out


def evaluate_mle(matrix, rx: list[int], ry: list[int], p: int) -> int:
    """MLE of a sparse matrix at (rx, ry); columns use spartan's z-layout
    (aux at i, inputs at i + half)."""
    evals_rx = eval_eq(rx, p)
    evals_ry = eval_eq(ry, p)
    half = len(evals_ry) // 2
    acc = 0
    for row, entries in enumerate(matrix):
        for val, kind, idx in entries:
            col = idx if kind == "A" else idx + half
            acc = (acc + evals_ry[col] * evals_rx[row] % p * val) % p
    return acc


def evaluate_matrix_vec(matrix, z: list[int], p: int) -> list[int]:
    """[M @ z] rows with spartan z-layout."""
    half = len(z) // 2
    ms = [0] * len(matrix)
    for row, entries in enumerate(matrix):
        for val, kind, idx in entries:
            col = idx if kind == "A" else idx + half
            ms[row] = (ms[row] + val * z[col]) % p
    return ms


def evaluate_matrix_vec_col(matrix, coeffs: list[int], num_rows: int, p: int) -> list[int]:
    """[M^T @ coeffs] over columns with spartan z-layout."""
    half = num_rows // 2
    ms = [0] * num_rows
    for row, entries in enumerate(matrix):
        for val, kind, idx in entries:
            col = idx if kind == "A" else idx + half
            ms[col] = (ms[col] + val * coeffs[row]) % p
    return ms


def combine_with_n(values: list[int], r: int, p: int) -> list[int]:
    half = len(values) // 2
    return [(r * values[i + half] + (1 - r) * values[i]) % p for i in range(half)]


def combine_with_r(values: list[int], r: int, p: int) -> list[int]:
    """Top-variable binding (halves the table)."""
    return combine_with_n(values, r, p)


def bound_poly_var_bot(values: list[int], r: int, p: int) -> list[int]:
    half = len(values) // 2
    return [
        (r * values[2 * i + 1] + (1 - r) * values[2 * i]) % p for i in range(half)
    ]
