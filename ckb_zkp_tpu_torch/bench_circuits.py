# Copied from ckb_zkp_tpu/bench_circuits.py (host ints and numpy only): the port keeps its own copy.
"""Vectorized benchmark circuit construction (no per-constraint Python).

Builds the R1csShape for N independent `x_i * y_i = z_i` constraints directly
with numpy — the benchmark-scale analogue of the reference's Mini circuit
(cli/src/circuits/mini.rs) without front-end overhead at 2^20 constraints.
"""

from __future__ import annotations

import numpy as np

from .r1cs.system import CooMatrix, R1csShape


def square_chain_shape(n: int, p: int, seed: int = 1, with_witness: bool = True):
    """N constraints: x_i * x_i = x_{i+1}; public output x_n.

    One aux variable per constraint (n + 2 total columns), so query/MSM
    lengths track the constraint count — the shape the reference's own
    prover cost model assumes (one variable per constraint). The witness is
    a full-width squaring chain, exercising real field arithmetic.
    """
    rng = np.random.default_rng(seed)
    num_inputs = 2  # [ONE, x_n]
    rows = np.arange(n, dtype=np.int32)
    ab_cols = 2 + rows  # x_i -> aux col 2 + i
    c_cols = np.concatenate([2 + 1 + rows[: n - 1], [1]]).astype(np.int32)
    a = CooMatrix(rows, ab_cols.astype(np.int32), [1] * n)
    b = CooMatrix(rows, ab_cols.astype(np.int32), [1] * n)
    c = CooMatrix(rows, c_cols, [1] * n)
    inputs = aux = None
    if with_witness:
        x = int(rng.integers(2, 1 << 62))
        chain = []
        for _ in range(n):
            chain.append(x)
            x = x * x % p
        inputs = [1, x]  # x == x_n
        aux = chain
    return R1csShape(
        num_inputs=num_inputs,
        num_aux=n,
        num_constraints=n,
        a=a,
        b=b,
        c=c,
        p=p,
        input_assignment=inputs,
        aux_assignment=aux,
    )


def product_circuit_shape(n: int, p: int, seed: int = 1, with_witness: bool = True):
    """N constraints: x_i * y_i = z_i; one public input (sum marker z_0)."""
    rng = np.random.default_rng(seed)
    # variables: inputs [ONE, out0]; aux: x_0..x_{n-1}, y_0..y_{n-1}, z_1.. etc
    # layout: col 0 = ONE, col 1 = public z_0; aux: x_i -> 2+i, y_i -> 2+n+i,
    # z_i (i>=1) -> 2+2n+(i-1)
    num_inputs = 2
    xs = rng.integers(1, 1 << 62, n, dtype=np.uint64).astype(object)
    ys = rng.integers(1, 1 << 62, n, dtype=np.uint64).astype(object)
    zs = [(int(a) * int(b)) % p for a, b in zip(xs, ys)]
    rows = np.arange(n, dtype=np.int32)
    a_cols = 2 + rows
    b_cols = 2 + n + rows
    c_cols = np.concatenate([[1], 2 + 2 * n + np.arange(n - 1, dtype=np.int32)])
    a = CooMatrix(rows, a_cols.astype(np.int32), [1] * n)
    b = CooMatrix(rows, b_cols.astype(np.int32), [1] * n)
    c = CooMatrix(rows, c_cols.astype(np.int32), [1] * n)
    inputs = [1, zs[0]] if with_witness else None
    aux = (
        [int(v) for v in xs] + [int(v) for v in ys] + [int(v) for v in zs[1:]]
        if with_witness
        else None
    )
    return R1csShape(
        num_inputs=num_inputs,
        num_aux=3 * n - 1,
        num_constraints=n,
        a=a,
        b=b,
        c=c,
        p=p,
        input_assignment=inputs,
        aux_assignment=aux,
    )
