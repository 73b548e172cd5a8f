# Copied from ckb_zkp_tpu/host/poly.py (host ints only): the port keeps its own copy.
"""Small host-side dense polynomials over Fr (Python ints).

For protocol-layer polynomial algebra whose degree is tiny (e.g. aSVC's
A_I(x) over the opened positions, Marlin verifier combinations). Bulk
polynomial work belongs in ops/poly.py (device NTT).
"""

from __future__ import annotations


def trim(a: list[int]) -> list[int]:
    n = len(a)
    while n > 1 and a[n - 1] == 0:
        n -= 1
    return a[:n]


def add(a: list[int], b: list[int], p: int) -> list[int]:
    n = max(len(a), len(b))
    return trim([( (a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0) ) % p for i in range(n)])


def sub(a: list[int], b: list[int], p: int) -> list[int]:
    n = max(len(a), len(b))
    return trim([( (a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0) ) % p for i in range(n)])


def scale(a: list[int], c: int, p: int) -> list[int]:
    return [x * c % p for x in a]


def mul(a: list[int], b: list[int], p: int) -> list[int]:
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % p
    return trim(out)


def divmod_poly(a: list[int], b: list[int], p: int) -> tuple[list[int], list[int]]:
    """Long division a = q*b + r."""
    a = trim(list(a))
    b = trim(list(b))
    if b == [0]:
        raise ZeroDivisionError
    if len(a) < len(b):
        return [0], a
    q = [0] * (len(a) - len(b) + 1)
    rem = list(a)
    binv = pow(b[-1], -1, p)
    for i in range(len(q) - 1, -1, -1):
        c = rem[i + len(b) - 1] * binv % p
        q[i] = c
        if c:
            for j, bj in enumerate(b):
                rem[i + j] = (rem[i + j] - c * bj) % p
    return trim(q), trim(rem)


def evaluate(a: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(a):
        acc = (acc * x + c) % p
    return acc


def from_roots(roots: list[int], p: int) -> list[int]:
    """prod (x - r_i)"""
    out = [1]
    for r in roots:
        out = mul(out, [(-r) % p, 1], p)
    return out


def lagrange_interpolate(xs: list[int], ys: list[int], p: int) -> list[int]:
    out = [0]
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        num = [1]
        den = 1
        for j, xj in enumerate(xs):
            if j != i:
                num = mul(num, [(-xj) % p, 1], p)
                den = den * (xi - xj) % p
        out = add(out, scale(num, yi * pow(den, -1, p) % p, p), p)
    return out
