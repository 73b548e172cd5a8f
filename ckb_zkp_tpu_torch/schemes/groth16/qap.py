"""R1CS -> QAP reduction shared by the port's setup and prover.

Port of the reference's `schemes/groth16/qap.py`: `domain_size_for`
(`:23`), `QapMatrices` with `host_mode` (`:59-100`), the host-int instance
map `evaluations_at_host` (`:143-170`), the device instance map
`evaluations_at` (`:289-295`: Lagrange coefficients and three transpose
products) and the witness map (`:172-215`, with the `out_len` padding of
`witness_map_fused`, `:265-287`). The domain has size
next_pow2(num_constraints + num_inputs); rows [nc, nc + ni) of A carry the
input-binding identity entries, exactly as the reference. One device COO
per matrix and one domain serve the setup's transpose products and the
prover's products.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.field import device_field
from ...ops.ntt import get_domain
from ...ops.sparse import DeviceCoo, aligned_cols


def domain_size_for(shape) -> int:
    need = shape.num_constraints + shape.num_inputs
    n = 1
    while n < need:
        n *= 2
    return n


def qap_matrices(shape, spec, device="cuda") -> "QapMatrices":
    """The shape's QapMatrices on `device`, built once and kept on the
    shape (as the reference keeps its witness limbs, `r1cs/system.py:217`),
    so the setup and repeated proves of one circuit share its device
    matrices and domain, and they leave with the shape."""
    cache = getattr(shape, "_torch_qap_cache", None)
    if cache is None:
        cache = shape._torch_qap_cache = {}
    key = (spec, str(torch.device(device)))
    q = cache.get(key)
    if q is None:
        q = cache[key] = QapMatrices(shape, spec, device)
    return q


class QapMatrices:
    """COO matrices for A (input-augmented), B, C over the QAP domain.

    host_mode=True keeps the host COO arrays only (the host-int instance
    map); otherwise the device matrices and the domain are built on first
    use (`device_parts`)."""

    def __init__(self, shape, spec, device="cuda", host_mode: bool = False):
        self.df = device_field(spec, device)
        self.spec = spec
        self.host_mode = host_mode
        self.m = domain_size_for(shape)
        nc, ni = shape.num_constraints, shape.num_inputs
        nv = shape.num_variables
        self.num_variables = nv
        self.num_cols_pad = aligned_cols(nv)
        a_rows = np.concatenate([shape.a.rows, np.arange(nc, nc + ni, dtype=np.int32)])
        a_cols = np.concatenate([shape.a.cols, np.arange(ni, dtype=np.int32)])
        a_coeffs = list(shape.a.coeffs) + [1] * ni
        self._host_coo = (
            (a_rows, a_cols, a_coeffs),
            (shape.b.rows, shape.b.cols, list(shape.b.coeffs)),
            (shape.c.rows, shape.c.cols, list(shape.c.coeffs)),
        )
        self._dev = None

    def device_parts(self):
        """((A, B, C) device COOs, domain), built on first use."""
        if self.host_mode:
            raise ValueError("a host-mode QapMatrices has no device matrices")
        if self._dev is None:
            coos = tuple(
                DeviceCoo(self.df, r, c, k, self.m, self.num_variables)
                for r, c, k in self._host_coo
            )
            self._dev = coos, get_domain(self.spec, self.m, self.df.device)
        return self._dev

    def evaluations_at(self, t: int, mark=None):
        """u_i(t), v_i(t), w_i(t) as (num_cols_pad, L) Montgomery limbs, on
        the device; the padding columns are zero. `mark`, when given, is
        called with "lagrange" and "rmatvec" as each stage ends."""
        (a, b, c), dom = self.device_parts()
        lag = dom.evaluate_all_lagrange_coefficients(t)
        if mark:
            mark("lagrange")
        out = tuple(mat.rmatvec_padded(lag) for mat in (a, b, c))
        if mark:
            mark("rmatvec")
        return out

    def evaluations_at_host(self, t: int):
        """u_i(t), v_i(t), w_i(t) as host ints (setup instance map)."""
        p = self.spec.modulus
        n = self.m
        omega = self.spec.root_of_unity(n)
        if pow(t, n, p) == 1:
            lag = [0] * n
            cur = 1
            for i in range(n):
                if cur == t % p:
                    lag[i] = 1
                cur = cur * omega % p
        else:
            zt_over_n = (pow(t, n, p) - 1) * pow(n, -1, p) % p
            lag, cur = [], 1
            for _ in range(n):
                lag.append(zt_over_n * cur % p * pow((t - cur) % p, -1, p) % p)
                cur = cur * omega % p
        nv = self.num_variables
        out = []
        for rows, cols, coeffs in self._host_coo:
            acc = [0] * nv
            for r, c, v in zip(rows.tolist(), cols.tolist(), coeffs):
                acc[c] = (acc[c] + v * lag[r]) % p
            out.append(acc)
        return tuple(out)

    def witness_map(self, z_can: torch.Tensor, out_len: int) -> torch.Tensor:
        """Canonical witness limbs (>= num_vars, L) -> canonical h (out_len, L).

        to_mont, three sparse matvecs, intt + coset_ntt of each, the
        pointwise quotient by the vanishing polynomial on the coset,
        coset_intt and from_mont (the reference's hot loop 1,
        r1cs_to_qap.rs:113-172). Rows from m - 1 up are zero."""
        df = self.df
        (a, b, c), dom = self.device_parts()
        z = df.to_mont(z_can)
        ea, eb, ec = (dom.coset_ntt(dom.intt(mat.matvec(z))) for mat in (a, b, c))
        q = dom.divide_by_vanishing_poly_on_coset(df.sub(df.mul(ea, eb), ec))
        h = df.from_mont(dom.coset_intt(q))
        if out_len > self.m:
            h = torch.cat([h, df.zeros((out_len - self.m,))], dim=0)
        return h[:out_len]
