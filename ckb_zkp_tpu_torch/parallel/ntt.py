"""Sharded NTT: the four-step decomposition with all-to-all exchanges.

Port of the reference's `parallel/ntt.py` (`:1-210`). DFT_N for
N = N1 * N2 splits into column DFT_N1, a twiddle and row DFT_N2, with
transposes across the ranks between them. Layouts, each rank holding one
row block:

    natural x (N,) == M[n1, n2] row-major (n = n1*N2 + n2), sharded over n1
    fft_t(x)  -> B[k1, k2] sharded over k1 rows: the "transposed" spectrum,
                 X[k1 + N1*k2] = B[k1, k2]
    ifft_from_t(B) -> natural x, row-sharded (with the 1/N scaling)

Pointwise products do not care for the layout, so a product of
polynomials runs fft_t -> pointwise -> ifft_from_t without natural-order
spectra. `coset_eval` and `coset_interp` are the witness map's natural-
order coset transforms.

The reference runs each rank's part under `shard_map` and batches the row
and column transforms with `jax.vmap`; here each rank runs its part on its
own block, the transforms batched along a dim of `Domain.fft`. Every
product goes through K1, and outputs are canonical, so they equal the
single-device `Domain`'s bit for bit. The twiddle and coset blocks depend
on the rank only, so each is built once per domain.
"""

from __future__ import annotations

import torch

from ..host.field import FieldSpec
from ..ops.field import device_field
from ..ops.ntt import get_domain
from .mesh import Mesh, all_to_all_tiled


def get_sharded_domain(spec: FieldSpec, n: int, mesh: Mesh, device=None) -> "ShardedDomain":
    """The one ShardedDomain of size n for `mesh` on `device` (default: the
    mesh's), kept in `mesh.domains`: its twiddle blocks are built once, not
    per prove, and freed with the mesh."""
    key = (spec, n, str(torch.device(device or mesh.device)))
    dom = mesh.domains.get(key)
    if dom is None:
        dom = mesh.domains[key] = ShardedDomain(spec, n, mesh, key[2])
    return dom


class ShardedDomain:
    """Each public transform takes and returns this rank's (N / d, L) row
    block."""

    def __init__(self, spec: FieldSpec, n: int, mesh: Mesh, device="cuda"):
        self.spec = spec
        self.n = n
        self.mesh = mesh
        self.d = d = mesh.size
        logn = n.bit_length() - 1
        assert 1 << logn == n
        self.n1 = 1 << ((logn + 1) // 2)
        self.n2 = n // self.n1
        assert self.n1 % d == 0 and self.n2 % d == 0, "mesh must divide both NTT factor dims"
        self.df = device_field(spec, device)
        self.dom1 = get_domain(spec, self.n1, device)
        self.dom2 = get_domain(spec, self.n2, device)
        p = spec.modulus
        self.omega = spec.root_of_unity(n)
        self.omega_inv = pow(self.omega, -1, p)
        self.coset_g = spec.generator
        self.coset_g_inv = pow(self.coset_g, -1, p)
        self._blocks: dict = {}

    # ---- the rank's constant blocks, built on first use ----
    def _block(self, key, make):
        t = self._blocks.get(key)
        if t is None:
            t = self._blocks[key] = make()
        return t

    def _twiddle_block(self, base: int, k1_count: int, k1_off: int, n2_count: int,
                       n2_off: int):
        """T[i, j] = base^((k1_off+i) * (n2_off+j)), Montgomery form: the
        row c_j = base^(n2_off+j), its powers by doubling down the rows,
        times c_j^k1_off."""
        df = self.df
        col = self._pow_vec(base, n2_count, n2_off)
        T = df.ones((1, n2_count))
        while T.shape[0] < k1_count:
            T = torch.cat([T, df.mul(T, df.pow_fixed(col, T.shape[0]).unsqueeze(0))])
        return df.mul(T[:k1_count], df.pow_fixed(col, k1_off).unsqueeze(0))

    def _pow_vec(self, base: int, count: int, off: int):
        """[base^(off+i)]_{i<count}, Montgomery form."""
        df = self.df
        return df.mul(df.powers(base, count), df.const(pow(base, off, self.spec.modulus), (1,)))

    def _coset_scale_local(self, B, inverse: bool):
        """Multiply transposed-layout coefficients C[k1, k2] by
        g^(+-(k1 + n1*k2)): natural index k1 + n1*k2, rows this rank's k1."""
        df, n1d, n2 = self.df, self.n1 // self.d, self.n2

        def make():
            g = self.coset_g_inv if inverse else self.coset_g
            col = self._pow_vec(g, n1d, self.mesh.rank * n1d)  # g^k1
            row = self._pow_vec(pow(g, self.n1, self.spec.modulus), n2, 0)  # (g^n1)^k2
            return df.mul(col[:, None], row[None])

        scale = self._block(("coset", inverse), make)
        return df.mul(B.reshape(n1d, n2, df.L), scale).reshape(n1d * n2, df.L)

    def _col_twiddles(self, inverse: bool):
        """(n1, n2/d): the twiddles of the column-sharded stage."""
        n2d = self.n2 // self.d
        base = self.omega_inv if inverse else self.omega
        return self._block(("col", inverse), lambda: self._twiddle_block(
            base, self.n1, 0, n2d, self.mesh.rank * n2d))

    def _row_twiddles(self, inverse: bool):
        """(n1/d, n2): the twiddles of the row-sharded stage."""
        n1d = self.n1 // self.d
        base = self.omega_inv if inverse else self.omega
        return self._block(("row", inverse), lambda: self._twiddle_block(
            base, n1d, self.mesh.rank * n1d, self.n2, 0))

    def _a2a(self, x, split_dim: int, concat_dim: int):
        return all_to_all_tiled(x, split_dim, concat_dim, self.mesh)

    # ---- forward: natural row-sharded -> transposed spectrum row-sharded ----
    def fft_t(self, x):
        df, d, n1, n2 = self.df, self.d, self.n1, self.n2
        x = self._a2a(x.reshape(n1 // d, n2, df.L), 1, 0)  # to column shards (n1, n2/d)
        x = df.mul(self.dom1.fft(x, dim=0), self._col_twiddles(False))
        x = self._a2a(x, 0, 1)  # back to row shards (n1/d, n2)
        return self.dom2.fft(x, dim=1).reshape(n1 // d * n2, df.L)

    # ---- inverse: transposed spectrum row-sharded -> natural row-sharded ----
    def ifft_from_t(self, B):
        df, d, n1, n2 = self.df, self.d, self.n1, self.n2
        B = self.dom2.fft(B.reshape(n1 // d, n2, df.L), inverse=True, dim=1)  # 1/n2
        B = df.mul(B, self._row_twiddles(True))
        B = self.dom1.fft(self._a2a(B, 1, 0), inverse=True, dim=0)  # 1/n1
        return self._a2a(B, 0, 1).reshape(n1 // d * n2, df.L)

    # ---- inverse, natural -> transposed coefficients (with 1/N) ----
    def _ifft_t_local(self, x):
        df, d, n1, n2 = self.df, self.d, self.n1, self.n2
        x = self._a2a(x.reshape(n1 // d, n2, df.L), 1, 0)
        x = df.mul(self.dom1.fft(x, inverse=True, dim=0), self._col_twiddles(True))
        x = self._a2a(x, 0, 1)
        return self.dom2.fft(x, inverse=True, dim=1).reshape(n1 // d * n2, df.L)

    # ---- forward, transposed coefficients -> natural evaluations ----
    def _ntt_from_t_local(self, B):
        df, d, n1, n2 = self.df, self.d, self.n1, self.n2
        B = self.dom2.fft(B.reshape(n1 // d, n2, df.L), dim=1)
        B = df.mul(B, self._row_twiddles(False))
        B = self.dom1.fft(self._a2a(B, 1, 0), dim=0)
        return self._a2a(B, 0, 1).reshape(n1 // d * n2, df.L)

    def _from_t_local(self, B):
        """The transpose alone: transposed layout -> natural order."""
        df, d, n1, n2 = self.df, self.d, self.n1, self.n2
        B = self._a2a(B.reshape(n1 // d, n2, df.L), 1, 0)  # (n1, n2/d)
        return B.transpose(0, 1).reshape((n2 // d) * n1, df.L)  # rows k2, cols k1

    def coset_eval(self, x):
        """Natural evaluations on H -> natural evaluations on gH (the
        reference's coset_ntt(intt(x)), row-sharded)."""
        return self._ntt_from_t_local(self._coset_scale_local(self._ifft_t_local(x), False))

    def coset_interp(self, q):
        """Natural evaluations on gH -> natural coefficients (coset_intt)."""
        return self._from_t_local(self._coset_scale_local(self._ifft_t_local(q), True))
