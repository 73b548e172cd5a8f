# Copied from ckb_zkp_tpu/schemes/plonk/composer.py (host code only): the port keeps its own copy.
"""PLONK composer: 4-wire gates + copy-constraint permutation tracking.

Parity: ckb-zkp plonk/src/composer/{mod.rs, arithmetic.rs,
permutation.rs, synthesize.rs}.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Variable:
    index: int


class Permutation:
    """Tracks which (wire, gate) slots each variable occupies."""

    def __init__(self):
        self.variable_map: dict[Variable, list[tuple[int, int]]] = {}

    def alloc(self) -> Variable:
        var = Variable(len(self.variable_map))
        self.variable_map[var] = []
        return var

    def insert_gate(self, w0, w1, w2, w3, index: int):
        for wire, var in enumerate((w0, w1, w2, w3)):
            self.variable_map[var].append((wire, index))

    def compute_wire_permutation(self, n: int):
        perms = [[(w, i) for i in range(n)] for w in range(4)]
        for wires in self.variable_map.values():
            if len(wires) <= 1:
                continue
            for curr, curr_wire in enumerate(wires):
                nxt = len(wires) - 1 if curr == 0 else curr - 1
                w, i = curr_wire
                perms[w][i] = wires[nxt]
        return perms

    def compute_sigmas(self, roots: list[int], ks: list[int], p: int):
        n = len(roots)
        perms = self.compute_wire_permutation(n)
        return [
            [roots[i] * ks[w] % p for (w, i) in perm] for perm in perms
        ]


class Composer:
    def __init__(self, p: int):
        self.p = p
        self.n = 0
        self.q = {k: [] for k in ("q_0", "q_1", "q_2", "q_3", "q_m", "q_c", "q_arith")}
        self.pi: list[int] = []
        self.wires = {k: [] for k in ("w_0", "w_1", "w_2", "w_3")}
        self.permutation = Permutation()
        self.assignment: dict[Variable, int] = {}
        self.null_var = self.alloc_and_assign(0)

    def size(self) -> int:
        return self.n

    def alloc_and_assign(self, value: int) -> Variable:
        var = self.permutation.alloc()
        self.assignment[var] = value % self.p
        return var

    def create_poly_gate(self, l, r, o, aux, q_m: int, q_c: int, pi: int):
        p = self.p
        if aux is None:
            aux = (self.null_var, 0)
        index = self.n
        self.permutation.insert_gate(aux[0], l[0], r[0], o[0], index)
        self.wires["w_0"].append(aux[0])
        self.wires["w_1"].append(l[0])
        self.wires["w_2"].append(r[0])
        self.wires["w_3"].append(o[0])
        self.pi.append(pi % p)
        self.q["q_0"].append(aux[1] % p)
        self.q["q_1"].append(l[1] % p)
        self.q["q_2"].append(r[1] % p)
        self.q["q_3"].append(o[1] % p)
        self.q["q_m"].append(q_m % p)
        self.q["q_c"].append(q_c % p)
        self.q["q_arith"].append(1)
        self.n += 1

    def constrain_to_constant(self, var: Variable, value: int, pi: int = 0):
        self.create_poly_gate((var, 1), (var, 0), (var, 0), None, 0, -value, -pi)

    def assert_equal(self, l: Variable, r: Variable):
        self.create_poly_gate((l, 1), (r, -1), (self.null_var, 0), None, 0, 0, 0)

    def create_add_gate(self, l, r, o: Variable, aux=None, q_c: int = 0, pi: int = 0):
        self.create_poly_gate(l, r, (o, -1), aux, 0, q_c, pi)

    def create_mul_gate(self, l: Variable, r: Variable, o: Variable, aux=None,
                        q_m: int = 1, q_c: int = 0, pi: int = 0):
        self.create_poly_gate((l, 0), (r, 0), (o, -1), aux, q_m, q_c, pi)

    def public_inputs(self) -> list[int]:
        return list(self.pi)

    def compose(self, roots: list[int], ks: list[int]):
        """Selectors + sigmas padded to the domain size."""
        p = self.p
        n = len(roots)
        sigmas = self.permutation.compute_sigmas(roots, ks, p)
        diff = n - self.n
        sel = {k: v + [0] * diff for k, v in self.q.items()}
        return sel, sigmas

    def synthesize(self, n: int):
        diff = n - self.n
        out = {}
        for k, vars_ in self.wires.items():
            out[k] = [self.assignment[v] for v in vars_] + [0] * diff
        return out
