# Copied from ckb_zkp_tpu/schemes/libra/circuit.py (host ints only): the port keeps its own copy.
"""Layered arithmetic circuits (ops: 0=add, 1=mul, 2=dummy, 3=input).

Parity: ckb-zkp libra/src/circuit.rs:15-206 — including the input
layer packing of [aux | zeros | inputs | zeros] (circuit.rs:147-155) and the
circuit hash transcript.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...host.pairing import PairingCurve
from ...transcript import Transcript
from ..spartan.common import challenge_fr


@dataclass
class Gate:
    g: int
    op: int
    left_node: int
    right_node: int


class Layer:
    def __init__(self, gates: list[Gate], bit_size: int):
        self.gates = gates
        self.gates_count = len(gates)
        self.bit_size = bit_size

    @classmethod
    def input_new(cls, num_input: int, num_aux: int) -> "Layer":
        m = max(num_aux, num_input)
        m = 1 if m == 0 else 1 << (m - 1).bit_length()
        gates_num = m * 2
        bit_size = gates_num.bit_length() - 1
        return cls([Gate(g, 3, 0, 0) for g in range(gates_num)], bit_size)

    @classmethod
    def mid_layer_new(cls, gates_raw, next_layer_gates_count: int) -> "Layer":
        gates = []
        for g, (op, left, right) in enumerate(gates_raw):
            assert op in (0, 1), "illegal operator"
            assert left < next_layer_gates_count and right < next_layer_gates_count
            gates.append(Gate(g, op, left, right))
        n = len(gates)
        np2 = 1 if n == 0 else 1 << (n - 1).bit_length()
        return cls(gates, np2.bit_length() - 1)


class Circuit:
    def __init__(self, num_inputs: int, num_aux: int, layers_raw):
        self.layers: list[Layer] = [Layer.input_new(num_inputs, num_aux)]
        cnt = self.layers[0].gates_count
        for raw in layers_raw:
            layer = Layer.mid_layer_new(raw, cnt)
            cnt = layer.gates_count
            self.layers.append(layer)
        self.depth = len(self.layers)

    def evaluate(self, p: int, inputs: list[int], aux: list[int]) -> list[list[int]]:
        evals = []
        prev: list[int] = []
        for d, layer in enumerate(self.layers):
            if d == 0:
                input_size = 1 << (layer.bit_size - 1)
                assert input_size >= len(inputs) and input_size >= len(aux)
                # reference layout quirk preserved (circuit.rs:150-154)
                values = list(aux)
                values += [0] * (input_size - len(inputs))
                values += list(inputs)
                values += [0] * (input_size - len(aux))
            else:
                values = []
                for gate in layer.gates:
                    l, r = prev[gate.left_node], prev[gate.right_node]
                    values.append((l + r) % p if gate.op == 0 else l * r % p)
            prev = values
            evals.append(values)
        return evals

    def circuit_to_hash(self, curve: PairingCurve) -> int:
        t = Transcript(b"libra - circuit_to_hash")
        t.append_u64(b"circuit_depth", self.depth)
        for layer in self.layers:
            t.append_u64(b"circuit_gate_count", layer.gates_count)
            t.append_u64(b"circuit_bit_size", layer.bit_size)
            for g in layer.gates:
                t.append_u64(b"circuit_gate_g", g.g)
                t.append_u64(b"circuit_gate_op", g.op)
                t.append_u64(b"circuit_gate_left_node", g.left_node)
                t.append_u64(b"circuit_gate_right_node", g.right_node)
        return challenge_fr(curve, t, b"challenge_nextround")
