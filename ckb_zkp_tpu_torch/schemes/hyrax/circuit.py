# Copied from ckb_zkp_tpu/schemes/hyrax/circuit.py (host ints only): the port keeps its own copy.
"""Hyrax layered circuits (parity: hyrax/src/circuit.rs).

Same gate model as Libra, but `evaluate` stores layers REVERSED:
evals[0] is the output layer and evals[depth-1] the input layer
(circuit.rs:115-163).
"""

from __future__ import annotations

from ...host.pairing import PairingCurve
from ...transcript import Transcript
from ..libra.circuit import Gate, Layer
from ..spartan.common import challenge_fr


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
        n = self.depth
        evals: list[list[int]] = [[] for _ in range(n)]
        prev: list[int] = []
        for d, layer in enumerate(self.layers):
            if d == 0:
                input_size = 1 << (layer.bit_size - 1)
                assert input_size >= len(inputs) and input_size >= len(aux)
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
            evals[n - d - 1] = values
        return evals

    def circuit_to_hash(self, curve: PairingCurve) -> int:
        t = Transcript(b"hyrax - circuit_to_hash")
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
